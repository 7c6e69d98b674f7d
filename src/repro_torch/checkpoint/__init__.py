"""Program artifacts (counterpart of ``repro.checkpoint``)."""
