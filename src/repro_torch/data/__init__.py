"""Deterministic, restartable data pipelines (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import PipelineConfig, batch_at, iterate  # noqa: F401
