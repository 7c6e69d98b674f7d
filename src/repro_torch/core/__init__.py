"""Core of the port: quantizers, the PCM model, the analog layer and the
program/execute engine (counterparts of ``repro.core``)."""
