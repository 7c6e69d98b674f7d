"""Config registry of the port (counterpart of ``repro.configs``).

``get(arch_id)`` returns the full-size ModelConfig, ``get_smoke(arch_id)``
the reduced same-family config of the CPU tests. This slice registers the
dense LM it serves; the other architectures follow with their families.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

# arch id -> module name
LM_ARCHS = {
    "tinyllama-1.1b": "tinyllama_1p1b",
}


def get(arch_id: str) -> ModelConfig:
    if arch_id not in LM_ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(LM_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{LM_ARCHS[arch_id]}").config()


def get_smoke(arch_id: str) -> ModelConfig:
    return get(arch_id).smoke()
