"""Config registry of the port (counterpart of ``repro.configs``).

``get(arch_id)`` returns the full-size config -- a ModelConfig for an LM,
a CNNConfig for the paper's own TinyML models -- and ``get_smoke(arch_id)``
an LM's reduced same-family config of the CPU tests. The port registers
the reference's ten LMs (SSM, hybrid, dense, audio, MoE and vision), in
its order, and the two AnalogNets. The dry run's shape cells
(``train_4k``, ``prefill_32k``, ``decode_32k``, ``long_500k``) live in
``shapes``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

# arch id -> module name
LM_ARCHS = {
    "mamba2-2.7b": "mamba2_2p7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama3.2-3b": "llama3p2_3b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "olmo-1b": "olmo_1b",
    "qwen2-72b": "qwen2_72b",
    "musicgen-large": "musicgen_large",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b",
    "paligemma-3b": "paligemma_3b",
}

CNN_ARCHS = {
    "analognet-kws": "analognet_kws",
    "analognet-vww": "analognet_vww",
}

ALL_ARCHS = {**LM_ARCHS, **CNN_ARCHS}

# Archs with sub-quadratic sequence mixing: the only ones that run the
# long_500k cell (the reference's rule; the 8 full-attention archs skip it).
SUBQUADRATIC = ("mamba2-2.7b", "recurrentgemma-9b")


def get(arch_id: str):
    if arch_id not in ALL_ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ALL_ARCHS[arch_id]}").config()


def get_smoke(arch_id: str) -> ModelConfig:
    cfg = get(arch_id)
    if not isinstance(cfg, ModelConfig):
        raise TypeError(f"{arch_id} is not an LM config")
    return cfg.smoke()
