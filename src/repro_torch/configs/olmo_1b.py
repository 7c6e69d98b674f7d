"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16, i.e. MHA) d_ff=8192.

Non-parametric LayerNorm (no scale/bias). Source: arXiv:2402.00838; hf.
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab=50304,
        nonparametric_ln=True,
    )
