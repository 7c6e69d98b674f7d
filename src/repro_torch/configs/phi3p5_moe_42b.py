"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400.

MoE 16 experts top-2 in every layer (~42B total / 6.6B active).
Source: hf:microsoft/Phi-3.5-MoE-instruct; assignment tier: hf.
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab=32064,
        n_experts=16,
        top_k=2,
        moe_every=1,
        capacity_factor=1.25,
        moe_groups=32,
    )
