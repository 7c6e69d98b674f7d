"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8).

MoE 128 experts top-1, interleaved every other layer, with a shared expert
(the Llama-4 recipe); d_ff=8192 per expert. ~394B total / ~13B active params
with this layout -- matching the 400b-a17b class. Source:
hf:meta-llama/Llama-4 family; assignment tier: unverified.
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=202048,
        n_experts=128,
        top_k=1,
        moe_every=2,
        shared_expert=True,
        capacity_factor=1.25,
        moe_groups=32,
        rope_theta=500000.0,
    )
