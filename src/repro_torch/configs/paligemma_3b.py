"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384.

SigLIP vision tower is a STUB per the assignment: input_specs() provides 256
precomputed patch embeddings at d_model, prepended to the text sequence.
Source: arXiv:2407.07726; assignment tier: hf.
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=257216,
        frontend="vision_patches",
        num_patches=256,
    )
