"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free SSD, state=128.

Source: arXiv:2405.21060 (Mamba-2); assignment tier: unverified.
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,  # attention-free, no MLP: the Mamba-2 block is the whole layer
        vocab=50280,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=256,
        conv_width=4,
    )
