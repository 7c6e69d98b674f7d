"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288.

RG-LRU + local attention in a 1(attn):2(recurrent) pattern, window 2048.
Source: arXiv:2402.19427 (Griffin); assignment tier: unverified.
38 = 12 * (rec, rec, attn) + 2 tail recurrent layers (unscanned).
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab=256000,
        block_pattern=("rec", "rec", "attn"),
        local_window=2048,
        conv_width=4,
    )
