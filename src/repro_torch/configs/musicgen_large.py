"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens, 4 parallel codebook heads. The EnCodec
frontend is a STUB per the assignment: input_specs() provides precomputed
frame embeddings (B, S, d_model). Source: arXiv:2306.05284; hf.
"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=2048,
        n_codebooks=4,
        frontend="audio_frames",
    )
