"""Shared model components, port of ``repro.models.common``: the LM config,
RMSNorm, embeddings and RoPE, and the logical-axis registry of sharded
serving."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch import prng

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Logical-axis registry. The tensor-parallel forward consults it: which
# logical dims (``heads``, ``kv_heads``, ``ffn``, ``vocab``, ``experts``,
# ``batch``) are split, and over which process group (the mesh's axis).
# With no rules set, or no mesh, every query answers "not split" and the
# forward is the one-device forward.
#
# Training's rules (``launch.sharding.logical_rules(training=True)``, which
# a sharded training step installs for the step's duration with
# :func:`logical_rules_of`) add ``rows``: the forward's batch rows are a
# data-parallel rank's rows of one global batch (:func:`row_axis`), so its
# draws take their rows of the whole batch's, its MoE groups are its rows'
# groups of the whole batch's and its loss gathers the per-token loss. The
# heads and FFN units stay over ``model``, as in serving.
# ---------------------------------------------------------------------------

# logical name -> mesh axes (None = replicated / not sharded)
_LOGICAL_RULES: dict[str, Any] = {}
_MESH: dict[str, Any] = {"mesh": None}


def set_logical_rules(rules: dict[str, Any], mesh: Any = None) -> None:
    """Install ``rules`` (``launch.sharding.logical_rules``) and the
    ``DeviceMesh`` whose axes they name; ``{}`` clears both."""
    _LOGICAL_RULES.clear()
    _LOGICAL_RULES.update(rules)
    _MESH["mesh"] = mesh if rules else None


def logical_rules() -> dict[str, Any]:
    return dict(_LOGICAL_RULES)


def current_mesh() -> Any:
    """The mesh the installed rules name (None: none)."""
    return _MESH["mesh"]


@contextlib.contextmanager
def logical_rules_of(rules: dict[str, Any], mesh: Any):
    """:func:`set_logical_rules` for the block's duration; the rules before
    it come back at its end."""
    before, before_mesh = dict(_LOGICAL_RULES), _MESH["mesh"]
    set_logical_rules(rules, mesh)
    try:
        yield
    finally:
        set_logical_rules(before, before_mesh)


def shard(x: Tensor, *names: Optional[str]) -> Tensor:
    """The reference's sharding annotation. The port's forward places its
    tensors itself (a rank's heads, columns or experts, see
    :func:`split_axis`), so this names the layout and returns ``x``."""
    return x


def mesh_axis(name: str = "model"):
    """The ``collectives.Axis`` of the registered mesh's axis ``name``, or
    None (no mesh registered, or no such axis)."""
    from repro_torch import collectives

    mesh = _MESH["mesh"]
    return None if mesh is None else collectives.axis_of(mesh, name)


def row_axis():
    """The ``collectives.Axis`` a training step's batch rows are split over
    (training's ``rows`` rule), or None."""
    return split_axis("rows")


def split_axis(name: str):
    """The ``collectives.Axis`` the logical dim ``name`` is split over, or
    None (no rules, no mesh, or the dim replicated)."""
    from repro_torch import collectives

    ax = _LOGICAL_RULES.get(name)
    mesh = _MESH["mesh"]
    if ax is None or mesh is None or not isinstance(ax, str):
        return None
    return collectives.axis_of(mesh, ax)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """LM-family configuration; every field of the reference's is kept.

    ``dtype`` is a ``torch.dtype`` (default bfloat16; :meth:`smoke` gives
    float32), the activation dtype of the whole forward.
    """

    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab: int = 256
    head_dim: int = 0  # 0 -> d_model // n_heads
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_groups: int = 16
    moe_dispatch: str = "einsum"
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    block_pattern: tuple = ()
    local_window: int = 2048
    lru_width: int = 0
    qkv_bias: bool = False
    nonparametric_ln: bool = False
    n_codebooks: int = 0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    frontend: str = "none"
    num_patches: int = 0
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def smoke(self) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests (the
        reference's ``smoke()`` values)."""
        return dataclasses.replace(
            self,
            n_layers=max(2, len(self.block_pattern) or 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_groups=2,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16,
            ssm_chunk=16,
            local_window=32,
            lru_width=0,
            num_patches=8 if self.frontend == "vision_patches" else 0,
            attn_chunk_q=16,
            attn_chunk_kv=32,
            dtype=torch.float32,
            remat=False,
        )


def rmsnorm_init(cfg: ModelConfig, width: int | None = None, *, device) -> dict:
    if cfg.nonparametric_ln:
        return {}
    return {"scale": torch.ones((width or cfg.d_model,), device=device)}


def rmsnorm_apply(params: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    if "scale" in params:
        x = x * params["scale"]
    return x.to(dtype)


def embedding_init(key: Tensor, vocab: int, d_model: int) -> dict:
    """N(0, 0.02) embedding table drawn from ``key`` (the reference's draw)."""
    return {"table": prng.normal(key, (vocab, d_model)) * 0.02}


def embedding_apply(params: dict, tokens: Tensor, dtype) -> Tensor:
    """Rows of the table, cast: gather, then cast -- the same values as the
    reference's cast-then-gather, without casting the whole table on every
    call. A vocab-sharded table (``"tp"``: this rank's rows) looks up the
    tokens it holds, every rank's lookups are gathered and each token takes
    the row of the one rank that holds it (an exact selection)."""
    split = params.get("tp")
    if split is None:
        return params["table"][tokens].to(dtype)
    from repro_torch import collectives

    axis = mesh_axis("model")
    local = params["table"][(tokens - split.start).clamp(0, split.stop - split.start - 1)]
    every = collectives.all_gather_dim(local[None], 0, tuple(range(split.n + 1)), axis)
    inner = torch.tensor(split.bounds[1:-1], dtype=tokens.dtype, device=tokens.device)
    owner = torch.bucketize(tokens, inner, right=True)
    idx = owner[None, ..., None].expand(1, *local.shape)
    return torch.gather(every, 0, idx)[0].to(dtype)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embeddings. x: (..., S, H, hd), positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.full_like(exponent, theta), exponent)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
