"""The per-layer decode step's row kernels (``csrc/decode_rows.cu``).

RMSNorm, RoPE, decode attention and the silu gate of one token per slot,
each a thin kernel over ``csrc/decode_rows_core.cuh``: the per-element code
the fused decode kernel (B2, ``csrc/decode_fused.cu``) runs for the same
ops. On a card the per-layer decode (``models/lm.py``,
``models/attention.py``) launches them, so a per-layer step and a fused
step compute the same norms, K/V rows, attention outputs and gate products
bit for bit, and the DAC codes of every MVM agree. They are not ports of a
TPU kernel: the reference runs these ops as XLA ops.

Each wrapper runs its plain version on a CPU tensor -- today's PyTorch ops
(``models.common.rmsnorm_apply``, ``models.common.rope``,
``models.attention.decode_attention``, the gate of ``models.lm``) -- and
its kernel on a CUDA tensor: it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, raises
on a launch error, and adds one to ``launches[name]`` per launch and
nowhere else; on fake tensors (a dry run) it allocates its outputs and
launches and counts nothing. Each call is one unit of ``analysis.cost``'s
count (``rows.<name>``; attention's FLOPs 4 D per query head and cache
row). Prefill keeps its PyTorch ops: B2 has no prefill counterpart.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional

import torch

from repro_torch.analysis import cost
from repro_torch.kernels import build

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: query heads of one KV head per attention pass at most
#: (``drows::kMaxPass``: a register accumulator each; more unrolled code ran
#: slower), and the shared memory a pass's q rows and scores aim to stay
#: within; B2 (``kernels/decode_fused.py``) sizes its passes with these too
MAX_PASS = 2
PASS_SMEM = 32 * 1024
#: kernel launches since process start, by kernel
launches = {"norm": 0, "rope": 0, "attn": 0, "gate": 0}
_FN = None


def _fn():
    global _FN
    with build.LOCK:
        if _FN is None:
            lib = build.load("decode_rows")
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            sigs = {
                "decode_rows_norm": [P, P, P, I, I, F, I, P],
                "decode_rows_rope": [P, P, P, P, I, I, I, I, I, P],
                "decode_rows_attn": [P, P, P, P, P, I, I, I, I, I, I, I, F, I, P],
                "decode_rows_gate": [P, P, P, I, I, P],
            }
            fns = {}
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name.split("_")[-1]] = fn
            lib.decode_rows_error_string.argtypes = [ctypes.c_int]
            lib.decode_rows_error_string.restype = ctypes.c_char_p
            _FN = (fns, lib.decode_rows_error_string)
    return _FN


def _launch(name: str, *args) -> None:
    fns, err = _fn()
    rc = fns[name](*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_rows {name} kernel launch failed: {err(rc).decode()}")
    build.bump(sys.modules[__name__], "launches", name)


def _check(name: str, *tensors: Tensor) -> int:
    t0 = tensors[0]
    if t0.dtype not in _DTYPES:
        raise TypeError(f"decode_rows {name}: float32 or bfloat16, got {t0.dtype}")
    for t in tensors:
        if t.device != t0.device or not t.is_contiguous() or t.dtype != t0.dtype:
            raise ValueError(
                f"decode_rows {name}: contiguous {t0.dtype} tensors on one device, got "
                f"{t.dtype} on {t.device} (contiguous: {t.is_contiguous()})"
            )
    return _DTYPES[t0.dtype]


def _ptr(t: Tensor):
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# Plain versions: today's PyTorch ops of the per-layer decode
# ---------------------------------------------------------------------------


def norm_plain(x: Tensor, scale: Optional[Tensor], eps: float) -> Tensor:
    from repro_torch.models.common import rmsnorm_apply

    norm_plain.calls += 1
    return rmsnorm_apply({} if scale is None else {"scale": scale}, x, eps)


def rope_plain(q: Tensor, k: Tensor, pos: Tensor, theta: float):
    """q (B, 1, H, HD), k (B, 1, KV, HD) rotated at each slot's ``pos`` (B,)
    with ``models.common.rope``."""
    from repro_torch.models.common import rope

    rope_plain.calls += 1
    return rope(q, pos[:, None], theta), rope(k, pos[:, None], theta)


def attention_plain(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor) -> Tensor:
    from repro_torch.models.attention import KVCache, decode_attention

    attention_plain.calls += 1
    return decode_attention(q, KVCache(k, v, lengths))


def gate_plain(u: Tensor, g: Tensor) -> Tensor:
    gate_plain.calls += 1
    return torch.nn.functional.silu(u) * g


#: calls of each plain version since process start (a check that the main
#: path on a card never took one)
norm_plain.calls = rope_plain.calls = attention_plain.calls = gate_plain.calls = 0


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device) -> Tensor:
    """(hd/2,) f32 RoPE frequencies, computed with ``models.common.rope``'s
    own ops; a kernel forms each angle as ``float(position) * freq``."""
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.full_like(exponent, theta), exponent)


_FREQS: dict = {}


def _freqs(hd: int, theta: float, device) -> Tensor:
    key = (hd, float(theta), torch.device(device))
    if key not in _FREQS:
        _FREQS[key] = rope_freqs(hd, theta, device)
    return _FREQS[key]


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device``."""
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


def attn_heads(most: int, n_slots: int, n_heads: int, grid: int) -> int:
    """Query heads per attention item: as few as give every block of the
    grid an item (the items are (slot, KV head, pass of heads)), at most
    ``most``."""
    return min(most, max(1, -(-n_slots * n_heads // grid)))


def heads_per_pass(n_heads: int, n_kv: int, hd: int, n_slots: int, s_max: int,
                   grid: int) -> int:
    """Query heads per attention item, as B2 sizes them for ``grid`` blocks
    (B2 and the per-layer kernel both pass the card's SM count: the AV sums
    depend on it)."""
    most = min(n_heads // n_kv, MAX_PASS, max(1, PASS_SMEM // ((s_max + hd) * 4)))
    return attn_heads(most, n_slots, n_heads, grid)


def _norm(x: Tensor, scale: Optional[Tensor], eps: float) -> Tensor:
    if not build.on_card(x):
        return norm_plain(x, scale, eps)
    d = x.shape[-1]
    if scale is None:
        scale = torch.ones((d,), dtype=torch.float32, device=x.device)
    scale = scale.float().contiguous()
    x = x.contiguous()
    dt = _check("norm", x)
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"decode_rows norm: scale {tuple(scale.shape)} for width {d}")
    out = torch.empty_like(x)
    if build.is_fake(x):
        return out
    _launch("norm", _ptr(x), _ptr(scale), _ptr(out), x.numel() // d, d, float(eps), dt)
    return out


def _rope(q: Tensor, k: Tensor, pos: Tensor, theta: float):
    if not build.on_card(q):
        return rope_plain(q, k, pos, theta)
    if build.is_fake(q):  # a dry run: the rotated copies, nothing launched or cached
        return q.contiguous().clone(), k.contiguous().clone()
    freqs = _freqs(q.shape[-1], theta, q.device)
    b, s, h, hd = q.shape
    if s != 1 or k.shape[:2] != (b, 1) or k.shape[-1] != hd or pos.shape != (b,):
        raise ValueError(
            f"decode_rows rope: one token per slot, got q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, positions {tuple(pos.shape)}"
        )
    q, k = q.contiguous().clone(), k.contiguous().clone()
    dt = _check("rope", q, k)
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    _launch("rope", _ptr(q), _ptr(k), _ptr(pos), _ptr(freqs), b, h, k.shape[2], hd, dt)
    return q, k


def _attention(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor) -> Tensor:
    if not build.on_card(q):
        return attention_plain(q, k, v, lengths)
    b, s, h, hd = q.shape
    s_max, kv = k.shape[1], k.shape[2]
    if s != 1 or k.shape != (b, s_max, kv, hd) or v.shape != k.shape or h % kv:
        raise ValueError(
            f"decode_rows attention: q {tuple(q.shape)} against a cache "
            f"{tuple(k.shape)} / {tuple(v.shape)}"
        )
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dt = _check("attn", q, k, v)
    lens = torch.broadcast_to(lengths.to(device=q.device, dtype=torch.int32), (b,)).contiguous()
    if build.is_fake(q):
        return torch.empty_like(q)
    hp = heads_per_pass(h, kv, hd, b, s_max, sm_count(q.device))
    vec_elems = 16 // q.element_size()
    vec = int(hd % vec_elems == 0 and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    out = torch.empty_like(q)
    _launch("attn", _ptr(q), _ptr(k), _ptr(v), _ptr(lens), _ptr(out), b, s_max, h, kv, hd,
            hp, vec, float(hd ** -0.5), dt)
    return out


def _gate(u: Tensor, g: Tensor) -> Tensor:
    if not build.on_card(u):
        return gate_plain(u, g)
    if u.shape != g.shape:
        raise ValueError(f"decode_rows gate: {tuple(u.shape)} vs {tuple(g.shape)}")
    u, g = u.contiguous(), g.contiguous()
    dt = _check("gate", u, g)
    out = torch.empty_like(u)
    if build.is_fake(u):
        return out
    _launch("gate", _ptr(u), _ptr(g), _ptr(out), u.numel(), dt)
    return out


def norm(x: Tensor, scale: Optional[Tensor], eps: float) -> Tensor:
    """RMSNorm of each row of ``x`` (..., D) times ``scale`` (D,) (None: 1),
    rounded to x's dtype."""
    return cost.unit("rows.norm", 0, (x, scale), _norm, x, scale, eps)


def rope(q: Tensor, k: Tensor, pos: Tensor, theta: float):
    """q (B, 1, H, HD) and k (B, 1, KV, HD) rotated at position ``pos[b]``
    (B,) of each slot -> (q, k), new tensors."""
    return cost.unit("rows.rope", 0, (q, k, pos), _rope, q, k, pos, theta)


def attention(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor) -> Tensor:
    """Decode attention of q (B, 1, H, HD) against a cache k, v (B, S, KV,
    HD) whose new rows are written: each slot attends its positions <
    min(lengths[b], S). -> (B, 1, H, HD)."""
    if not cost.counting():
        return _attention(q, k, v, lengths)
    b, _, h, hd = q.shape
    return cost.unit("rows.attn", 4 * hd * b * h * k.shape[1], (q, k, v, lengths), _attention,
                     q, k, v, lengths)


def gate(u: Tensor, g: Tensor) -> Tensor:
    """silu(u) * g, elementwise, rounded to the dtype after each op."""
    return cost.unit("rows.gate", 0, (u, g), _gate, u, g)
