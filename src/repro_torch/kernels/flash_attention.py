"""Wrapper of the Hopper prefill-attention kernel (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_kernel``: bf16
runs on a tensor-core kernel, fp32 on a CUDA-core one (no TF32). The CUDA
source holds the design notes (what it computes, its bound, what the
design does about it); the plain PyTorch version of the same function is
``kernels.ref.flash_attention_ref``.

:func:`flash_attention` runs the plain version on a CPU tensor and the
kernel on a CUDA tensor -- a failed build or launch raises, nothing falls
back. On the card it checks device, dtype, shape and contiguity, allocates
the output, launches on the current stream, raises on a launch error, and
adds one to ``flash_attention.launches`` per launch (and nowhere else), so a
run can show that its path went through the kernel (on fake tensors it
allocates the output and launches and counts nothing). ``window`` is local
attention's (the hybrid family's): on the card a block starts its key walk
at the first key tile live for its first row (:func:`_launch` with
``skip=False`` walks every key from 0, as the plain version does -- a
checks-only path that shows the skip leaves the bits alone).
"""

from __future__ import annotations

import ctypes

import torch

from typing import Optional

from repro_torch.analysis import cost
from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels are instantiated for (256: recurrentgemma's and
#: paligemma's; the bf16 kernel splits its output columns over two warps
#: there and rings 2 K/V tiles, not 4)
HEAD_DIMS = (16, 32, 64, 128, 256)
_MAX_GRID_YZ = 65535
_FN = None


def _fn():
    global _FN
    with build.LOCK:
        if _FN is None:
            lib = build.load("flash_attention")
            fn = lib.flash_attention_launch
            fn.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float]
                + [ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            lib.flash_attention_error_string.argtypes = [ctypes.c_int]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _FN = (fn, lib.flash_attention_error_string)
    return _FN


def flash_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    window: Optional[int] = None,
) -> Tensor:
    """Attention forward: q (B, S, H, D), k and v (B, S, Kv, D) -> (B, S, H, D)
    in q's dtype; query head h reads KV head ``h // (H / Kv)``.

    ``q_chunk`` and ``kv_chunk`` are the model's attention chunks
    (``ModelConfig.attn_chunk_q`` / ``attn_chunk_kv``): the plain version
    runs at them, and the kernel updates its online softmax at the same
    ``kv_chunk`` boundaries, so both round p at the same points. ``window``
    (None: none) masks keys at ``q_pos - k_pos >= window``.
    """
    if not cost.counting():
        return _route(q, k, v, causal, q_chunk, kv_chunk, window)
    b, sq, h, d = q.shape
    flops = 4 * d * b * h * live_pairs(sq, causal, window)
    return cost.unit("B3", flops, (q, k, v), _route, q, k, v, causal, q_chunk, kv_chunk, window)


def _route(q, k, v, causal, q_chunk, kv_chunk, window) -> Tensor:
    if not build.on_card(q):
        return flash_attention_ref(q, k, v, causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   window=window)
    o = _launch(q, k, v, causal=causal, kv_chunk=kv_chunk, window=window, skip=True)
    if not build.is_fake(q):
        build.bump(flash_attention, "launches")
    return o


def live_pairs(s: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs of one head of an S-row sequence that the
    causal mask and the local ``window`` leave live (the work a launch
    needs; it skips the masked tiles)."""
    if not causal:
        return s * s
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def _launch(q: Tensor, k: Tensor, v: Tensor, *, causal: bool, kv_chunk: int,
            window: Optional[int], skip: bool) -> Tensor:
    """One launch on the card, uncounted. ``skip=False`` walks every key
    tile from 0 (the checks' path; see the module docstring)."""
    if not build.on_card(q) or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention kernel needs q, k and v on one CUDA device, got "
            f"{q.device}, {k.device} and {v.device}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q, k and v of "
            f"one dtype, got {q.dtype}, {k.dtype} and {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention kernel needs q (B, S, H, D) and k, v (B, S, Kv, "
            f"D), got {tuple(q.shape)}, {tuple(k.shape)} and {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d or h % kv:
        raise ValueError(
            f"flash_attention kernel: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "need one batch, one sequence, one head dim and H a multiple of Kv"
        )
    if (d not in HEAD_DIMS or min(b, s) < 1 or max(b, h) > _MAX_GRID_YZ or kv_chunk < 1
            or (window is not None and window < 1)):
        raise ValueError(
            f"flash_attention kernel: unsupported B={b} S={s} H={h} D={d} "
            f"kv_chunk={kv_chunk} window={window} (D in {HEAD_DIMS}, window >= 1)"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k and v")
    if build.is_fake(q):  # a dry run: the output, nothing launched
        return torch.empty_like(q)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        # the tensor-core kernel moves rows in 16-byte copies
        raise ValueError("flash_attention bf16 kernel needs 16-byte aligned q, k and v")
    o = torch.empty_like(q)
    fn, err_str = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, kv,
            d, int(causal), int(kv_chunk), int(window or 0), int(skip), d**-0.5,
            _DTYPES[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: {err_str(rc).decode()} "
            f"(B={b} S={s} H={h} Kv={kv} D={d} window={window} dtype={q.dtype})"
        )
    return o


#: kernel launches since process start (see module docstring)
flash_attention.launches = 0
