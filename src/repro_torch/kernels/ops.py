"""Public analog-MVM entry over (..., K) inputs, port of ``repro.kernels.ops``.

:func:`analog_mvm` dispatches by device: a CUDA tensor launches the Hopper
kernel (``kernels.analog_mvm``) -- a failed launch raises, nothing falls
back -- and a CPU tensor runs the plain version
(``kernels.ref.analog_mvm_ref``). It computes no gradient.
:func:`analog_mvm_bank` does the same for an expert bank (B1's bank form,
``ref.analog_mvm_bank_ref``).

:func:`analog_mvm_ste` is the training entry, the counterpart of the
reference's ``jax.custom_vjp`` (``repro/kernels/ops.py:30-97``): its
forward is :func:`analog_mvm` (B1 on a card, with the quant-noise ``keep``
mask of the training form), its backward recomputes the plain training
form (``ref.analog_mvm_plain``) under autograd on the saved inputs and
returns its VJP for x, w, r_dac, r_adc and out_scale: gradients computed
with the quantized values, passed straight through the rounding, the clip
boundaries gating the range gradients (the paper's Sec. 4.2 rule). The
recompute is counted in ``backward_calls``, apart from the plain version's
forward ``calls``.

:func:`flash_attention_ste` is the prefill attention's training form. The
reference's Pallas kernel is forward only; it differentiates its XLA
``chunked_attention`` instead. Here the forward is
``kernels.flash_attention.flash_attention`` (B3 on a card, the plain
version on the CPU) and the backward recomputes the plain version
(``ref.flash_attention_plain``) under autograd on the saved q, k and v and
returns its VJP, counted in ``attention_backward_calls``.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from repro_torch.kernels import analog_mvm as kernel
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as attention_kernel
from repro_torch.kernels.ref import (
    analog_mvm_bank_ref,
    analog_mvm_plain,
    analog_mvm_ref,
    flash_attention_plain,
)

Tensor = torch.Tensor

#: backward recomputes of the plain training form since process start
backward_calls = 0
#: backward recomputes of the plain prefill attention since process start
attention_backward_calls = 0


def analog_mvm(
    x: Tensor,
    w: Tensor,
    *,
    r_adc,
    r_dac: Optional[Tensor] = None,
    out_scale=1.0,
    bits: int = 8,
    tile_rows: int = 1024,
    per_tile_adc: bool = True,
    keep: Optional[Tensor] = None,
) -> Tensor:
    """Analog MVM for (..., K) x (K, N). ``bits`` is the ADC ENOB; the DAC
    has one more (Eq. 3). ``r_dac=None``: x is already DAC-quantized.
    ``keep``: the training form's (M, T, N) quant-noise mask, M the rows of
    x flattened (``ref.tile_mvm``)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        y = kernel.analog_mvm(
            x2.contiguous(), w.contiguous(), r_adc=r_adc, r_dac=r_dac,
            out_scale=out_scale, b_adc=bits, tile_rows=tile_rows,
            per_tile_adc=per_tile_adc,
            keep=None if keep is None else keep.contiguous(),
        )
    elif x.device.type == "cpu":
        y = analog_mvm_ref(
            x2, w, r_dac, r_adc, out_scale, b_dac=bits + 1, b_adc=bits,
            tile_rows=tile_rows, per_tile_adc=per_tile_adc,
            apply_dac=r_dac is not None, keep=keep,
        )
    else:
        raise ValueError(f"analog_mvm: unsupported device {x.device}")
    return y.reshape(*lead, w.shape[-1])


def analog_mvm_bank(
    x: Tensor,
    w: Tensor,
    *,
    r_adc,
    out_scale=1.0,
    bits: int = 8,
    tile_rows: int = 1024,
    per_tile_adc: bool = True,
    keep: Optional[Tensor] = None,
) -> Tensor:
    """An expert bank's MVM: x (E, ..., K) already DAC-quantized, w (E, K,
    N), ``out_scale`` a float or the (E,) GDC scalars, ``keep`` the
    training form's (E, M, T, N) mask -> (E, ..., N). A CUDA tensor
    launches B1's bank form (``kernel.analog_mvm_bank``, one launch for
    every expert), a CPU tensor runs ``ref.analog_mvm_bank_ref``."""
    e, lead = x.shape[0], x.shape[1:-1]
    x3 = x.reshape(e, -1, x.shape[-1])
    if x.device.type == "cuda":
        y = kernel.analog_mvm_bank(
            x3.contiguous(), w.contiguous(), r_adc=r_adc, out_scale=out_scale, b_adc=bits,
            tile_rows=tile_rows, per_tile_adc=per_tile_adc,
            keep=None if keep is None else keep.contiguous(),
        )
    elif x.device.type == "cpu":
        y = analog_mvm_bank_ref(x3, w, r_adc, out_scale, b_adc=bits, tile_rows=tile_rows,
                                per_tile_adc=per_tile_adc, keep=keep)
    else:
        raise ValueError(f"analog_mvm_bank: unsupported device {x.device}")
    return y.reshape(e, *lead, w.shape[-1])


class _AnalogMVM(torch.autograd.Function):
    """Forward: :func:`analog_mvm` (this module's, looked up at call time);
    backward: the VJP of the plain training form, recomputed."""

    @staticmethod
    def forward(ctx, x, w, r_dac, r_adc, out_scale, keep, bits, tile_rows, per_tile_adc):
        ctx.save_for_backward(x, w, r_dac, r_adc, out_scale, keep)
        ctx.opts = (bits, tile_rows, per_tile_adc)
        return sys.modules[__name__].analog_mvm(
            x, w, r_adc=r_adc, r_dac=r_dac, out_scale=out_scale, bits=bits,
            tile_rows=tile_rows, per_tile_adc=per_tile_adc, keep=keep,
        )

    @staticmethod
    def backward(ctx, g):
        bits, tile_rows, per_tile_adc = ctx.opts
        saved = ctx.saved_tensors
        build.bump(sys.modules[__name__], "backward_calls")
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            x, w, r_dac, r_adc, out_scale = (
                None if t is None else t.detach().requires_grad_(n)
                for t, n in zip(saved[:5], need)
            )
            y = analog_mvm_plain(
                x.reshape(-1, x.shape[-1]), w, r_dac, r_adc, out_scale,
                b_dac=bits + 1, b_adc=bits, tile_rows=tile_rows,
                per_tile_adc=per_tile_adc, apply_dac=r_dac is not None,
                keep=saved[5],
            ).reshape(g.shape)
            wrt = [t for t, n in zip((x, w, r_dac, r_adc, out_scale), need) if n]
            got = iter(torch.autograd.grad(y, wrt, g, allow_unused=True))
        grads = [next(got) if n else None for n in need]
        grads = [torch.zeros_like(t) if n and gr is None else gr
                 for t, n, gr in zip(saved[:5], need, grads)]
        return (*grads, None, None, None, None)


def analog_mvm_ste(
    x: Tensor,
    w: Tensor,
    *,
    r_adc: Tensor,
    r_dac: Optional[Tensor] = None,
    out_scale=1.0,
    bits: int = 8,
    tile_rows: int = 1024,
    per_tile_adc: bool = True,
    keep: Optional[Tensor] = None,
) -> Tensor:
    """:func:`analog_mvm` with the reference's straight-through VJP (see
    the module docstring). ``out_scale`` may be a float (no gradient)."""
    if not isinstance(out_scale, Tensor):
        out_scale = torch.tensor(float(out_scale), dtype=torch.float32, device=x.device)
    return _AnalogMVM.apply(x, w, r_dac, r_adc, out_scale, keep, bits, tile_rows,
                            per_tile_adc)


class _FlashAttention(torch.autograd.Function):
    """Forward: the prefill-attention kernel's wrapper; backward: the VJP of
    its plain version, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, window):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, q_chunk, kv_chunk, window)
        return attention_kernel.flash_attention(
            q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk, window=window)

    @staticmethod
    def backward(ctx, g):
        causal, q_chunk, kv_chunk, window = ctx.opts
        build.bump(sys.modules[__name__], "attention_backward_calls")
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            o = flash_attention_plain(*qkv, causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                      window=window)
            wrt = [t for t, n in zip(qkv, need) if n]
            got = iter(torch.autograd.grad(o, wrt, g))
        return (*(next(got) if n else None for n in need), None, None, None, None)


def flash_attention_ste(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    window: Optional[int] = None,
) -> Tensor:
    """Prefill attention with a gradient: q (B, S, H, D), k and v (B, S, Kv,
    D) and the local ``window`` as ``kernels.flash_attention.flash_attention``
    takes them (see the module docstring).

    Memory: the recompute holds every (q chunk, kv chunk) block's f32
    scores and probabilities of one layer until its VJP is taken -- a
    (B, Kv, G, q_chunk, kv_chunk) block is B x 16.8 MB at tinyllama-1.1b's
    512/1024 chunks -- and frees them when that layer's backward ends;
    nothing of the forward's blocks is kept between forward and backward.
    """
    return _FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk, window)
