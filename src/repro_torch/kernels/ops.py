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

On a tensor-parallel rank of a training step (``core.analog``) a layer
holds a shard: its output columns, whole crossbar tiles of its rows, or
(a MoE bank) its experts. :func:`sharded` runs such a layer: forward, the
rank's part (:func:`analog_mvm_shard`: B1's training form on the rank's
columns, or on each of its tiles with the ranks' partials gathered and
summed in tile order); backward, the layer's whole inputs gathered over
the axis (the output gradient's columns, the weight's columns or rows,
the mask's columns or tiles) and the VJP of the unsharded layer taken on
them, exactly as the unsharded layer takes it, the rank keeping its slice
of each sharded input's gradient. Every rank computes the same whole
backward, so an input's gradient (x's, a range's) is whole and the same
on every rank and no partial gradient is summed across ranks. B3's
training form needs no such step: the rank runs it on its heads, and each
head's VJP is its own.

The dispatchers take the card's route where ``kernels.build.on_card``
says so (a CUDA tensor, or a fake one in a dry run's card trace), and
each call is one unit of ``analysis.cost``'s count: B1's 2 M K N FLOPs,
whichever route computes them.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import torch

from repro_torch import collectives
from repro_torch.analysis import cost

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


def b1_unit(fn: Callable[..., Tensor], args: tuple, reads: tuple) -> Tensor:
    """``fn(*args)``, one B1 call reading ``reads``, ``x`` (..., K) and ``w``
    (..., K, N) first, as a unit of ``analysis.cost``'s count: 2 M K N
    FLOPs (M K the elements of ``x``; a bank's E included), ``reads``
    read. With no count running, ``fn(*args)`` alone."""
    if not cost.counting():
        return fn(*args)
    x, w = reads[:2]
    return cost.unit("B1", 2 * x.numel() * w.shape[-1], reads, fn, *args)


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
    return b1_unit(_analog_mvm, (x, w, r_adc, r_dac, out_scale, bits, tile_rows, per_tile_adc,
                                 keep), (x, w, r_adc, r_dac, out_scale, keep))


def _analog_mvm(x, w, r_adc, r_dac, out_scale, bits, tile_rows, per_tile_adc, keep):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if build.on_card(x):
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
    return b1_unit(_analog_mvm_bank, (x, w, r_adc, out_scale, bits, tile_rows, per_tile_adc,
                                      keep), (x, w, r_adc, out_scale, keep))


def _analog_mvm_bank(x, w, r_adc, out_scale, bits, tile_rows, per_tile_adc, keep):
    e, lead = x.shape[0], x.shape[1:-1]
    x3 = x.reshape(e, -1, x.shape[-1])
    if build.on_card(x):
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


def _train_vjp(saved: tuple, need: tuple, g: Tensor, bits: int, tile_rows: int,
               per_tile_adc: bool) -> list:
    """The VJP of the plain training form at ``saved`` = (x, w, r_dac,
    r_adc, out_scale, keep) for the inputs ``need`` marks (zeros where the
    output does not depend on one), recomputed under autograd."""
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
    return [torch.zeros_like(t) if n and gr is None else gr
            for t, n, gr in zip(saved[:5], need, grads)]


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
        build.bump(sys.modules[__name__], "backward_calls")
        grads = _train_vjp(ctx.saved_tensors, ctx.needs_input_grad[:5], g, *ctx.opts)
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


class _Sharded(torch.autograd.Function):
    """Forward: ``local(*args)``; backward: the VJP of ``whole`` on the
    gathered inputs, each sharded input's gradient cut to the rank's slice
    (see the module docstring)."""

    @staticmethod
    def forward(ctx, local, whole, parts, out_part, axis, *args):
        ctx.save_for_backward(*args)
        ctx.run = (whole, parts, out_part, axis)
        return local(*args)

    @staticmethod
    def backward(ctx, g):
        whole, parts, out_part, axis = ctx.run
        gather = lambda t, part: t if part is None else collectives.all_gather_dim(
            t, part[0], part[1], axis)
        g = gather(g.contiguous(), out_part)
        args = [None if t is None else gather(t, part)
                for t, part in zip(ctx.saved_tensors, parts)]
        grads = whole(g, ctx.needs_input_grad[5:], *args)
        return (None, None, None, None, None, *(
            gr if gr is None or part is None else collectives.rank_slice(gr, *part, axis)
            for gr, part in zip(grads, parts)))


def sharded(local: Callable, whole_vjp: Callable, args: tuple, parts: tuple, axis,
            out_part: Optional[tuple] = None) -> Tensor:
    """A layer on a rank's shard with the unsharded layer's gradients.

    ``local(*args)`` is the forward on the rank's inputs: its output is
    whole, or with ``out_part = (dim, bounds)`` the rank's slice of the
    whole output. ``parts[i]`` is None where ``args[i]`` is whole on every
    rank, or ``(dim, bounds)`` where the rank holds its slice
    ``[bounds[r], bounds[r + 1])`` along ``dim``. ``whole_vjp(g, need,
    *whole_args)`` returns the unsharded layer's VJP (one gradient or None
    per arg, where ``need`` marks it) at the whole output gradient ``g``."""
    return _Sharded.apply(local, whole_vjp, tuple(parts), out_part, axis, *args)


def autograd_vjp(fn: Callable) -> Callable:
    """The ``whole_vjp`` of :func:`sharded` for a differentiable ``fn``:
    ``fn`` recomputed on the whole inputs under autograd and its VJP taken
    (zeros for an input the output does not depend on)."""

    def vjp(g, need, *args):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_() if n else a for a, n in zip(args, need)]
            y = fn(*leaves)
            wrt = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(y, wrt, g, allow_unused=True))
        grads = [next(got) if n else None for n in need]
        return [torch.zeros_like(t) if n and gr is None else gr
                for t, n, gr in zip(leaves, need, grads)]

    return vjp


def analog_mvm_shard(
    x: Tensor,
    w: Tensor,
    *,
    r_adc: Tensor,
    split,
    axis,
    bits: int = 8,
    tile_rows: int = 1024,
    per_tile_adc: bool = True,
    keep: Optional[Tensor] = None,
) -> Tensor:
    """:func:`analog_mvm_ste` (no DAC, ``out_scale`` 1) on a rank's shard
    ``w`` of one layer (``split``: a ``launch.sharding.Split``, ``axis`` the
    ``collectives.Axis`` it lies across); ``x`` is the layer's whole input
    and ``keep`` the rank's slice of the whole mask
    (``engine.quant_noise_keep(split=)``).

    A column shard gives the rank's output columns: one :func:`analog_mvm`
    (B1's training form on a card). A row shard (whole crossbar tiles of K)
    gives the whole output: one :func:`analog_mvm` a tile on its rows of
    ``x``, each tile's ADC'd partial at the activation dtype, every rank's
    partials gathered and summed in tile order at ``tile_mvm``'s rounding
    points. Backward: the plain training form's VJP on the whole layer
    (:func:`sharded`), one recompute counted in ``backward_calls``."""
    mod = sys.modules[__name__]
    one = torch.tensor(1.0, dtype=torch.float32, device=x.device)
    tile_bounds = tuple(-(-b // tile_rows) for b in split.bounds)

    def tiles(x, w, r_adc, keep):
        from repro_torch.core.engine import tile_sum

        xl = x[..., split.start:split.stop]
        parts = []
        for i, lo in enumerate(range(0, w.shape[0], tile_rows)):
            hi = min(lo + tile_rows, w.shape[0])
            parts.append(mod.analog_mvm(
                xl[..., lo:hi].contiguous(), w[lo:hi], r_adc=r_adc, out_scale=one, bits=bits,
                tile_rows=tile_rows, per_tile_adc=per_tile_adc,
                keep=None if keep is None else keep[:, i:i + 1]))
        return tile_sum(collectives.all_gather_dim(torch.stack(parts), 0, tile_bounds, axis),
                        one, x.dtype)

    def columns(x, w, r_adc, keep):
        return mod.analog_mvm(x, w, r_adc=r_adc, out_scale=one, bits=bits, tile_rows=tile_rows,
                              per_tile_adc=per_tile_adc, keep=keep)

    def whole_vjp(g, need, x, w, r_adc, keep):
        build.bump(mod, "backward_calls")
        gx, gw, _, gr, _ = _train_vjp((x, w, None, r_adc, one, keep),
                                      (need[0], need[1], False, need[2], False), g, bits,
                                      tile_rows, per_tile_adc)
        return gx, gw, gr, None

    if split.dim == -1:  # the mask's columns, the output's columns
        return sharded(columns, whole_vjp, (x, w, r_adc, keep),
                       (None, (-1, split.bounds), None, None if keep is None else
                        (-1, split.bounds)), axis, (-1, split.bounds))
    # the mask's tiles; the output whole
    return sharded(tiles, whole_vjp, (x, w, r_adc, keep),
                   (None, (-2, split.bounds), None, None if keep is None else (-2, tile_bounds)),
                   axis)


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
