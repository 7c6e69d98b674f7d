"""The RNG bridge: ``jax.random``'s draws, bit for bit, in torch.

The reference draws every noise sample -- a chip's programming, drift and
read noise, its initial weights, the request trace -- from ``jax.random``
with the partitionable threefry2x32 lowering (``repro/__init__.py``). This
module is the port's own copy of what the reference uses of it:

* keys: :func:`PRNGKey`, :func:`split`, :func:`fold_in`, :func:`bits`;
* samplers: :func:`uniform`, :func:`normal`, :func:`bernoulli`,
  :func:`randint`, :func:`choice`, :func:`exponential`.

A key is an int64 tensor of shape (2,) holding the two uint32 words of
JAX's raw key (``np.asarray(jax_key)``). Every 32-bit operation runs in
int64 lanes masked to 32 bits (torch's CPU ``uint32`` has no add or
shifts).

The float samplers reproduce XLA-CPU's code for the same functions, not
a libm: ``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's f32 ``erf_inv``
(Giles' polynomial, each Horner step one fused multiply-add) over XLA-
CPU's own ``log1p`` (a Cephes rational below sqrt(2) - 1, Eigen's
``plog`` above), and ``exponential`` is ``-log1p(-u)``. Every step is an
IEEE ``+ - * /``, ``sqrt`` or an f32 FMA computed exactly (:func:`fma`),
so the same code gives the same bits on the CPU and on a card; a key on a
card draws its normals with the hand-written kernel ``csrc/prng.cu``,
which runs the same operations (native FMA) and gives the same bits.

:func:`powf` is glibc's ``powf`` (the reference's ``x ** y`` on the CPU
calls it), written out the same way for the PCM model's drift law and
read-noise coefficient.
"""

from __future__ import annotations

import functools
import math
import struct
import sys
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.analysis import cost
from repro_torch.kernels import build

Tensor = torch.Tensor
Shape = Union[int, Sequence[int]]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _u32(x) -> Tensor:
    return x & _M32


def _emulated(name: str, operands: tuple, dtype: torch.dtype, n_out: int, fn):
    """``fn()``, an operation torch ops emulate bit for bit (a hash, an exact
    FMA, ``powf``). On fake operands outside a counted run (a dry run's
    set-up: ``lm_init`` on fake tensors) it makes the ``n_out`` results'
    tensors and emulates nothing; inside ``analysis.cost.count`` it runs
    the emulation's ops, as a real run does, so the counts and the traced
    memory are the real run's -- once for each ``name`` and signature of
    the operands, then replayed (``cost.memoized``: the ops follow from
    the shapes, and a PCM chain's emulations repeat them)."""
    ts = [t for t in operands if isinstance(t, Tensor)]
    if not any(build.is_fake(t) for t in ts):
        return fn()
    if cost.counting():
        return cost.memoized((name, build.on_card(ts[0]), *(
            (tuple(t.shape), t.stride(), t.dtype, t.device.type) if isinstance(t, Tensor)
            else type(t) for t in operands)), fn)
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    outs = tuple(torch.empty(shape, dtype=dtype, device=ts[0].device) for _ in range(n_out))
    return outs if n_out > 1 else outs[0]


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor):
    """The Threefry-2x32 hash (20 rounds) of count pairs (x1, x2) under the
    key (k1, k2); all int64 tensors of uint32 values, broadcast together."""
    return _emulated("threefry", (k1, k2, x1, x2), torch.int64, 2,
                     lambda: _threefry2x32(k1, k2, x1, x2))


def _threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor):
    ks = [k1, k2, k1 ^ k2 ^ 0x1BD11BDA]
    x = [_u32(x1 + ks[0]), _u32(x2 + ks[1])]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = _u32(x[0] + x[1])
            x1r = _u32((x[1] << r) | (x[1] >> (32 - r)))
            x = [x0, x0 ^ x1r]
        x = [_u32(x[0] + ks[(i + 1) % 3]), _u32(x[1] + ks[(i + 2) % 3] + (i + 1))]
    return x[0], x[1]


def PRNGKey(seed: int) -> Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit integer seed."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"PRNGKey seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def _check_key(key: Tensor) -> tuple[Tensor, Tensor]:
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(
            f"a key is an int64 tensor of shape (2,), got {key.dtype} "
            f"{tuple(key.shape)}"
        )
    return key[0], key[1]


def _iota_2x32(shape: tuple, device) -> tuple[Tensor, Tensor]:
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, _u32(idx)


def split(key: Tensor, num: Shape = 2) -> Tensor:
    """``jax.random.split``: (``*num``, 2) new keys."""
    k1, k2 = _check_key(key)
    c1, c2 = _iota_2x32(_shape(num), key.device)
    b1, b2 = threefry2x32(k1, k2, c1, c2)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: Tensor, data) -> Tensor:
    """``jax.random.fold_in``: a new key from ``key`` and a uint32 datum
    (an int, or an integer tensor of one value: a step's own counter,
    folded in without a read to the host)."""
    k1, k2 = _check_key(key)
    if isinstance(data, Tensor):
        d = torch.zeros_like(k2) + (data.reshape(()).to(k2.device, torch.int64) & _M32)
    else:
        d = torch.full_like(k2, int(data) & _M32)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(k1), d)
    return torch.stack([b1, b2])


def _flat_bits(key: Tensor, start: int, stop: int, row: Optional[tuple] = None,
               offset: int = 0) -> Tensor:
    """The bits of a draw's flat counters ``start`` to ``stop`` (1-D) past
    ``offset``; ``row = (row_len, row_stride)`` maps flat index ``i`` to
    counter ``offset + (i // row_len) * row_stride + i % row_len`` (a column
    block of a wider draw)."""
    k1, k2 = _check_key(key)
    idx = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    if row is not None:
        idx = (idx // row[0]) * row[1] + idx % row[0]
    idx = idx + offset
    b1, b2 = threefry2x32(k1, k2, idx >> 32, _u32(idx))
    return b1 ^ b2


def bits(key: Tensor, shape: Shape) -> Tensor:
    """``jax.random.bits`` (uint32): int64 tensor of uint32 values."""
    shape = _shape(shape)
    return _flat_bits(key, 0, math.prod(shape)).reshape(shape)


#: a CPU draw runs in slices of this many counters, so each slice's int64
#: temporaries stay in the caches (measured 5x faster than one pass over
#: 4 M values); a value depends only on its counter, so the bits are the same
_CPU_SLICE = 1 << 18
#: values of an exact ``fma`` on a card done at once (its f64 temporaries)
_CARD_SLICE = 1 << 26


def _sliced(n: int, card: bool, part) -> Tensor:
    """``part(start, stop)`` (a 1-D result) over [0, n): one call on a card
    (``card``: ``kernels.build.on_card``) or for ``n <= _CPU_SLICE``, else
    on the CPU slice by slice."""
    if card or n <= _CPU_SLICE:
        return part(0, n)
    first = part(0, _CPU_SLICE)
    out = torch.empty(n, dtype=first.dtype)
    out[:_CPU_SLICE] = first
    for start in range(_CPU_SLICE, n, _CPU_SLICE):
        stop = min(start + _CPU_SLICE, n)
        out[start:stop] = part(start, stop)
    return out


def _row(shape: tuple, stride: Optional[int]) -> Optional[tuple]:
    """A strided draw's ``(row_len, row_stride)``, None when contiguous."""
    if stride is None or not shape or stride == shape[-1]:
        return None
    if stride < shape[-1]:
        raise ValueError(f"a draw's row stride {stride} is below its row length {shape[-1]}")
    return (shape[-1], stride)


def _draw(key: Tensor, shape: tuple, values, offset: int = 0,
          stride: Optional[int] = None) -> Tensor:
    """``values`` (an elementwise map of the bits) over a draw's counters
    ``offset`` to ``offset + prod(shape)`` (:func:`_sliced`); with
    ``stride``, row ``r`` of the draw takes its counters from ``offset + r *
    stride`` on (a column block of a wider draw: a rank's columns of a
    sharded chip). A fake key outside a counted run (a dry run's set-up)
    runs no threefry (:func:`_emulated`)."""
    n = math.prod(shape)
    if build.is_fake(key) and not cost.counting():  # a dry run's set-up: no threefry
        return values(torch.empty(n, dtype=torch.int64, device=key.device)).reshape(shape)
    row = _row(shape, stride)
    return _sliced(n, build.on_card(key), lambda start, stop: values(
        _flat_bits(key, start, stop, row, offset))).reshape(shape)


# ---------------------------------------------------------------------------
# Exact f32 arithmetic
# ---------------------------------------------------------------------------


def fma(a: Tensor, b: Tensor, c) -> Tensor:
    """f32 ``a * b + c`` with one rounding, as a fused multiply-add gives it.

    The product of two f32 values is exact in f64; their sum with ``c`` is
    rounded to f64 and then to f32, so it is first made round-to-odd (the
    f64 sum's error is recovered exactly by TwoSum): a round-to-odd f64
    value rounds to the nearest f32 exactly as the exact sum does. Large
    CPU operands go slice by slice, as a CPU draw does, and so do operands
    of more than ``_CARD_SLICE`` values on a card (a 1 B-weight lm_head's
    f64 temporaries would take tens of GB at once). See :func:`_emulated`
    for fake operands.
    """
    return _emulated("fma", (a, b, c), torch.float32, 1, lambda: _fma_routed(a, b, c))


def _fma_routed(a: Tensor, b: Tensor, c) -> Tensor:
    if not build.on_card(a):
        if max(a.numel(), b.numel()) <= _CPU_SLICE:
            return _fma(a, b, c)
        c = c if isinstance(c, Tensor) else torch.tensor(_f32(c), dtype=torch.float32)
        a, b, c = torch.broadcast_tensors(a, b, c)
        flat = [t.reshape(-1) for t in (a, b, c)]
        return _sliced(a.numel(), False,
                       lambda start, stop: _fma(*(t[start:stop] for t in flat))).reshape(a.shape)
    if max(a.numel(), b.numel()) <= _CARD_SLICE:
        return _fma(a, b, c)
    return _fma_slices(a, b, c, _CARD_SLICE)


def _fma_slices(a: Tensor, b: Tensor, c, size: int) -> Tensor:
    """:func:`_fma` over slices of ``size`` values, written into one f32
    buffer on ``a``'s device: bitwise one pass (each value is its own)."""
    c = c if isinstance(c, Tensor) else torch.tensor(_f32(c), dtype=torch.float32,
                                                     device=a.device)
    a, b, c = torch.broadcast_tensors(a, b, c)
    flat = [t.reshape(-1) for t in (a, b, c)]
    out = torch.empty(a.numel(), dtype=torch.float32, device=a.device)
    for start in range(0, a.numel(), size):
        stop = min(start + size, a.numel())
        out[start:stop] = _fma(*(t[start:stop] for t in flat))
    return out.reshape(a.shape)


def _fma(a: Tensor, b: Tensor, c) -> Tensor:
    a64, b64 = a.double(), b.double()
    c64 = c.double() if isinstance(c, Tensor) else torch.tensor(
        float(torch.tensor(c, dtype=torch.float32)), dtype=torch.float64,
        device=a.device)
    p = a64 * b64
    s = p + c64
    bp = s - c64
    err = (p - bp) + (c64 - (s - bp))
    sb = s.view(torch.int64)
    even = (sb & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    away = (err > 0) == (s > 0)  # the exact sum lies farther from zero
    sb = torch.where(fix, torch.where(away, sb + 1, sb - 1), sb)
    return sb.view(torch.float64).float()


def _f32(x: float) -> float:
    """The f32 value nearest ``x`` (a Python float), as XLA folds a literal
    (on the host: no tensor op, so a counted run dispatches none)."""
    return float(np.float32(x))


def sqrt(x: Tensor) -> Tensor:
    """Correctly rounded f32 square root (torch's CPU f32 ``sqrt`` is not
    always; the f64 root rounds to the same f32 as the exact one)."""
    return torch.sqrt(x.double()).float()


def _horner(x: Tensor, p: Tensor, coeffs: Sequence[float]) -> Tensor:
    """Horner evaluation from ``p`` with one FMA per step: ((p x + c1) x + c2) ..."""
    for c in coeffs:
        p = fma(p, x, c)
    return p


# XLA-CPU's f32 log (Eigen's plog_float): frexp, then a degree-8 polynomial
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524
_MIN_NORMAL = 1.1754943508222875e-38


def log(x: Tensor) -> Tensor:
    """XLA-CPU's f32 natural log (its ``plog``), for ``x`` an f32 tensor."""
    x = x.float()
    xc = torch.maximum(x, torch.full_like(x, _MIN_NORMAL))
    xb = xc.view(torch.int32)
    m = ((xb & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    e = ((xb >> 23) - 127).float() + 1.0
    small = m < _f32(_SQRTHF)
    e = e - small.float()
    y = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = y * y
    x3 = x2 * y
    p0 = fma(fma(y, torch.full_like(y, _f32(_LOG_P[0])), _LOG_P[1]), y, _LOG_P[2])
    p1 = fma(fma(y, torch.full_like(y, _f32(_LOG_P[3])), _LOG_P[4]), y, _LOG_P[5])
    p2 = fma(fma(y, torch.full_like(y, _f32(_LOG_P[6])), _LOG_P[7]), y, _LOG_P[8])
    p = fma(p0, x3, p1)
    p = fma(p, x3, p2)
    p = fma(p, x3, e * _f32(_LOG_Q1))
    r = fma(x2, torch.full_like(y, -0.5), y)
    r = fma(e, torch.full_like(e, _LOG_Q2), r + p)
    inf = torch.full_like(x, math.inf)
    r = torch.where(x == math.inf, inf, r)
    r = torch.where(x == 0, -inf, r)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(x, math.nan), r)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p(x: Tensor) -> Tensor:
    """XLA-CPU's f32 ``log1p``: a Cephes rational for |x| < sqrt(2) - 1,
    else :func:`log` of ``x + 1``."""
    x = x.float()
    x2 = x * x
    zero = x * 0.0
    num = _horner(x, zero + _f32(_LOG1P_NUM[0]), _LOG1P_NUM[1:])
    den = _horner(x, zero + 1.0, _LOG1P_DEN[1:])
    # x2 * -0.5 is exact, so the sum rounds once whichever product the
    # compiler fuses into it
    small = x + ((x * x2) * (num / den) + x2 * -0.5)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, log(x + 1.0))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: Tensor) -> Tensor:
    """XLA's f32 ``erf_inv`` (Giles' single-precision approximation)."""
    x = x.float()
    w = -log1p(x * -x)
    lt = w < 5.0
    z = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    coeff = lambda i: torch.where(
        lt, torch.full_like(x, _f32(_ERFINV_LT5[i])),
        torch.full_like(x, _f32(_ERFINV_GE5[i])))
    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, z, coeff(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


def _uniform_of(b: Tensor, minval, maxval) -> Tensor:
    """Uniform floats on [minval, maxval) from bits: 23 random mantissa bits
    under exponent 0 give [0, 1), then one f32 FMA."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=b.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=b.device)
    return torch.maximum(lo, fma(f, (hi - lo).expand(f.shape), lo))


def uniform(key: Tensor, shape: Shape = (), minval=0.0, maxval=1.0, offset: int = 0,
            stride: Optional[int] = None) -> Tensor:
    """``jax.random.uniform`` (float32) on [minval, maxval); ``offset`` and
    ``stride`` take a slice of a wider draw, as :func:`normal`'s do."""
    return _draw(key, _shape(shape), lambda b: _uniform_of(b, minval, maxval), offset, stride)


def bernoulli(key: Tensor, p: float = 0.5, shape: Shape = (), offset: int = 0,
              stride: Optional[int] = None) -> Tensor:
    """``jax.random.bernoulli`` (bool): ``uniform(key, shape) < p`` in f32,
    as JAX draws it (mode ``'low'``); ``offset`` and ``stride`` take a slice
    of a wider draw, as :func:`normal`'s do (a data-parallel rank's rows of
    a quant-noise mask, a tensor-parallel rank's columns or tiles)."""
    return _draw(key, _shape(shape), lambda b: _uniform_of(b, 0.0, 1.0) < _f32(p), offset,
                 stride)


_NORMAL_LO = -0.99999994  # np.nextafter(-1, 0) in f32


#: sqrt(2) in f32: ``normal`` is ``erf_inv(u) * SQRT2``
SQRT2 = _f32(math.sqrt(2))


#: launches of the card's normal-draw kernel (``csrc/prng.cu``) since
#: process start
launches = 0
_FN = None


def _normal_kernel(key: Tensor, shape: tuple, scaled: bool, offset: int = 0,
                   stride: Optional[int] = None) -> Tensor:
    """A draw on the card by ``csrc/prng.cu``: the same operations as the
    plain version below, bit for bit."""
    global _FN
    import ctypes

    with build.LOCK:
        if _FN is None:
            lib = build.load("prng")
            lib.prng_normal.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p]
            lib.prng_normal.restype = ctypes.c_int
            lib.prng_normal_strided.argtypes = [
                ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_void_p]
            lib.prng_normal_strided.restype = ctypes.c_int
            lib.prng_error_string.argtypes = [ctypes.c_int]
            lib.prng_error_string.restype = ctypes.c_char_p
            _FN = lib
    k1, k2 = (int(v) for v in _check_key(key))
    out = torch.empty(shape, dtype=torch.float32, device=key.device)
    row = _row(shape, stride) or (max(out.numel(), 1),) * 2
    with torch.cuda.device(key.device):
        rc = _FN.prng_normal_strided(k1, k2, out.data_ptr(), offset, out.numel(), int(scaled),
                                     row[0], row[1], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"prng normal kernel launch failed: {_FN.prng_error_string(rc).decode()}")
    build.bump(sys.modules[__name__], "launches")
    return out


def normal_erf_inv(key: Tensor, shape: Shape = (), offset: int = 0,
                   stride: Optional[int] = None) -> Tensor:
    """``erf_inv(u)`` of :func:`normal`'s draw, before the ``* SQRT2``: where
    the reference multiplies a normal by a constant, its compiler folds the
    two constants into one factor."""
    return _draw_unit(key, _shape(shape), lambda: _normal_kernel(
        key, _shape(shape), scaled=False, offset=offset, stride=stride) if build.on_card(key)
        else _draw(key, _shape(shape), lambda b: erf_inv(_uniform_of(b, _NORMAL_LO, 1.0)),
                   offset, stride))


def normal(key: Tensor, shape: Shape = (), offset: int = 0,
           stride: Optional[int] = None) -> Tensor:
    """``jax.random.normal`` (float32): sqrt(2) * erf_inv(u), u uniform on
    (-1, 1). A key on a card draws with the kernel ``csrc/prng.cu``; a key
    on the CPU with the plain version (the same operations in PyTorch).

    ``offset``: the draw's flat counters start there -- rows ``r0:r1`` of
    an (R, C) draw are ``normal(key, (r1 - r0, C), offset=r0 * C)``, bit
    for bit (a value depends only on its counter). ``stride``: row ``r``
    starts at counter ``offset + r * stride`` -- columns ``c0:c1`` of rows
    ``r0:r1`` are ``normal(key, (r1 - r0, c1 - c0), offset=r0 * C + c0,
    stride=C)``."""
    return _draw_unit(key, _shape(shape), lambda: _normal_kernel(
        key, _shape(shape), scaled=True, offset=offset, stride=stride) if build.on_card(key)
        else normal_erf_inv(key, shape, offset, stride) * SQRT2)


def _draw_unit(key: Tensor, shape: tuple, fn) -> Tensor:
    """A normal draw as one unit of ``analysis.cost``'s count (no FLOPs;
    the key read, the draw written), whichever route makes it. A fake key
    (a dry run) gets the draw's output on either route: no threefry, no
    launch."""
    if build.is_fake(key):
        fn = lambda: torch.empty(shape, dtype=torch.float32, device=key.device)  # noqa: E731
    return cost.unit("prng.normal", 0, (key,), fn)


def exponential(key: Tensor, shape: Shape = ()) -> Tensor:
    """``jax.random.exponential`` (float32): -log1p(-u), u uniform on [0, 1)."""
    return -log1p(-uniform(key, shape))


def randint(key: Tensor, shape: Shape, minval: int, maxval: int) -> Tensor:
    """``jax.random.randint`` (int32) on [minval, maxval): two 32-bit draws
    folded modulo the span, as the reference does."""
    shape = _shape(shape)
    lo, hi = int(minval), int(maxval)
    if not (-(2**31) <= lo < 2**31 and -(2**31) <= hi <= 2**31):
        raise ValueError(f"randint bounds must fit in int32: [{lo}, {hi})")
    out_of_range = hi > 2**31 - 1
    hi_c = min(hi, 2**31 - 1)
    span = (hi_c - lo) & _M32 if hi_c > lo else 1
    if out_of_range and hi_c > lo:
        span = (span + 1) & _M32
    k = split(key)
    higher, lower = bits(k[0], shape), bits(k[1], shape)
    if span == 0:  # the full 2^32 range: the remainders are the bits
        off = lower
    else:
        mult = (((2**16 % span) ** 2) & _M32) % span  # uint32 products wrap
        off = _u32(_u32((higher % span) * mult) + lower % span) % span
    return _u32(off + lo).to(torch.int32)


def choice(key: Tensor, a, shape: Shape = ()) -> Tensor:
    """``jax.random.choice`` with replacement and uniform weights: ``shape``
    draws from the 1-D ``a`` (or from ``range(a)`` for an int)."""
    shape = _shape(shape)
    if isinstance(a, int):
        return randint(key, shape, 0, a)
    arr = torch.as_tensor(a, device=key.device)
    if arr.dim() != 1 or arr.shape[0] < 1:
        raise ValueError("choice draws from a non-empty 1-D array")
    idx = randint(key, shape, 0, int(arr.shape[0]))
    return arr[idx.long()]


# ---------------------------------------------------------------------------
# glibc's powf
# ---------------------------------------------------------------------------

# __powf_log2_data: 16 (1/c, log2 c) pairs and the log2(1+r) polynomial
_POWF_LOG2 = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010bp+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8eap+0", "-0x1.97c1d1b3b7afp-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1p+0", "0x0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aap-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
)
_POWF_POLY = ("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2",
              "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
              "0x1.71547652ab82bp+0")
# __exp2f_data (N = 32): tab[i] = bits(2^(i/32)) - (i << 52) / 32
_EXP2F_N = 32
_EXP2F_POLY = ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
               "0x1.62e42ff0c52d6p-1")
_EXP2F_SHIFT = float.fromhex("0x1.8p+52") / _EXP2F_N


@functools.lru_cache(maxsize=None)
def _exp2f_tab() -> tuple:
    from decimal import Decimal, getcontext

    getcontext().prec = 50
    out = []
    for i in range(_EXP2F_N):
        v = float(Decimal(2) ** (Decimal(i) / _EXP2F_N))
        u = struct.unpack("<q", struct.pack("<d", v))[0]  # the f64's bits
        out.append(u - ((i << 52) // _EXP2F_N))
    return tuple(out)


_TABLES: dict = {}


def _powf_tables(like: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The tables on ``like``'s device, kept per device; a fake ``like``'s
    (a dry run's trace) are made anew and never kept, so no real call meets
    a fake table and no trace a real one."""
    dev, fake = like.device, build.is_fake(like)
    if fake or dev not in _TABLES:
        f = lambda s: float.fromhex(s)
        tables = (
            torch.tensor([f(a) for a, _ in _POWF_LOG2], dtype=torch.float64, device=dev),
            torch.tensor([f(b) for _, b in _POWF_LOG2], dtype=torch.float64, device=dev),
            torch.tensor(_exp2f_tab(), dtype=torch.int64, device=dev),
        )
        if fake:
            return tables
        _TABLES[dev] = tables
    return _TABLES[dev]


def powf(x: Tensor, y: Tensor) -> Tensor:
    """glibc's ``powf`` (:func:`_powf`, :func:`_emulated`)."""
    return _emulated("powf", (x, y), torch.float32, 1, lambda: _powf(x, y))


def _powf(x: Tensor, y: Tensor) -> Tensor:
    """glibc's ``powf(x, y)`` for finite ``x > 0`` (normal) and finite ``y``,
    broadcast together: log2(x) in double from a 16-entry table and a
    degree-5 polynomial, times y, then exp2 from a 32-entry table and a
    degree-3 polynomial, rounded once to f32. ``y == 0`` gives 1; a lane
    outside the domain (or with |y log2 x| >= 126) gives NaN."""
    x, y = torch.broadcast_tensors(x.float(), y.float())
    # outside its domain a lane gives NaN (a check on the host would read
    # the device every call)
    bad = (x <= 0) | ~torch.isfinite(x) | (x < _MIN_NORMAL)
    invc_t, logc_t, exp_t = _powf_tables(x)
    ix = x.contiguous().view(torch.int32).to(torch.int64)
    tmp = ix - 0x3F330000
    i = (tmp >> 19) % 16
    top = tmp & 0xFF800000
    iz = ix - top
    k = (top - ((top & 0x80000000) << 1)) >> 23  # arithmetic shift of int32
    z = iz.to(torch.int32).view(torch.float32).double()
    r = z * invc_t[i] - 1.0
    y0 = logc_t[i] + k.double()
    a = [float.fromhex(s) for s in _POWF_POLY]
    r2 = r * r
    yy = a[0] * r + a[1]
    p = a[2] * r + a[3]
    r4 = r2 * r2
    q = a[4] * r + y0
    q = p * r2 + q
    logx = yy * r4 + q
    ylogx = y.double() * logx
    bad = bad | (ylogx.abs() >= 126.0)
    kd = ylogx + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - _EXP2F_SHIFT
    rr = ylogx - kd
    t = exp_t[ki % _EXP2F_N] + (ki << (52 - 5))
    s = t.view(torch.float64)
    c = [float.fromhex(v) for v in _EXP2F_POLY]
    zz = c[0] * rr + c[1]
    rr2 = rr * rr
    yv = c[2] * rr + 1.0
    yv = zz * rr2 + yv
    out = (yv * s).float()
    out = torch.where(y == 0, torch.ones_like(out), out)
    return torch.where(bad, torch.full_like(out, math.nan), out)
