"""Wrapper of the Hopper analog-MVM kernels (``csrc/analog_mvm.cu``,
``csrc/analog_mvm_tc.cu``, ``csrc/analog_mvm_f32.cu``).

Replaces the TPU kernel ``repro/kernels/analog_mvm.py::_kernel``. Four
hand-written designs compute the one function; :func:`select_design` picks
one from the dtype, M and the options, as a choice of design (each is a
kernel, none a fallback):

* ``"decode"`` -- bf16, M <= :data:`DECODE_MAX_M`: tensor cores, split K
  into 128-row sub-chunks over several hundred blocks, fixed-order sum of
  the partials (``analog_mvm_tc.cu``; :func:`split_plan` sizes the grid);
* ``"prefill"`` -- bf16, larger M: a tensor-core tiled GEMM with the ADC at
  every crossbar boundary in its epilogue (``analog_mvm_tc.cu``;
  :func:`prefill_plan`); above :data:`DECODE_MAX_M` rows it also runs the
  bf16 training form, the quant-noise ``keep`` mask in that epilogue;
* ``"tiled"`` -- every fp32 launch (TF32 would move ADC codes), with or
  without the DAC or a ``keep`` mask: a register-tiled CUDA-core GEMM
  (``analog_mvm_f32.cu``; :func:`tiled_plan` picks the tile);
* ``"gemv"`` -- bf16 with the DAC applied in the kernel, bf16 shapes the
  tensor-core designs do not take, and the bf16 training form at
  <= :data:`DECODE_MAX_M` rows: the CUDA-core kernel of ``analog_mvm.cu``.

The two tensor-core designs share their per-element arithmetic, so a row's
bits depend neither on M nor on which of them ran; the tiled design's rows
depend on neither M nor its tile shape. The CUDA sources hold the design
notes (what they compute, their bounds, what the designs do about them);
the plain PyTorch version of the same function is
``kernels.ref.analog_mvm_ref``.

:func:`analog_mvm_bank` is the expert-bank form (a MoE layer's family):
every expert of an (E, M, K) x (E, K, N) bank in one launch of the
``decode``, ``prefill`` or ``tiled`` design, the expert the grid's z, each
expert's slice bitwise the 2-D launch on it.

:func:`analog_mvm` takes CUDA tensors only -- there is no CPU fallback here;
``kernels.ops.analog_mvm`` is the device-dispatching entry. It checks
device, dtype, shape and contiguity, allocates the output, launches on the
current stream, raises on a launch error, and adds one to
``analog_mvm.launches`` per launch (and nowhere else), so a run can show
that its path went through the kernel; ``analog_mvm.design_launches``
counts the same launches by design. On fake tensors (a dry run,
``kernels.build.is_fake``) both forms allocate the output and the
workspace a launch would, and launch and count nothing.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass
from typing import Optional, Union

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor
Scalar = Union[Tensor, float]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of x one launch takes (grid.y's limit times the CUDA-core design's
#: rows per block); analog_mvm splits larger M over launches
MAX_M = 65535 * 8
_FN = None
_TC_FN = None
_F32_FN = None
#: the four designs, by name
DESIGNS = ("gemv", "decode", "prefill", "tiled")
#: largest M the decode design takes (one 16-row mma tile)
DECODE_MAX_M = 16
#: rows of K per sub-chunk: one fp32 mma chain from zero in both
#: tensor-core designs (``kSub`` in ``csrc/analog_mvm_tc.cu``)
SUB_ROWS = 128
#: blocks both tensor-core designs aim to put in flight (two per SM of an H100)
MIN_BLOCKS = 2 * 132
#: the prefill design's output tile: rows of M, columns of N per block
PREFILL_TILE = (128, 64)
#: the tiled design's column tiles and, for each, its row tiles: 8, 4 or 2
#: rows a thread of 256, 4 columns a thread (2 at 16) (``csrc/analog_mvm_f32.cu``)
TILED_BN = (16, 32, 64, 128)
TILED_BM = {16: (256, 128, 64), 32: (256, 128, 64), 64: (128, 64, 32), 128: (64, 32, 16)}
#: streaming multiprocessors of an H100: the tiled design's grid covers them
SMS = 132
#: rows of K per staged chunk of the tiled design (``kBK``): its fp32 sum is
#: a chain per chunk, the chunks added in order
TILED_BK = 32


def _fn():
    global _FN
    with build.LOCK:
        if _FN is None:
            lib = build.load("analog_mvm")
            fn = lib.analog_mvm_launch
            fn.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                + [ctypes.c_float] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
            )
            fn.restype = ctypes.c_int
            lib.analog_mvm_error_string.argtypes = [ctypes.c_int]
            lib.analog_mvm_error_string.restype = ctypes.c_char_p
            _FN = (fn, lib.analog_mvm_error_string)
    return _FN


def _tc_fn():
    global _TC_FN
    with build.LOCK:
        if _TC_FN is None:
            lib = build.load("analog_mvm_tc")
            pre = lib.analog_mvm_tc_prefill
            dec = lib.analog_mvm_tc_decode
            common = (
                [ctypes.c_void_p] * 5 + [ctypes.c_uint64] + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
            )
            pre.argtypes = common + [ctypes.c_void_p] * 2  # keep, stream
            dec.argtypes = common + [ctypes.c_void_p]
            # the bank forms: E after the tag; then stride (floats), stream
            bank = common[:6] + [ctypes.c_int] + common[6:]
            lib.analog_mvm_tc_prefill_bank.argtypes = bank + [ctypes.c_void_p, ctypes.c_uint64,
                                                              ctypes.c_void_p]
            lib.analog_mvm_tc_decode_bank.argtypes = bank + [ctypes.c_uint64, ctypes.c_void_p]
            for fn in (pre, dec, lib.analog_mvm_tc_prefill_bank, lib.analog_mvm_tc_decode_bank):
                fn.restype = ctypes.c_int
            lib.analog_mvm_tc_error_string.argtypes = [ctypes.c_int]
            lib.analog_mvm_tc_error_string.restype = ctypes.c_char_p
            _TC_FN = (pre, dec, lib.analog_mvm_tc_error_string,
                      lib.analog_mvm_tc_prefill_bank, lib.analog_mvm_tc_decode_bank)
    return _TC_FN


def _f32_fn():
    global _F32_FN
    with build.LOCK:
        if _F32_FN is None:
            lib = build.load("analog_mvm_f32")
            fn = lib.analog_mvm_f32_launch
            fn.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                + [ctypes.c_float] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            bank = lib.analog_mvm_f32_bank_launch
            bank.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            )
            bank.restype = ctypes.c_int
            lib.analog_mvm_f32_error_string.argtypes = [ctypes.c_int]
            lib.analog_mvm_f32_error_string.restype = ctypes.c_char_p
            _F32_FN = (fn, lib.analog_mvm_f32_error_string, bank)
    return _F32_FN


def tc_shape_ok(k: int, n: int, tile_rows: int, per_tile_adc: bool) -> bool:
    """Whether the tensor-core designs take this shape: 16-byte rows of x and
    w (K and N multiples of 8) and crossbar tiles made of whole sub-chunks."""
    multi = per_tile_adc and k > tile_rows
    return k % 8 == 0 and n % 8 == 0 and not (multi and tile_rows % SUB_ROWS)


def select_design(dtype: torch.dtype, m: int, k: int, n: int, *, tile_rows: int = 1024,
                  per_tile_adc: bool = True, apply_dac: bool = False,
                  keep: bool = False) -> str:
    """The design :func:`analog_mvm` launches for these operands (see the
    module docstring): ``"tiled"`` for every fp32 launch; for bf16 without
    the DAC at shapes :func:`tc_shape_ok` takes, ``"decode"`` up to
    :data:`DECODE_MAX_M` rows and ``"prefill"`` above (a keep mask:
    ``"prefill"`` above, ``"gemv"`` up to); ``"gemv"`` otherwise."""
    if dtype == torch.float32:
        return "tiled"
    if apply_dac or not tc_shape_ok(k, n, tile_rows, per_tile_adc):
        return "gemv"
    if m <= DECODE_MAX_M:
        return "gemv" if keep else "decode"
    return "prefill"


@dataclass(frozen=True)
class SplitPlan:
    """The decode design's grid for one (M, K, N): ``warps`` of 16 columns
    per block, ``strips`` column strips x ``n_sub`` sub-chunks of K =
    ``blocks``; the fp32 partials take ``workspace_bytes``, followed in the
    call's workspace by ``flags`` 64-bit arrival flags (one per block);
    ``span`` rows of K go to each ADC conversion."""

    warps: int
    strips: int
    n_sub: int
    blocks: int
    workspace_bytes: int
    span: int

    @property
    def flags(self) -> int:
        return self.blocks

    @property
    def tile_of_sub(self) -> tuple:
        """The crossbar tile of each sub-chunk, in the order the last block
        of a strip sums them (sub-chunk 0, 1, ...; the ADC after each
        tile's last)."""
        return tuple(c * SUB_ROWS // self.span for c in range(self.n_sub))


@functools.lru_cache(maxsize=None)
def split_plan(m: int, k: int, n: int, tile_rows: int = 1024,
               per_tile_adc: bool = True) -> SplitPlan:
    """The widest strips (4, 2 or 1 warps) that still put
    :data:`MIN_BLOCKS` blocks in flight, else one warp per strip."""
    n_sub = -(-k // SUB_ROWS)
    warps = next((wp for wp in (4, 2) if -(-n // (16 * wp)) * n_sub >= MIN_BLOCKS), 1)
    strips = -(-n // (16 * warps))
    span = tile_rows if per_tile_adc and k > tile_rows else k
    return SplitPlan(warps=warps, strips=strips, n_sub=n_sub, blocks=strips * n_sub,
                     workspace_bytes=n_sub * m * n * 4, span=span)


@dataclass(frozen=True)
class PrefillPlan:
    """The prefill design's grid for one (M, K, N): ``row_tiles`` x
    ``col_tiles`` output tiles of :data:`PREFILL_TILE`, each split into
    ``splits`` blocks, one per crossbar tile of K (1: one block walks all
    of K); the quantized tile partials take ``workspace_bytes``, followed
    in the call's workspace by ``flags`` 64-bit arrival flags (one per block
    when split, else none)."""

    row_tiles: int
    col_tiles: int
    splits: int
    blocks: int
    workspace_bytes: int

    @property
    def flags(self) -> int:
        return self.blocks if self.splits > 1 else 0


@functools.lru_cache(maxsize=None)
def prefill_plan(m: int, k: int, n: int, tile_rows: int = 1024,
                 per_tile_adc: bool = True) -> PrefillPlan:
    """Split K at its crossbar tiles (each split's partial is then
    ADC-complete, summed in tile order by the last block of the output
    tile) when the output tiles alone put fewer than :data:`MIN_BLOCKS`
    blocks in flight; with one ADC conversion over all of K, never."""
    rows, cols = -(-m // PREFILL_TILE[0]), -(-n // PREFILL_TILE[1])
    multi = per_tile_adc and k > tile_rows
    splits = -(-k // tile_rows) if multi and rows * cols < MIN_BLOCKS else 1
    return PrefillPlan(row_tiles=rows, col_tiles=cols, splits=splits,
                       blocks=rows * cols * splits,
                       workspace_bytes=splits * m * n * 4 if splits > 1 else 0)


@dataclass(frozen=True)
class TiledPlan:
    """The tiled design's grid for one (M, K, N): ``row_tiles`` x
    ``col_tiles`` output tiles of ``bm`` x ``bn``, one block each, which
    walks all of K."""

    bm: int
    bn: int
    row_tiles: int
    col_tiles: int

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.col_tiles


@functools.lru_cache(maxsize=None)
def tiled_plan(m: int, n: int) -> TiledPlan:
    """The narrowest column tile of :data:`TILED_BN` that holds N (128 above
    it: several column tiles), then the tallest of its row tiles
    (:data:`TILED_BM`) that still gives every one of :data:`SMS` SMs a
    block (else the shortest). One block walks all of K, whatever its
    length."""
    bn = next((b for b in TILED_BN if b >= n), TILED_BN[-1])
    cols = -(-n // bn)
    bm = next((b for b in TILED_BM[bn] if -(-m // b) * cols >= SMS), TILED_BM[bn][-1])
    return TiledPlan(bm=bm, bn=bn, row_tiles=-(-m // bm), col_tiles=cols)


_CALLS = itertools.count(1)


def _tag() -> int:
    """A 64-bit tag, distinct for each tensor-core launch of this process
    (an odd multiplier is a bijection modulo 2^64), spread over the bits so
    that stale bytes of a reused workspace do not spell it (see
    ``last_to_finish`` in ``csrc/analog_mvm_tc.cu``)."""
    return (next(_CALLS) * 0x9E3779B97F4A7C15) & (2**64 - 1)


def workspace_words(plan) -> tuple:
    """(float32 words of the call's workspace, word offset of its flags):
    the partials, then the 64-bit arrival flags from the next 8-byte
    boundary."""
    off = -(-plan.workspace_bytes // 8) * 2
    return off + 2 * plan.flags, off


def _scalar(v: Optional[Scalar], name: str, device) -> tuple:
    """(device pointer or None, host value, tensor to keep alive)."""
    if v is None:
        return None, 0.0, None
    if isinstance(v, Tensor):
        if v.numel() != 1:
            raise ValueError(f"{name} must be a scalar, got shape {tuple(v.shape)}")
        if v.device != device:
            raise ValueError(f"{name} is on {v.device}, the operands on {device}")
        if v.dtype != torch.float32:
            v = v.float()
        return v.data_ptr(), 0.0, v
    return None, float(v), None


def analog_mvm(
    x: Tensor,
    w: Tensor,
    *,
    r_adc: Scalar,
    r_dac: Optional[Scalar] = None,
    out_scale: Scalar = 1.0,
    b_adc: int = 8,
    tile_rows: int = 1024,
    per_tile_adc: bool = True,
    keep: Optional[Tensor] = None,
) -> Tensor:
    """One programmed MVM on the card: x (M, K) x w (K, N) -> (M, N) in
    x's dtype, through the design :func:`select_design` picks. ``r_dac=None``
    skips the DAC (x already quantized, as the serving path passes it); the
    DAC has ``b_adc + 1`` bits. ``keep`` -- a bool or uint8 (M, T, N)
    quant-noise mask on x's device, T = ``ref.n_tiles(K, tile_rows,
    per_tile_adc)`` -- is the training form: each ADC'd partial is quantized
    where it is set and passes at full precision where it is not (the
    ``tiled`` design in fp32; in bf16 the ``prefill`` design above
    :data:`DECODE_MAX_M` rows, ``gemv`` up to). Above :data:`MAX_M` rows (a
    batch of CNN patches: VWW's stem past 209 images; the ``gemv`` design's
    grid.y limit, kept for every design) the rows are split over launches,
    each counted; rows are independent, so the result is bitwise one
    call's."""
    if x.dim() == 2 and x.shape[0] > MAX_M:
        return torch.cat([
            analog_mvm(x[i : i + MAX_M], w, r_adc=r_adc, r_dac=r_dac, out_scale=out_scale,
                       b_adc=b_adc, tile_rows=tile_rows, per_tile_adc=per_tile_adc,
                       keep=None if keep is None else keep[i : i + MAX_M])
            for i in range(0, x.shape[0], MAX_M)
        ])
    _check_operands(x, w, b_adc, tile_rows)
    if keep is not None:
        _check_keep(keep, x, w, tile_rows, per_tile_adc)
    design = select_design(x.dtype, x.shape[0], x.shape[1], w.shape[1], tile_rows=tile_rows,
                           per_tile_adc=per_tile_adc, apply_dac=r_dac is not None,
                           keep=keep is not None)
    return _run(design, x, w, r_adc, r_dac, out_scale, b_adc, tile_rows, per_tile_adc, keep)


def _check_keep(keep: Tensor, x: Tensor, w: Tensor, tile_rows: int, per_tile_adc: bool) -> None:
    m, k = x.shape
    t = -(-k // tile_rows) if per_tile_adc and k > tile_rows else 1
    want = (m, t, w.shape[1])
    if keep.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"analog_mvm kernel: keep must be bool or uint8, got {keep.dtype}")
    if tuple(keep.shape) != want:
        raise ValueError(f"analog_mvm kernel: keep has shape {tuple(keep.shape)}, the "
                         f"operands want {want}")
    if keep.device != x.device:
        raise ValueError(f"analog_mvm kernel: keep is on {keep.device}, the operands on "
                         f"{x.device}")
    if not keep.is_contiguous():
        raise ValueError("analog_mvm kernel needs a contiguous keep")


def _check_operands(x: Tensor, w: Tensor, b_adc: int, tile_rows: int) -> None:
    if not build.on_card(x) or w.device != x.device:
        raise ValueError(
            f"analog_mvm kernel needs x and w on one CUDA device, got "
            f"{x.device} and {w.device}"
        )
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(
            f"analog_mvm kernel takes float32 or bfloat16 x and w of one "
            f"dtype, got {x.dtype} and {w.dtype}"
        )
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"analog_mvm kernel needs x (M, K) and w (K, N), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("analog_mvm kernel needs contiguous x and w")
    m, k = x.shape
    n = w.shape[1]
    if min(m, k, n) < 1 or m > MAX_M or max(k, n) >= 2**31:
        raise ValueError(f"analog_mvm kernel: unsupported shape M={m} K={k} N={n}")
    if not 2 <= b_adc <= 16 or tile_rows < 1:
        raise ValueError(f"analog_mvm kernel: b_adc={b_adc} tile_rows={tile_rows}")


def _launch(design: str, x: Tensor, w: Tensor, *, r_adc: Scalar, r_dac: Optional[Scalar] = None,
            out_scale: Scalar = 1.0, b_adc: int = 8, tile_rows: int = 1024,
            per_tile_adc: bool = True, keep: Optional[Tensor] = None, lib=None) -> Tensor:
    """:func:`analog_mvm` through a given design, for the checks only: they
    hold a design ``select_design`` does not pick for these operands (the
    CUDA-core design on bf16 and fp32, the parent of the others) against
    the others. ``lib``: the ``gemv`` design's (launch, error string)
    functions from another build of ``analog_mvm.cu`` (a parent's, timed
    against this one); None: this build's. Refuses a design that cannot
    take the operands."""
    _check_operands(x, w, b_adc, tile_rows)
    if keep is not None:
        _check_keep(keep, x, w, tile_rows, per_tile_adc)
    m, k = x.shape
    n = w.shape[1]
    tc_ok = (x.dtype == torch.bfloat16 and r_dac is None
             and tc_shape_ok(k, n, tile_rows, per_tile_adc))
    takes = {"gemv": True, "tiled": x.dtype == torch.float32, "prefill": tc_ok,
             "decode": tc_ok and keep is None and m <= DECODE_MAX_M}
    if not takes.get(design, False):
        raise ValueError(
            f"analog_mvm kernel: design {design!r} does not take M={m} K={k} N={n} "
            f"dtype={x.dtype} tile_rows={tile_rows} dac={r_dac is not None} "
            f"keep={keep is not None}"
        )
    return _run(design, x, w, r_adc, r_dac, out_scale, b_adc, tile_rows, per_tile_adc, keep,
                lib)


def _run(design, x, w, r_adc, r_dac, out_scale, b_adc, tile_rows, per_tile_adc,
         keep=None, lib=None) -> Tensor:
    """Launch ``design`` (operands and design already checked); the one
    place that counts launches. Fake operands: :func:`_fake_launch`."""
    if build.is_fake(x):
        return _fake_launch(design, x, w, (r_dac, r_adc, out_scale), tile_rows, per_tile_adc)
    if design == "gemv":
        y = _launch_gemv(x, w, r_adc, r_dac, out_scale, b_adc, tile_rows, per_tile_adc, keep,
                         lib)
    elif design == "tiled":
        y = _launch_tiled(x, w, r_adc, r_dac, out_scale, b_adc, tile_rows, per_tile_adc, keep)
    else:
        y = _launch_tc(design, x, w, r_adc, out_scale, b_adc, tile_rows, per_tile_adc, keep)
    build.bump(analog_mvm, "launches")
    build.bump(analog_mvm, "design_launches", design)
    return y


def _f32_scalars(scalars: tuple) -> list:
    """The f32 copies ``_scalar`` makes of non-f32 scalar tensors."""
    return [v.float() for v in scalars if isinstance(v, Tensor) and v.dtype != torch.float32]


def _fake_launch(design, x, w, scalars, tile_rows, per_tile_adc, experts: int = 0) -> Tensor:
    """A launch's allocations on fake operands -- its f32 scalar copies,
    the tensor-core designs' workspace (``workspace_words``, per expert
    ``bank_workspace_words``) and the output -- with nothing launched or
    counted. ``experts``: the bank form's E (0: a 2-D call)."""
    m, k = x.shape[-2:]
    n = w.shape[-1]
    held = _f32_scalars(scalars)
    if design in ("decode", "prefill"):
        plan = (prefill_plan if design == "prefill" else split_plan)(m, k, n, tile_rows,
                                                                      per_tile_adc)
        words = bank_workspace_words(plan)[0] * experts if experts else workspace_words(plan)[0]
        held.append(torch.empty(words, dtype=torch.float32, device=x.device))
    del held  # freed after the launch was enqueued
    return torch.empty(((experts,) if experts else ()) + (m, n), dtype=x.dtype, device=x.device)


def _launch_gemv(x, w, r_adc, r_dac, out_scale, b_adc, tile_rows, per_tile_adc,
                 keep=None, lib=None) -> Tensor:
    """Launch the CUDA-core design (operands and ``keep`` already checked)
    through ``lib`` (see :func:`_launch`) or this build."""
    m, k = x.shape
    n = w.shape[1]
    rd_p, rd_h, rd_keep = _scalar(r_dac, "r_dac", x.device)
    ra_p, ra_h, ra_keep = _scalar(r_adc, "r_adc", x.device)
    os_p, os_h, os_keep = _scalar(out_scale, "out_scale", x.device)
    vec = 16 // x.element_size()
    vec_ok = int(n % vec == 0 and w.data_ptr() % 16 == 0)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn, err_str = lib or _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n, _DTYPES[x.dtype],
            rd_p, ra_p, os_p, rd_h, ra_h, os_h,
            b_adc + 1, b_adc, tile_rows, int(per_tile_adc),
            int(r_dac is not None), vec_ok,
            None if keep is None else keep.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"analog_mvm kernel launch failed: {err_str(rc).decode()} "
            f"(M={m} K={k} N={n} dtype={x.dtype})"
        )
    del rd_keep, ra_keep, os_keep  # freed after the launch was enqueued
    return y


def _launch_tiled(x, w, r_adc, r_dac, out_scale, b_adc, tile_rows, per_tile_adc,
                  keep=None) -> Tensor:
    """Launch the tiled fp32 design (operands and ``keep`` already checked)
    on :func:`tiled_plan`'s grid; it needs no workspace."""
    m, k = x.shape
    n = w.shape[1]
    rd_p, rd_h, rd_keep = _scalar(r_dac, "r_dac", x.device)
    ra_p, ra_h, ra_keep = _scalar(r_adc, "r_adc", x.device)
    os_p, os_h, os_keep = _scalar(out_scale, "out_scale", x.device)
    multi = int(per_tile_adc and k > tile_rows)
    plan = tiled_plan(m, n)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn, err_str, _ = _f32_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n, rd_p, ra_p, os_p,
            rd_h, ra_h, os_h, b_adc + 1, b_adc, tile_rows if multi else k, multi,
            int(r_dac is not None), None if keep is None else keep.data_ptr(),
            plan.bm, plan.bn, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"analog_mvm tiled kernel launch failed: {err_str(rc).decode()} "
            f"(M={m} K={k} N={n} dtype={x.dtype})"
        )
    del rd_keep, ra_keep, os_keep  # freed after the launch was enqueued
    return y


def _launch_tc(design, x, w, r_adc, out_scale, b_adc, tile_rows, per_tile_adc,
               keep=None) -> Tensor:
    """Launch a tensor-core design (operands already checked; ``keep``,
    the prefill design's training form, too). Its workspace -- the fp32
    partials, then the arrival flags, raised with this call's :func:`_tag`
    so they need no zeroing -- is the call's own: calls on different
    streams, or in different graphs, share nothing."""
    m, k = x.shape
    n = w.shape[1]
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("analog_mvm tensor-core kernels need 16-byte aligned x and w")
    ra_p, ra_h, ra_keep = _scalar(r_adc, "r_adc", x.device)
    os_p, os_h, os_keep = _scalar(out_scale, "out_scale", x.device)
    multi = int(per_tile_adc and k > tile_rows)
    span = tile_rows if multi else k
    plan = (prefill_plan if design == "prefill" else split_plan)(m, k, n, tile_rows,
                                                                  per_tile_adc)
    words, off = workspace_words(plan)
    work = torch.empty(words, dtype=torch.float32, device=x.device)
    flags, tag = work.data_ptr() + 4 * off, _tag()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    pre, dec, err_str, _, _ = _tc_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if design == "prefill":
            rc = pre(x.data_ptr(), w.data_ptr(), y.data_ptr(), work.data_ptr(), flags,
                     tag, m, k, n, ra_p, os_p, ra_h, os_h, b_adc, span, multi, plan.splits,
                     None if keep is None else keep.data_ptr(), stream)
        else:
            rc = dec(x.data_ptr(), w.data_ptr(), y.data_ptr(), work.data_ptr(), flags,
                     tag, m, k, n, ra_p, os_p, ra_h, os_h, b_adc, span, multi, plan.warps, stream)
    if rc != 0:
        raise RuntimeError(
            f"analog_mvm {design} kernel launch failed: {err_str(rc).decode()} "
            f"(M={m} K={k} N={n} dtype={x.dtype})"
        )
    del ra_keep, os_keep  # freed after the launch was enqueued
    return y


# ---------------------------------------------------------------------------
# The expert-bank form: one launch for every expert of a MoE layer's family
# ---------------------------------------------------------------------------

#: the designs the bank form runs: each expert one problem of the design
#: (grid.z), so its slice is bitwise the 2-D launch of that design on it
BANK_DESIGNS = ("decode", "prefill", "tiled")


def bank_workspace_words(plan) -> tuple:
    """(float32 words of one expert's workspace -- a 2-D call's, rounded up
    to 16 bytes --, word offset of its flags)."""
    words, off = workspace_words(plan)
    return -(-words // 4) * 4, off


def analog_mvm_bank(
    x: Tensor,
    w: Tensor,
    *,
    r_adc: Scalar,
    out_scale: Scalar = 1.0,
    b_adc: int = 8,
    tile_rows: int = 1024,
    per_tile_adc: bool = True,
    keep: Optional[Tensor] = None,
) -> Tensor:
    """B1's expert-bank form on the card: x (E, M, K) already
    DAC-quantized, w (E, K, N) -> (E, M, N) in x's dtype, in ONE launch of
    the design :func:`select_design` picks for (M, K, N) -- ``decode``,
    ``prefill`` or ``tiled`` (:data:`BANK_DESIGNS`; what would run
    ``gemv`` is refused). ``r_adc`` and ``b_adc`` are the family's;
    ``out_scale`` is a float, or a tensor of one GDC scalar or the (E,)
    experts' own; ``keep`` is the training form's (E, M, T, N) mask. Each
    expert's slice is bitwise :func:`analog_mvm` on it. Adds one to
    ``analog_mvm_bank.launches`` (and to its ``design_launches``) per
    launch, and nowhere else."""
    _check_bank(x, w, b_adc, tile_rows)
    e, m, k = x.shape
    n = w.shape[2]
    if keep is not None:
        if keep.dim() != 4 or tuple(keep.shape[:2]) != (e, m) or not keep.is_contiguous():
            raise ValueError(f"analog_mvm_bank kernel: keep must be a contiguous ({e}, {m}, "
                             f"T, {n}) mask, got {tuple(keep.shape)}")
        _check_keep(keep.reshape(e * m, *keep.shape[2:]), x.reshape(e * m, k), w[0],
                    tile_rows, per_tile_adc)
    design = select_design(x.dtype, m, k, n, tile_rows=tile_rows, per_tile_adc=per_tile_adc,
                           keep=keep is not None)
    if design not in BANK_DESIGNS:
        raise ValueError(
            f"analog_mvm_bank kernel: the bank form runs {BANK_DESIGNS}, and these operands "
            f"(M={m} K={k} N={n} dtype={x.dtype} keep={keep is not None}) want {design!r}"
        )
    if isinstance(out_scale, Tensor):
        if out_scale.device != x.device:
            raise ValueError(f"out_scale is on {out_scale.device}, the operands on {x.device}")
        if out_scale.numel() not in (1, e):
            raise ValueError(f"analog_mvm_bank kernel: out_scale has {out_scale.numel()} "
                             f"values for {e} experts")
        out_scale = out_scale.float().reshape(-1).expand(e).contiguous()
    if build.is_fake(x):
        return _fake_launch(design, x, w, (r_adc,), tile_rows, per_tile_adc, e)
    if design == "tiled":
        y = _launch_tiled_bank(x, w, r_adc, out_scale, b_adc, tile_rows, per_tile_adc, keep)
    else:
        y = _launch_tc_bank(design, x, w, r_adc, out_scale, b_adc, tile_rows, per_tile_adc,
                            keep)
    build.bump(analog_mvm_bank, "launches")
    build.bump(analog_mvm_bank, "design_launches", design)
    return y


def _check_bank(x: Tensor, w: Tensor, b_adc: int, tile_rows: int) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(
            f"analog_mvm_bank kernel needs x (E, M, K) and w (E, K, N), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    if x.shape[0] < 1 or x.shape[0] > 65535:
        raise ValueError(f"analog_mvm_bank kernel: {x.shape[0]} experts (1 to 65535)")
    _check_operands(x[0], w[0], b_adc, tile_rows)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("analog_mvm_bank kernel needs contiguous x and w")


def _out_scale_arg(out_scale) -> tuple:
    """(device pointer of the (E,) scalars or None, host value)."""
    if isinstance(out_scale, Tensor):
        return out_scale.data_ptr(), 0.0
    return None, float(out_scale)


def _launch_tiled_bank(x, w, r_adc, out_scale, b_adc, tile_rows, per_tile_adc, keep) -> Tensor:
    e, m, k = x.shape
    n = w.shape[2]
    ra_p, ra_h, ra_keep = _scalar(r_adc, "r_adc", x.device)
    os_p, os_h = _out_scale_arg(out_scale)
    multi = int(per_tile_adc and k > tile_rows)
    plan = tiled_plan(m, n)
    y = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    _, err_str, fn = _f32_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), e, m, k, n, ra_p, os_p, ra_h, os_h,
                b_adc, tile_rows if multi else k, multi,
                None if keep is None else keep.data_ptr(), plan.bm, plan.bn, stream)
    if rc != 0:
        raise RuntimeError(
            f"analog_mvm_bank tiled kernel launch failed: {err_str(rc).decode()} "
            f"(E={e} M={m} K={k} N={n} dtype={x.dtype})"
        )
    del ra_keep, out_scale  # freed after the launch was enqueued
    return y


def _launch_tc_bank(design, x, w, r_adc, out_scale, b_adc, tile_rows, per_tile_adc,
                    keep) -> Tensor:
    """One launch of a tensor-core design over every expert: expert e gets
    the 2-D call's plan and workspace at ``e * stride`` (its partials, then
    its flags), raised with one tag (:func:`_tag`)."""
    e, m, k = x.shape
    n = w.shape[2]
    if x.data_ptr() % 16 or w.data_ptr() % 16 or (m * k) % 8 or (k * n) % 8:
        raise ValueError("analog_mvm tensor-core kernels need 16-byte aligned x and w")
    ra_p, ra_h, ra_keep = _scalar(r_adc, "r_adc", x.device)
    os_p, os_h = _out_scale_arg(out_scale)
    multi = int(per_tile_adc and k > tile_rows)
    span = tile_rows if multi else k
    plan = (prefill_plan if design == "prefill" else split_plan)(m, k, n, tile_rows,
                                                                  per_tile_adc)
    stride, off = bank_workspace_words(plan)
    work = torch.empty(e * stride, dtype=torch.float32, device=x.device)
    flags, tag = work.data_ptr() + 4 * off, _tag()
    y = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    _, _, err_str, pre, dec = _tc_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if design == "prefill":
            rc = pre(x.data_ptr(), w.data_ptr(), y.data_ptr(), work.data_ptr(), flags, tag, e,
                     m, k, n, ra_p, os_p, ra_h, os_h, b_adc, span, multi, plan.splits,
                     None if keep is None else keep.data_ptr(), stride, stream)
        else:
            rc = dec(x.data_ptr(), w.data_ptr(), y.data_ptr(), work.data_ptr(), flags, tag, e,
                     m, k, n, ra_p, os_p, ra_h, os_h, b_adc, span, multi, plan.warps, stride,
                     stream)
    if rc != 0:
        raise RuntimeError(
            f"analog_mvm_bank {design} kernel launch failed: {err_str(rc).decode()} "
            f"(E={e} M={m} K={k} N={n} dtype={x.dtype})"
        )
    del ra_keep, out_scale  # freed after the launch was enqueued
    return y


#: kernel launches since process start (see module docstring)
analog_mvm.launches = 0
#: the same launches by design
analog_mvm.design_launches = dict.fromkeys(DESIGNS, 0)
#: the bank form's launches since process start, and by design
analog_mvm_bank.launches = 0
analog_mvm_bank.design_launches = dict.fromkeys(BANK_DESIGNS, 0)
