"""Wrapper of the Hopper analog-MVM kernel (``csrc/analog_mvm.cu``).

Replaces the TPU kernel ``repro/kernels/analog_mvm.py::_kernel``. The CUDA
source holds the design note (what it computes, its bound, what the design
does about it); the plain PyTorch version of the same function is
``kernels.ref.analog_mvm_ref``.

:func:`analog_mvm` takes CUDA tensors only -- there is no CPU fallback here;
``kernels.ops.analog_mvm`` is the device-dispatching entry. It checks
device, dtype, shape and contiguity, allocates the output, launches on the
current stream, raises on a launch error, and adds one to
``analog_mvm.launches`` per launch (and nowhere else), so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor
Scalar = Union[Tensor, float]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M = 65535 * 8  # grid.y limit times the block's rows
_FN = None


def _fn():
    global _FN
    if _FN is None:
        lib = build.load("analog_mvm")
        fn = lib.analog_mvm_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
            + [ctypes.c_float] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.analog_mvm_error_string.argtypes = [ctypes.c_int]
        lib.analog_mvm_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.analog_mvm_error_string)
    return _FN


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
) -> Tensor:
    """One programmed MVM on the card: x (M, K) x w (K, N) -> (M, N) in
    x's dtype. ``r_dac=None`` skips the DAC (x already quantized, as the
    serving path passes it); the DAC has ``b_adc + 1`` bits."""
    if x.device.type != "cuda" or w.device != x.device:
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
    if min(m, k, n) < 1 or m > _MAX_M or max(k, n) >= 2**31:
        raise ValueError(f"analog_mvm kernel: unsupported shape M={m} K={k} N={n}")
    if not 2 <= b_adc <= 16 or tile_rows < 1:
        raise ValueError(f"analog_mvm kernel: b_adc={b_adc} tile_rows={tile_rows}")
    rd_p, rd_h, rd_keep = _scalar(r_dac, "r_dac", x.device)
    ra_p, ra_h, ra_keep = _scalar(r_adc, "r_adc", x.device)
    os_p, os_h, os_keep = _scalar(out_scale, "out_scale", x.device)
    vec = 16 // x.element_size()
    vec_ok = int(n % vec == 0 and w.data_ptr() % 16 == 0)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn, err_str = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n, _DTYPES[x.dtype],
            rd_p, ra_p, os_p, rd_h, ra_h, os_h,
            b_adc + 1, b_adc, tile_rows, int(per_tile_adc),
            int(r_dac is not None), vec_ok, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"analog_mvm kernel launch failed: {err_str(rc).decode()} "
            f"(M={m} K={k} N={n} dtype={x.dtype})"
        )
    del rd_keep, ra_keep, os_keep  # freed after the launch was enqueued
    analog_mvm.launches += 1
    return y


#: kernel launches since process start (see module docstring)
analog_mvm.launches = 0
