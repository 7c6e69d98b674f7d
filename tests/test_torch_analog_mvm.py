"""Port parity: the analog MVM's plain versions against the reference.

The port's ``kernels.ops.analog_mvm`` on a CPU tensor runs its plain version
(``kernels.ref.analog_mvm_ref``), and ``core.engine.tile_matmul_quant`` is the
engine-level one. They are held against the reference's Pallas kernel in
interpret mode, its ``kernels/ref.py`` and its ``engine.tile_matmul_quant``.

Tolerance: ``tests/test_kernels.py``'s model -- max |diff| <= 1.01 * step *
n_tiles in fp32 (2 * step * n_tiles in bf16), and fewer than 1% (fp32) or
15% (bf16: the reference kernel sums tile partials without the serving
path's bf16 rounding) of elements more than half a step off. Against the
reference ``tile_matmul_quant`` in fp32 -- the same semantics, different
matmul summation order -- the ADC codes are identical on >= 99% of
elements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.quant import QuantSpec as JSpec
from repro.kernels.ops import analog_mvm as j_analog_mvm
from repro.kernels.ref import analog_mvm_ref as j_ref
from repro_torch.core import engine as tengine
from repro_torch.core.quant import QuantSpec as TSpec
from repro_torch.kernels import analog_mvm as kernel
from repro_torch.kernels.ops import analog_mvm as t_analog_mvm
from repro_torch.kernels.ref import analog_mvm_ref as t_ref

SHAPES = [
    (8, 1024, 512),
    (16, 2048, 512),
    (4, 4096, 256),
    (7, 1000, 130),
    (1, 512, 64),
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _make(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k**-0.5).astype(np.float32)
    return x, w


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _check(got, want, step, n_tiles, dtype):
    d = np.abs(_f32(got) - _f32(want))
    fp32 = dtype == "float32"
    assert d.max() <= step * (1.01 if fp32 else 2.0) * n_tiles, (d.max(), step)
    assert (d > step * 0.5).mean() < (0.01 if fp32 else 0.15)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 6, 4])
def test_plain_matches_pallas_kernel_and_reference(m, k, n, dtype, bits):
    x, w = _make(m, k, n)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    launches = kernel.analog_mvm.launches
    got = t_analog_mvm(
        tx, tw, r_adc=torch.tensor(2.0), r_dac=torch.tensor(4.0), bits=bits
    )
    assert got.dtype == tx.dtype and got.shape == (m, n)
    assert kernel.analog_mvm.launches == launches  # no kernel on the CPU
    y_pallas = j_analog_mvm(
        jx, jw, r_adc=jnp.float32(2.0), r_dac=jnp.float32(4.0), bits=bits,
        interpret=True,
    )
    y_ref = j_ref(jx, jw, jnp.float32(4.0), jnp.float32(2.0),
                  b_dac=bits + 1, b_adc=bits)
    step = 2.0 / (2 ** (bits - 1) - 1)
    n_tiles = -(-k // 1024)
    _check(got, y_pallas, step, n_tiles, dtype)
    _check(got, y_ref, step, n_tiles, dtype)


@pytest.mark.parametrize("per_tile", [True, False])
@pytest.mark.parametrize("tile_rows", [1024, 32])
def test_per_tile_flag_and_tile_rows(per_tile, tile_rows):
    x, w = _make(8, 2048, 256, seed=2)
    got = t_analog_mvm(
        torch.from_numpy(x), torch.from_numpy(w), r_adc=torch.tensor(1.0),
        r_dac=torch.tensor(4.0), bits=8, per_tile_adc=per_tile,
        tile_rows=tile_rows,
    )
    want = j_analog_mvm(
        jnp.asarray(x), jnp.asarray(w), r_adc=jnp.float32(1.0),
        r_dac=jnp.float32(4.0), bits=8, per_tile_adc=per_tile,
        tile_rows=tile_rows, interpret=True,
    )
    step = 1.0 / 127
    n_tiles = -(-2048 // tile_rows) if per_tile else 1
    _check(got, want, step, n_tiles, "float32")


def test_dac_skip_path():
    x, w = _make(8, 1024, 128)
    calls = t_ref.calls
    got = t_analog_mvm(torch.from_numpy(x), torch.from_numpy(w),
                       r_adc=torch.tensor(2.0), r_dac=None, bits=8)
    assert t_ref.calls == calls + 1
    want = j_analog_mvm(jnp.asarray(x), jnp.asarray(w), r_adc=jnp.float32(2.0),
                        r_dac=None, bits=8, interpret=True)
    assert np.abs(_f32(got) - _f32(want)).max() <= 2.0 / 127


def test_batched_leading_dims():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 1024)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((1024, 64)).astype(np.float32) * 0.03)
    y = t_analog_mvm(x, w, r_adc=torch.tensor(2.0), r_dac=torch.tensor(4.0))
    assert y.shape == (2, 3, 64)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("per_tile,tile_rows", [(True, 32), (True, 1024), (False, 32)])
def test_tile_matmul_quant_adc_codes_match_reference(bits, per_tile, tile_rows):
    """fp32, the serving semantics on both sides: ADC codes identical on
    >= 99% of elements (a differing code is an fp32 summation-order tie)."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 5, 130)).astype(np.float32)
    w = (rng.standard_normal((130, 96)) * 130**-0.5).astype(np.float32)
    r_adc, out_scale = np.float32(0.6), np.float32(1.07)
    want = np.asarray(jengine.tile_matmul_quant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(r_adc), JSpec(b_adc=bits),
        tile_rows, per_tile, None, jnp.asarray(out_scale),
    ))
    calls = tengine.tile_matmul_quant.calls
    got = tengine.tile_matmul_quant(
        torch.from_numpy(x), torch.from_numpy(w), torch.tensor(r_adc),
        TSpec(b_adc=bits), tile_rows, per_tile, torch.tensor(out_scale),
    ).numpy()
    assert tengine.tile_matmul_quant.calls == calls + 1
    step = (0.6 + 1e-9) / (2 ** (bits - 1) - 1) * 1.07
    codes = np.rint((got - want) / step)
    assert np.abs(got - want).max() <= 1.01 * step * -(-130 // tile_rows)
    assert (codes == 0).mean() >= 0.99


def test_execute_mvm_takes_the_plain_path_on_cpu():
    from repro_torch.core.analog import AnalogConfig

    x, w = _make(3, 96, 40, seed=5)
    plan = tengine.plan_for(AnalogConfig(tile_rows=32, use_kernel=True), 96, 40, 6)
    before = (kernel.analog_mvm.launches, tengine.tile_matmul_quant.calls)
    y = tengine.execute_mvm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.tensor(-0.9), plan, out_scale=1.0)
    assert (kernel.analog_mvm.launches, tengine.tile_matmul_quant.calls) == (
        before[0], before[1] + 1)
    # |r_adc| is what the ADC sees: a negative range quantizes like its abs
    y_abs = tengine.execute_mvm(torch.from_numpy(x), torch.from_numpy(w),
                                torch.tensor(0.9), plan)
    assert torch.equal(y, y_abs)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = _make(2, 64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.analog_mvm(torch.from_numpy(x), torch.from_numpy(w), r_adc=1.0)
