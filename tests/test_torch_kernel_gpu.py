"""The Hopper analog-MVM kernel against its plain version, on the card.

Marked ``gpu``: each test skips on a host without a CUDA device (the kernel
has no interpret mode). On the card: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_kernel_gpu.py``. This file imports only the port, so it
runs where JAX is not installed.

Tolerance: ``tests/test_kernels.py``'s model (max |diff| <= 1.01 * step *
n_tiles, < 1% of elements more than half a step off), plus one bf16 ulp of
|y| in bf16 for the output rounding.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.gpu

SHAPES = [(8, 1024, 512), (16, 2048, 512), (4, 4096, 256), (7, 1000, 130),
          (1, 512, 64), (3, 5632, 2048)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(y_k, y_p, step, n_tiles, bf16):
    yk, yp = y_k.float(), y_p.float()
    d = (yk - yp).abs()
    ulp = torch.exp2(torch.floor(torch.log2(yp.abs().clamp(min=1e-30))) - 7) if bf16 else 0.0
    assert bool((d <= 1.01 * step * n_tiles + ulp).all())
    assert float((d > 0.5 * step + ulp).float().mean()) < 0.01


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_tile,dac", [(True, True), (True, False), (False, True)])
def test_kernel_matches_plain(cuda, m, k, n, dtype, bits, per_tile, dac):
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_ref

    gen = torch.Generator("cuda").manual_seed(m * k + n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=cuda) * k**-0.5).to(dtype)
    r_adc, r_dac = torch.tensor(2.0, device=cuda), torch.tensor(4.0, device=cuda)
    launches = kernel.analog_mvm.launches
    y_k = kernel.analog_mvm(x, w, r_adc=r_adc, r_dac=r_dac if dac else None,
                            out_scale=0.9, b_adc=bits, per_tile_adc=per_tile)
    torch.cuda.synchronize()
    assert kernel.analog_mvm.launches == launches + 1
    y_p = analog_mvm_ref(x, w, r_dac, r_adc, 0.9, b_dac=bits + 1, b_adc=bits,
                         per_tile_adc=per_tile, apply_dac=dac)
    assert y_k.dtype == dtype and y_k.shape == (m, n)
    step = (2.0 + 1e-9) / (2 ** (bits - 1) - 1) * 0.9
    _check(y_k, y_p, step, math.ceil(k / 1024) if per_tile else 1, dtype == torch.bfloat16)


def test_execute_mvm_launches_the_kernel_on_cuda(cuda):
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_mvm as kernel

    x = torch.randn((5, 96), device=cuda)
    w = torch.randn((96, 40), device=cuda) * 0.1
    plan = engine.plan_for(AnalogConfig(tile_rows=32), 96, 40, 6)
    before = (kernel.analog_mvm.launches, engine.tile_matmul_quant.calls)
    y = engine.execute_mvm(x, w, torch.tensor(0.7, device=cuda), plan)
    assert (kernel.analog_mvm.launches, engine.tile_matmul_quant.calls) == (
        before[0] + 1, before[1])
    y_p = engine.execute_mvm_plain(x, w, torch.tensor(0.7, device=cuda), plan)
    _check(y, y_p, (0.7 + 1e-9) / 31, 3, False)


def test_kernel_wrapper_refuses_bad_inputs(cuda):
    from repro_torch.kernels import analog_mvm as kernel

    x = torch.randn((4, 64), device=cuda)
    w = torch.randn((64, 32), device=cuda)
    with pytest.raises(TypeError):
        kernel.analog_mvm(x.half(), w.half(), r_adc=1.0)
    with pytest.raises(ValueError):
        kernel.analog_mvm(x, w.t(), r_adc=1.0)  # non-contiguous, wrong K
    with pytest.raises(ValueError):
        kernel.analog_mvm(x[:, :32], w, r_adc=1.0)
