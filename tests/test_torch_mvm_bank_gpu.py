"""B1's expert-bank form on the card (``kernels.analog_mvm.analog_mvm_bank``):
one launch over every expert of an (E, M, K) x (E, K, N) bank through the
decode, prefill or tiled design, against its plain version
(``ref.analog_mvm_bank_ref``) under the ADC tolerance model, and each
expert's slice bitwise the 2-D launch of the same design on that slice (the
two share their per-element code). Shapes: phi3.5-moe's families at a
decode step of 8 slots (M = 8) and a bucketed 1 x 256 prefill (M = 32),
ragged small shapes in bf16 and fp32, and the training form's keep mask.

Marked ``gpu``: each test skips on a host without a CUDA device (the kernel
has no interpret mode). On the card: ``PYTHONPATH=src python -m pytest
--noconftest -m gpu tests/test_torch_mvm_bank_gpu.py``. This file imports
only the port, so it runs where JAX is not installed.

Tolerance: ``tests/test_kernels.py``'s model (max |diff| <= 1.01 * step *
n_tiles, < 1% of elements more than half a step off), plus one bf16 ulp of
|y| in bf16 for the output rounding; the per-expert comparison is bitwise.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.gpu

# (E, M, K, N, dtype, design)
CASES = [
    (16, 8, 4096, 6400, torch.bfloat16, "decode"),
    (16, 8, 6400, 4096, torch.bfloat16, "decode"),
    (16, 32, 4096, 6400, torch.bfloat16, "prefill"),
    (16, 32, 6400, 4096, torch.bfloat16, "prefill"),
    (4, 3, 1000, 136, torch.bfloat16, "decode"),
    (3, 200, 2048, 520, torch.bfloat16, "prefill"),
    (4, 5, 64, 128, torch.float32, "tiled"),
    (5, 37, 1500, 24, torch.float32, "tiled"),
]


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


def _bank(cuda, e, m, k, n, dtype, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((e, m, k), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((e, k, n), generator=gen, device=cuda) * k**-0.5).to(dtype)
    scales = 0.8 + 0.4 * torch.rand((e,), generator=gen, device=cuda)
    return x, w, scales


@pytest.mark.parametrize("e,m,k,n,dtype,design", CASES)
@pytest.mark.parametrize("bits", [4, 8])
def test_bank_matches_plain_and_each_expert_is_the_2d_launch(cuda, e, m, k, n, dtype, design,
                                                             bits):
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_bank_ref, n_tiles

    x, w, scales = _bank(cuda, e, m, k, n, dtype, e * m + k + n + bits)
    r_adc = torch.tensor(1.5, device=cuda)
    assert kernel.select_design(dtype, m, k, n) == design
    launches = kernel.analog_mvm_bank.launches
    by_design = kernel.analog_mvm_bank.design_launches[design]
    y = kernel.analog_mvm_bank(x, w, r_adc=r_adc, out_scale=scales, b_adc=bits)
    torch.cuda.synchronize()
    assert kernel.analog_mvm_bank.launches == launches + 1
    assert kernel.analog_mvm_bank.design_launches[design] == by_design + 1
    assert y.shape == (e, m, n) and y.dtype == dtype
    t = n_tiles(k, 1024, True)
    y_p = analog_mvm_bank_ref(x, w, r_adc, scales, b_adc=bits)
    for i in range(e):
        step = 1.5 / (2 ** (bits - 1) - 1) * float(scales[i])
        _check(y[i], y_p[i], step, t, dtype == torch.bfloat16)
        alone = kernel.analog_mvm(x[i].contiguous(), w[i].contiguous(), r_adc=r_adc,
                                  out_scale=scales[i], b_adc=bits)
        assert torch.equal(y[i], alone), f"expert {i} differs from its 2-D launch"


@pytest.mark.parametrize("e,m,k,n,dtype", [(4, 64, 2048, 512, torch.bfloat16),
                                           (3, 40, 300, 96, torch.float32)])
def test_bank_training_form_keep_mask(cuda, e, m, k, n, dtype):
    """The keep mask (E, M, T, N): all ones bitwise the launch without one;
    p = 0.5 per expert bitwise the 2-D training launch on the slice."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import n_tiles

    x, w, scales = _bank(cuda, e, m, k, n, dtype, 7 * e + m)
    r_adc = torch.tensor(1.5, device=cuda)
    t = n_tiles(k, 1024, True)
    gen = torch.Generator("cuda").manual_seed(3)
    keep = torch.rand((e, m, t, n), generator=gen, device=cuda) < 0.5
    ones = torch.ones_like(keep)
    y0 = kernel.analog_mvm_bank(x, w, r_adc=r_adc, out_scale=scales, b_adc=6)
    y1 = kernel.analog_mvm_bank(x, w, r_adc=r_adc, out_scale=scales, b_adc=6, keep=ones)
    assert torch.equal(y0, y1)
    y = kernel.analog_mvm_bank(x, w, r_adc=r_adc, out_scale=scales, b_adc=6, keep=keep)
    for i in range(e):
        alone = kernel.analog_mvm(x[i].contiguous(), w[i].contiguous(), r_adc=r_adc,
                                  out_scale=scales[i], b_adc=6, keep=keep[i].contiguous())
        assert torch.equal(y[i], alone)


def test_bank_refusals(cuda):
    from repro_torch.kernels import analog_mvm as kernel

    x, w, _ = _bank(cuda, 2, 8, 256, 64, torch.bfloat16, 0)
    r = torch.tensor(1.0, device=cuda)
    keep = torch.ones((2, 8, 1, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="bank form runs"):  # gemv's case
        kernel.analog_mvm_bank(x, w, r_adc=r, keep=keep)
    with pytest.raises(ValueError, match="x \\(E, M, K\\)"):
        kernel.analog_mvm_bank(x[0], w[0], r_adc=r)
    with pytest.raises(ValueError, match="out_scale has"):
        kernel.analog_mvm_bank(x, w, r_adc=r, out_scale=torch.ones(3, device=cuda))
    with pytest.raises(TypeError):
        kernel.analog_mvm_bank(x, w.float(), r_adc=r)
    y = kernel.analog_mvm_bank(x, w, r_adc=r, out_scale=torch.tensor(0.5, device=cuda))
    assert torch.equal(y, kernel.analog_mvm_bank(x, w, r_adc=r, out_scale=0.5))
    assert math.isfinite(float(y.float().abs().max()))
