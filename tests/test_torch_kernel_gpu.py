"""The Hopper analog-MVM kernels against their plain version, on the card:
the design ``analog_mvm`` picks for each case (the bf16 cases without the
DAC at M <= 16 run the tensor-core decode design, fp32 the tiled design),
the tensor-core prefill design at prefill shapes, its rows bitwise across
M, padding and design, and its training form (a quant-noise keep mask in
its epilogue): an all-ones mask bitwise the launch without one, all-zeros
and p = 0.5 masks within the model, the split-K path included.

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


#: prefill shapes of the tensor-core design: (M, K, N), M >= 128, a ragged
#: M, a ragged last crossbar tile (K = 5632) and an N off the 64-column tile
PREFILL_SHAPES = [(128, 2048, 2048), (256, 5632, 2048), (200, 2048, 256),
                  (131, 1024, 520), (256, 2048, 5632)]


@pytest.mark.parametrize("m,k,n", PREFILL_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_tile", [True, False])
def test_prefill_design_matches_plain(cuda, m, k, n, bits, per_tile):
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_ref

    gen = torch.Generator("cuda").manual_seed(m * k + n + bits)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((k, n), generator=gen, device=cuda) * k**-0.5).bfloat16()
    r_adc = torch.tensor(2.0, device=cuda)
    assert kernel.select_design(x.dtype, m, k, n, per_tile_adc=per_tile) == "prefill"
    before = kernel.analog_mvm.design_launches["prefill"]
    y_k = kernel.analog_mvm(x, w, r_adc=r_adc, out_scale=0.9, b_adc=bits,
                            per_tile_adc=per_tile)
    torch.cuda.synchronize()
    assert kernel.analog_mvm.design_launches["prefill"] == before + 1
    y_p = analog_mvm_ref(x, w, None, r_adc, 0.9, b_adc=bits, per_tile_adc=per_tile,
                         apply_dac=False)
    assert y_k.dtype == torch.bfloat16 and y_k.shape == (m, n)
    step = (2.0 + 1e-9) / (2 ** (bits - 1) - 1) * 0.9
    _check(y_k, y_p, step, math.ceil(k / 1024) if per_tile else 1, True)


@pytest.mark.parametrize("k,n", [(2048, 256), (5632, 2048), (2048, 5632), (1000, 520)])
def test_rows_bitwise_independent_of_m_and_design(cuda, k, n):
    """A row's bits depend neither on M, nor on the padding rows beside it,
    nor on which tensor-core design ran it."""
    from repro_torch.kernels import analog_mvm as kernel

    gen = torch.Generator("cuda").manual_seed(k + n)
    x = torch.randn((256, k), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((k, n), generator=gen, device=cuda) * k**-0.5).bfloat16()
    kw = dict(r_adc=torch.tensor(2.0, device=cuda), out_scale=0.9, b_adc=8)
    full = kernel.analog_mvm(x, w, **kw)  # the prefill design
    for rows in (1, 8, 16, 100, 129):  # alone: the decode design up to 16 rows
        padded = torch.cat([x[:rows], 100 * torch.randn((300 - rows, k), generator=gen,
                                                        device=cuda).bfloat16()])
        assert torch.equal(kernel.analog_mvm(x[:rows].contiguous(), w, **kw), full[:rows]), rows
        assert torch.equal(kernel.analog_mvm(padded, w, **kw)[:rows], full[:rows]), rows


def test_design_selection_and_refusals(cuda):
    from repro_torch.kernels import analog_mvm as kernel

    x = torch.randn((32, 64), device=cuda).bfloat16()
    w = torch.randn((64, 40), device=cuda).bfloat16()
    before = dict(kernel.analog_mvm.design_launches)
    kernel.analog_mvm(x[:16].contiguous(), w, r_adc=1.0)
    kernel.analog_mvm(x, w, r_adc=1.0)
    kernel.analog_mvm(x, w, r_adc=1.0, r_dac=2.0)
    kernel.analog_mvm(x.float(), w.float(), r_adc=1.0)
    after = dict(kernel.analog_mvm.design_launches)
    assert {d: after[d] - before[d] for d in after} == {"decode": 1, "prefill": 1, "gemv": 1,
                                                       "tiled": 1}
    with pytest.raises(ValueError, match="design"):
        kernel._launch("decode", x, w, r_adc=1.0)  # M = 32 > 16
    with pytest.raises(ValueError, match="design"):
        kernel._launch("prefill", x.float(), w.float(), r_adc=1.0)
    with pytest.raises(ValueError, match="design"):
        kernel._launch("tiled", x, w, r_adc=1.0)  # bf16
    keep = torch.ones((16, 1, 40), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="design"):
        kernel._launch("decode", x[:16].contiguous(), w, r_adc=1.0, keep=keep)
    assert kernel.analog_mvm.design_launches == after


@pytest.mark.parametrize("m,k,n", [(8, 5632, 2048), (256, 5632, 2048)])
def test_split_designs_on_overlapping_streams(cuda, m, k, n):
    """Split calls running at once on two streams give the bits of the same
    calls one after the other: each call sums its partials through its own
    arrival flags."""
    from repro_torch.kernels import analog_mvm as kernel

    gen = torch.Generator("cuda").manual_seed(m + k)
    xs = [torch.randn((m, k), generator=gen, device=cuda).bfloat16() for _ in range(2)]
    w = (torch.randn((k, n), generator=gen, device=cuda) * k**-0.5).bfloat16()
    kw = dict(r_adc=torch.tensor(2.0, device=cuda), out_scale=0.9, b_adc=8)
    serial = [kernel.analog_mvm(x, w, **kw) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, (x, s) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(s):
                outs[i].append(kernel.analog_mvm(x, w, **kw))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(y, serial[i]) for y in outs[i]), i


@pytest.mark.parametrize("m,k,n", [(8, 5632, 2048), (256, 5632, 2048)])
def test_split_designs_in_cuda_graph_replays(cuda, m, k, n):
    """A split call captured in a CUDA graph (its workspace and tag fixed at
    capture) gives the eager call's bits on every replay, also with other
    split calls between the replays reusing freed workspace."""
    from repro_torch.kernels import analog_mvm as kernel

    gen = torch.Generator("cuda").manual_seed(m + n)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((k, n), generator=gen, device=cuda) * k**-0.5).bfloat16()
    kw = dict(r_adc=torch.tensor(2.0, device=cuda), out_scale=0.9, b_adc=8)
    eager = kernel.analog_mvm(x, w, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel.analog_mvm(x, w, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = kernel.analog_mvm(x, w, **kw)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, eager)
        kernel.analog_mvm(x[: m // 2 or 1].contiguous(), w, **kw)


#: the training form's prefill shapes: tinyllama-1.1b's at 64 and 512
#: tokens (split at the crossbar tiles where the output tiles are few), a
#: ragged M and an N off the 64-column tile
KEEP_SHAPES = [(64, 2048, 256), (64, 5632, 2048), (512, 2048, 5632), (512, 2048, 32000),
               (17, 2048, 2048), (131, 1024, 520), (200, 5632, 256)]


def _mask(gen, m, t, n, p, cuda):
    return (torch.rand((m, t, n), generator=gen, device=cuda) < p).to(torch.uint8)


@pytest.mark.parametrize("m,k,n", KEEP_SHAPES)
@pytest.mark.parametrize("per_tile", [True, False])
def test_prefill_all_ones_mask_is_the_serving_launch(cuda, m, k, n, per_tile):
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import n_tiles

    gen = torch.Generator("cuda").manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((k, n), generator=gen, device=cuda) * k**-0.5).bfloat16()
    ones = torch.ones((m, n_tiles(k, 1024, per_tile), n), dtype=torch.uint8, device=cuda)
    for bits in (4, 8):
        kw = dict(r_adc=torch.tensor(2.0, device=cuda), out_scale=0.9, b_adc=bits,
                  per_tile_adc=per_tile)
        assert kernel.select_design(x.dtype, m, k, n, per_tile_adc=per_tile, keep=True) == "prefill"
        before = kernel.analog_mvm.design_launches["prefill"]
        masked = kernel.analog_mvm(x, w, keep=ones, **kw)
        assert kernel.analog_mvm.design_launches["prefill"] == before + 1
        assert torch.equal(masked, kernel.analog_mvm(x, w, **kw)), bits


@pytest.mark.parametrize("m,k,n", KEEP_SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.5])
@pytest.mark.parametrize("per_tile", [True, False])
def test_prefill_keep_masks_match_the_plain_training_form(cuda, m, k, n, p, per_tile):
    """All-zeros and p = 0.5 masks against ``ref.analog_mvm_plain`` under
    phase 3's bf16 model; the split-K path (``prefill_plan(...).splits >
    1``) applies each split's own tile's mask before it writes its
    partial."""
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_plain, n_tiles

    gen = torch.Generator("cuda").manual_seed(m * n + k)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((k, n), generator=gen, device=cuda) * k**-0.5).bfloat16()
    t = n_tiles(k, 1024, per_tile)
    keep = _mask(gen, m, t, n, p, cuda)
    r_adc = torch.tensor(2.0, device=cuda)
    for bits in (4, 8):
        y_k = kernel.analog_mvm(x, w, r_adc=r_adc, out_scale=0.9, b_adc=bits,
                                per_tile_adc=per_tile, keep=keep)
        y_p = analog_mvm_plain(x, w, None, r_adc, 0.9, b_adc=bits, per_tile_adc=per_tile,
                               apply_dac=False, keep=keep)
        assert y_k.dtype == torch.bfloat16 and y_k.shape == (m, n)
        _check(y_k, y_p, (2.0 + 1e-9) / (2 ** (bits - 1) - 1) * 0.9, t, True)

