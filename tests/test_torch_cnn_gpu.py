"""The paper's CNN path on the card: B1 (``kernels/analog_mvm.py``, the
register-tiled ``tiled`` design of ``csrc/analog_mvm_f32.cu``) in the fp32
regime the CNNs give it.

Marked ``gpu``: each test skips on a host without a CUDA device (the
kernel has no CPU mode; its plain version is what the CPU runs). It imports
only the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cnn_gpu.py

* B1 against its plain version (``kernels.ref.analog_mvm_ref``) at every
  programmed-MVM shape of AnalogNet-KWS and AnalogNet-VWW at 1 and 64
  images -- tall M, K down to 9, N = 106, 12 and 2 (ragged against every
  tile) -- fp32 with TF32 off, b_adc 4/6/8, DAC both ways, with a p = 0.5
  quant-noise keep mask and without, under ``tests/test_kernels.py``'s
  tolerance model;
* a row's bits the same at M = 1, 7, 256 and 32,000 and across the tiled
  design's tile shapes (row tiles 32, 64, 128; column tiles 16-128);
* a KWS image's logits alone equal its logits in a 256-image sweep;
* above ``MAX_M`` rows the wrapper splits M over launches, each counted,
  bitwise the parts;
* a whole programmed AnalogNet-KWS forward through the kernel against the
  same forward through the plain version on the card: every layer's ADC
  outputs (fed the plain chain's input) within the tolerance model, the
  logits within 4 ADC steps of the FC, argmax equal except at a tie.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B1 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within(y, y_p, step: float, n_tiles: int = 1) -> bool:
    d = (y.double() - y_p.double()).abs()
    return (bool((d <= 1.01 * step * n_tiles).all()) and float((d > 0.5 * step).double().mean())
            < 0.01 and bool(y.isfinite().all()))


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("arch", ["analognet-kws", "analognet-vww"])
def test_b1_matches_plain_at_cnn_shapes(cuda, arch, batch):
    from repro_torch.configs import get
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_ref
    from repro_torch.models.analognet import mvm_shapes

    g = torch.Generator("cuda").manual_seed(batch)
    r_adc = torch.tensor(1.5, device=cuda)
    r_dac = torch.tensor(3.0, device=cuda)
    out_scale = torch.tensor(0.97, device=cuda)
    before = kernel.analog_mvm.design_launches["tiled"]
    cases = 0
    for name, m, k, n in mvm_shapes(get(arch), batch):
        x = torch.randn((m, k), generator=g, device=cuda)
        w = torch.randn((k, n), generator=g, device=cuda) * k**-0.5
        mask = (torch.rand((m, 1, n), generator=g, device=cuda) < 0.5).to(torch.uint8)
        for dac in (False, True):
            for keep in (None, mask):
                assert kernel.select_design(x.dtype, m, k, n, apply_dac=dac,
                                            keep=keep is not None) == "tiled"
                for bits in (4, 6, 8):
                    step = (1.5 + 1e-9) / (2 ** (bits - 1) - 1) * 0.97
                    y = kernel.analog_mvm(x, w, r_adc=r_adc, r_dac=r_dac if dac else None,
                                          out_scale=out_scale, b_adc=bits, keep=keep)
                    y_p = analog_mvm_ref(x, w, r_dac, r_adc, out_scale, b_dac=bits + 1,
                                         b_adc=bits, apply_dac=dac, keep=keep)
                    assert y.shape == (m, n) and y.dtype == torch.float32
                    assert _within(y, y_p, step, math.ceil(k / 1024)), (
                        name, m, k, n, dac, keep is not None, bits)
                    cases += 1
    assert kernel.analog_mvm.design_launches["tiled"] - before == cases


def test_rows_above_max_m_split_over_launches(cuda):
    from repro_torch.kernels import analog_mvm as kernel

    g = torch.Generator("cuda").manual_seed(1)
    m = kernel.MAX_M + 300
    x = torch.randn((m, 27), generator=g, device=cuda)
    w = torch.randn((27, 24), generator=g, device=cuda) * 27**-0.5
    kw = dict(r_adc=torch.tensor(1.5, device=cuda), b_adc=8)
    before = kernel.analog_mvm.launches
    y = kernel.analog_mvm(x, w, **kw)
    assert kernel.analog_mvm.launches - before == 2
    assert torch.equal(y[: kernel.MAX_M], kernel.analog_mvm(x[: kernel.MAX_M], w, **kw))
    assert torch.equal(y[kernel.MAX_M:], kernel.analog_mvm(x[kernel.MAX_M:].contiguous(), w, **kw))


def test_kws_forward_matches_the_plain_forward(cuda):
    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig, AnalogCtx
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.models import analognet as an

    cfg = get("analognet-kws")
    params = an.cnn_init(prng.PRNGKey(0), cfg, device=cuda)
    prog = engine.compile_program(params, AnalogConfig().infer(b_adc=8, t_seconds=25.0),
                                  prng.PRNGKey(1), transforms=an.crossbar_transforms(cfg),
                                  with_mapping=True, device=cuda)
    p = prog.params
    x = prng.normal(prng.PRNGKey(2).to(cuda), (8,) + cfg.input_hw + (cfg.in_channels,))
    step = lambda layer: (abs(float(layer["r_adc"])) + 1e-9) / 127 * float(layer["out_scale_buf"])
    ctx_k = AnalogCtx(cfg=prog.cfg, gain_s=p["gain_s"])
    ctx_p = AnalogCtx(cfg=prog.cfg, gain_s=p["gain_s"], mvm=engine.execute_mvm_plain)
    h = x
    for spec in cfg.convs:
        y_k = an.conv_apply(p[spec.name], h, spec, ctx_k, relu=False)
        y_p = an.conv_apply(p[spec.name], h, spec, ctx_p, relu=False)
        assert _within(y_k, y_p, step(p[spec.name])), spec.name
        h = torch.relu(y_p)
    before = kernel.analog_mvm.launches
    logits = an.cnn_apply(p, x, prog.cfg, cfg)
    assert kernel.analog_mvm.launches - before == len(cfg.convs) + 1
    plain = an.cnn_apply(p, x, prog.cfg, cfg, mvm=engine.execute_mvm_plain)
    d = (logits - plain).abs()
    assert logits.shape == (8, cfg.n_classes) and bool(logits.isfinite().all())
    assert float(d.max()) <= 4 * step(p["fc"])
    for row in range(8):
        a, b = int(logits[row].argmax()), int(plain[row].argmax())
        assert a == b or float(plain[row, b] - plain[row, a]) <= float(d[row].max())


@pytest.mark.parametrize("dac", [False, True])
@pytest.mark.parametrize("k,n", [(954, 106), (576, 256), (9, 106), (27, 24), (106, 12),
                                 (2048, 96)])
def test_tiled_rows_bitwise_across_m_and_tile_shapes(cuda, k, n, dac):
    """A row's bits depend on neither M (1 to 40,000 rows: the column
    tile's three row tiles) nor the column tile (a column of N = 106 again
    at N = 12, 24, 48 and 106: column tiles 16, 32, 64, 128); K = 2048
    spans two crossbar tiles."""
    from repro_torch.kernels import analog_mvm as kernel

    g = torch.Generator("cuda").manual_seed(k + n)
    x = torch.randn((40_000, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda) * k**-0.5
    kw = dict(r_adc=torch.tensor(1.5, device=cuda), out_scale=0.97, b_adc=8,
              r_dac=torch.tensor(3.0, device=cuda) if dac else None)
    full = kernel.analog_mvm(x, w, **kw)
    shapes = set()
    for rows in (1, 7, 256, 3_000, 5_000, 10_000, 20_000, 40_000):
        assert torch.equal(kernel.analog_mvm(x[:rows].contiguous(), w, **kw), full[:rows]), rows
        shapes.add(kernel.tiled_plan(rows, n).bm)
    for cols in (12, 24, 48, n):
        cols = min(cols, n)
        part = kernel.analog_mvm(x[:256].contiguous(), w[:, :cols].contiguous(), **kw)
        assert torch.equal(part, full[:256, :cols]), cols
    assert len(shapes) == 3 and shapes == set(kernel.TILED_BM[kernel.tiled_plan(1, n).bn])


def test_kws_image_alone_equals_its_row_in_a_sweep(cuda):
    """The always-on stream's single-image call and the same image inside a
    256-image sweep give the same logits, bit for bit."""
    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models import analognet as an

    cfg = get("analognet-kws")
    params = an.cnn_init(prng.PRNGKey(0), cfg, device=cuda)
    prog = engine.compile_program(params, AnalogConfig().infer(b_adc=8, t_seconds=25.0),
                                  prng.PRNGKey(1), transforms=an.crossbar_transforms(cfg),
                                  with_mapping=True, device=cuda)
    x = prng.normal(prng.PRNGKey(3).to(cuda), (256,) + cfg.input_hw + (cfg.in_channels,))
    sweep = an.cnn_apply(prog.params, x, prog.cfg, cfg)
    for i in (0, 1, 77, 255):
        alone = an.cnn_apply(prog.params, x[i:i + 1], prog.cfg, cfg)
        assert torch.equal(alone, sweep[i:i + 1]), i
