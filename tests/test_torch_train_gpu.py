"""The paper's training on the card: B1's training form (the quant-noise
``keep`` mask in the epilogue of the design ``analog_mvm`` picks: the tiled
design of ``csrc/analog_mvm_f32.cu`` in fp32) and one stage-2 step.

Marked ``gpu``: each test skips on a host without a CUDA device (the
kernel has no CPU mode). It imports only the port, so it runs where JAX is
not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_train_gpu.py

* B1 with a p = 0.5 mask against the plain training form
  (``kernels.ref.analog_mvm_ref(..., keep=...)``) on the same inputs at
  AnalogNet-KWS's training shapes and a two-tile K = 2048, b_adc 4/6/8, fp32
  with TF32 off: the kept (quantized) elements under
  ``tests/test_kernels.py``'s tolerance model, the unkept ones within 1e-5
  of max |y|; without a mask, bitwise an all-set mask; the masks drawn on
  the card bitwise the CPU bridge's; a wrong mask refused;
* one stage-2 step of AnalogNet-KWS at full width, batch 8, on the card
  (B1 forward, 5 launches) and on the CPU (the plain path) from the same
  params, batch and key: the loss within 1e-3 relative, each gradient
  leaf within 1e-2 relative L2, a range leaf (``r_adc``, ``gain_s``,
  ``w_clip_buf``: a sum with cancellation over a layer's every quantizer
  term) else within twice that leaf's distance in the control (the same
  step through the plain version on the card, which differs from the CPU
  only in its sum order); no plain forward call on the card and one
  backward recompute per layer.
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


def _check(y_k, y_p, keep, step: float, n_tiles: int) -> None:
    d = (y_k.double() - y_p.double()).abs()
    scale = float(y_p.abs().max())
    tol = 1.01 * step * n_tiles + 1e-5 * scale
    assert bool((d <= tol).all()) and bool(y_k.isfinite().all())
    assert float((d > 0.5 * step + 1e-5 * scale).double().mean()) < 0.01
    if n_tiles == 1:  # an output that was not ADC'd differs only by the sum order
        unkept = ~keep[:, 0, :]
        assert float(d[unkept].max()) <= 1e-5 * scale


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_keep_mask_launch_matches_plain_training_form(cuda, bits):
    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels.ref import analog_mvm_ref, n_tiles
    from repro_torch.models.analognet import mvm_shapes

    g = torch.Generator("cuda").manual_seed(bits)
    r_adc = torch.tensor(1.5, device=cuda)
    out_scale = torch.tensor(1.0, device=cuda)
    shapes = [(m, k, n) for _, m, k, n in mvm_shapes(get("analognet-kws"), 8)] + [(64, 2048, 96)]
    for i, (m, k, n) in enumerate(shapes):
        x = torch.randn((m, k), generator=g, device=cuda)
        w = torch.randn((k, n), generator=g, device=cuda) * k**-0.5
        t = n_tiles(k, 1024, True)
        key = prng.fold_in(prng.PRNGKey(bits), i)
        keep = prng.bernoulli(key.to(cuda), 0.5, (m, t, n))
        assert torch.equal(keep.cpu(), prng.bernoulli(key, 0.5, (m, t, n)))
        kw = dict(r_adc=r_adc, out_scale=out_scale, b_adc=bits)
        assert kernel.select_design(x.dtype, m, k, n, keep=True) == "tiled"
        before = kernel.analog_mvm.design_launches["tiled"]
        y_k = kernel.analog_mvm(x, w, keep=keep, **kw)
        assert kernel.analog_mvm.design_launches["tiled"] == before + 1
        y_p = analog_mvm_ref(x, w, None, r_adc, out_scale, b_dac=bits + 1, b_adc=bits,
                             apply_dac=False, keep=keep)
        _check(y_k, y_p, keep, (1.5 + 1e-9) / (2 ** (bits - 1) - 1), t)
        assert torch.equal(kernel.analog_mvm(x, w, **kw),
                           kernel.analog_mvm(x, w, keep=torch.ones_like(keep), **kw))


def test_wrong_masks_are_refused(cuda):
    from repro_torch.kernels import analog_mvm as kernel

    x = torch.randn((16, 2048), device=cuda)
    w = torch.randn((2048, 32), device=cuda)
    kw = dict(r_adc=torch.tensor(1.0, device=cuda), b_adc=8)
    for keep, err in [(torch.ones((16, 1, 32), dtype=torch.bool, device=cuda), ValueError),
                      (torch.ones((16, 2, 32), dtype=torch.float32, device=cuda), TypeError),
                      (torch.ones((16, 2, 32), dtype=torch.bool), ValueError),
                      (torch.ones((16, 32, 2), dtype=torch.bool, device=cuda).transpose(1, 2),
                       ValueError)]:
        with pytest.raises(err):
            kernel.analog_mvm(x, w, keep=keep, **kw)


def test_one_stage2_step_card_vs_cpu(cuda):
    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig, refresh_clip_ranges
    from repro_torch.data.pipeline import PipelineConfig, batch_at
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import ops, ref
    from repro_torch.models import analognet as an
    from repro_torch.training.loop import value_and_grad

    cfg = get("analognet-kws")
    acfg = AnalogConfig().train(eta=0.1, b_adc=8, quant_noise_p=0.5)
    pipe = PipelineConfig(kind="kws", global_batch=8, n_classes=12, input_hw=cfg.input_hw)
    b = batch_at(pipe, 0)
    # the same params on both (the clip refresh's std reduces in another
    # order on each device)
    params_cpu = refresh_clip_ranges(an.cnn_init(prng.PRNGKey(0), cfg, device="cpu"))
    out = {}
    for name, dev, mvm in (("cpu", "cpu", None), ("card", cuda, None),
                           ("control", cuda, engine.execute_mvm_plain)):
        params = tree_lib.tree_map(lambda t: t.to(dev), params_cpu)
        x = torch.as_tensor(b["x"], device=dev)
        y = torch.as_tensor(b["y"], device=dev).long()
        key = prng.fold_in(prng.PRNGKey(0).to(dev), 7)

        def loss_fn(p):
            logits = an.cnn_apply(p, x, acfg, cfg, rng=key, mvm=mvm).float()
            return -torch.log_softmax(logits, -1).gather(-1, y[:, None]).mean(), {}

        launches, back, plain = (kernel.analog_mvm.launches, ops.backward_calls,
                                 ref.analog_mvm_ref.calls)
        (loss, _), grads = value_and_grad(loss_fn, params)
        out[name] = (float(loss), {tree_lib.path_name(p): g.cpu()
                                   for p, g in tree_lib.flatten_with_path(grads)})
        if name == "card":
            assert kernel.analog_mvm.launches - launches == len(cfg.convs) + 1
            assert ref.analog_mvm_ref.calls == plain
            assert ops.backward_calls - back == len(cfg.convs) + 1
    (l_cpu, g_cpu), (l_gpu, g_gpu), (_, g_ctl) = out["cpu"], out["card"], out["control"]
    assert math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu)
    for k, a in g_cpu.items():
        norm = a.norm().clamp(min=1e-30)
        rel = float((g_gpu[k] - a).norm() / norm)
        bound = 1e-2
        if k.rsplit("/", 1)[-1] in ("r_adc", "gain_s", "w_clip_buf"):
            # a sum over a layer's every quantizer term, with cancellation:
            # else within twice the control's own distance on this leaf
            bound = max(bound, 2 * float((g_ctl[k] - a).norm() / norm))
        assert rel <= bound, (k, rel, bound)
