"""LM training on the card: B3's training form
(``kernels.ops.flash_attention_ste``: B3 forward, the plain version's VJP
recomputed backward) and one smoke-size step of each stage.

Marked ``gpu``: each test skips on a host without a CUDA device (the
kernels have no CPU mode). It imports only the port, so it runs where JAX
is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_lm_train_gpu.py

* B3's training form at tinyllama-1.1b's heads, bf16 and fp32: one B3
  launch per forward and one counted recompute per backward, no plain
  forward; its output bitwise B3's; its gradients bitwise autograd of the
  plain version on the card (the backward is that recompute);
  ``chunked_attention`` takes it only while autograd records;
* one step of each stage of tinyllama-1.1b's smoke config, fp32 with TF32
  off and bf16, on the card and on the CPU from the same params, batch and
  key: per forward 7 B1 launches a layer and the lm_head's in stage 2 (none
  in stage 1) and one B3 launch a layer, a recompute for each, no plain
  forward; the loss within 1e-3 relative of a free CPU forward; every mask
  and weight-noise draw bitwise; each gradient leaf within
  ``lockstep.GRAD_RTOL`` of the CPU's step locked to the card's forward
  values (``training.lockstep``: a free stage-2 step is chaotic in its
  rounding), and a zeroed or doubled leaf caught by that bound.
"""

import dataclasses
import math

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B1 and B3 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_training_form(cuda, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention

    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn((2, 128, 32, 64), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2, 128, 4, 64), generator=g, device=cuda).to(dtype) for _ in range(2))
    cot = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    chunks = dict(q_chunk=512, kv_chunk=1024)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    launches, back, plain = (fa.flash_attention.launches, ops.attention_backward_calls,
                             ref.flash_attention_ref.calls)
    o = attention.chunked_attention(*qkv, causal=True, **chunks)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    assert fa.flash_attention.launches == launches + 1
    grads = torch.autograd.grad(o, qkv, cot)
    assert ops.attention_backward_calls == back + 1
    assert ref.flash_attention_ref.calls == plain
    assert torch.equal(o.detach(), fa.flash_attention(q, k, v, causal=True, **chunks))
    rs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_plain(*rs, True, **chunks), rs, cot)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    with torch.no_grad():
        launches = fa.flash_attention.launches
        assert attention.chunked_attention(*qkv, causal=True, **chunks).grad_fn is None
        assert fa.flash_attention.launches == launches + 1


def _step(params, cfg, batch, stage, tape):
    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models import lm
    from repro_torch.training import lockstep
    from repro_torch.training.loop import value_and_grad

    dev = params.gain_s.device
    acfg = (AnalogConfig() if stage == 1
            else AnalogConfig().train(eta=0.1, b_adc=8, quant_noise_p=0.5))
    key = prng.fold_in(prng.PRNGKey(0).to(dev), 3) if stage == 2 else None
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with lockstep.tape(tape):
        (loss, _), grads = value_and_grad(
            lambda p: lm.lm_loss(p, batch, acfg, cfg, rng=key), params)
    return float(loss), {tree_lib.path_name(p): g.cpu()
                         for p, g in tree_lib.flatten_with_path(grads)}


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_smoke_step_card_vs_cpu(cuda, dtype, stage):
    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import PipelineConfig, batch_at
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.training import lockstep

    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=dtype)
    params_cpu = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
    batch = batch_at(PipelineConfig(kind="lm", global_batch=2, seq_len=32, vocab=cfg.vocab), 0)
    params = tree_lib.tree_map(lambda t: t.to(cuda), params_cpu)
    counts = lambda: (kernel.analog_mvm.launches, ops.backward_calls, fa.flash_attention.launches,
                      ops.attention_backward_calls, ref.analog_mvm_ref.calls,
                      ref.flash_attention_ref.calls)
    before = counts()
    card = lockstep.Tape()
    l_gpu, g_gpu = _step(params, cfg, batch, stage, card)
    delta = [a - b for a, b in zip(counts(), before)]
    mvms = 7 * cfg.n_layers + 1 if stage == 2 else 0
    assert delta == [mvms, mvms, cfg.n_layers, cfg.n_layers, 0, 0]
    l_free, _ = _step(params_cpu, cfg, batch, stage,
                      lockstep.Tape(lock=card, lock_kinds=("noise",)))
    cpu = lockstep.Tape(lock=card)
    _, g_cpu = _step(params_cpu, cfg, batch, stage, cpu)
    assert math.isfinite(l_gpu) and abs(l_gpu - l_free) <= 1e-3 * abs(l_free)
    assert cpu.masks == card.masks and len(card.masks) == 2 * mvms
    assert all(torch.equal(a["out"], b["out"]) for a, b in zip(card.of("noise"), cpu.of("noise")))
    bound = lockstep.GRAD_RTOL[str(dtype).split(".")[-1]]
    table = {k: lockstep.rel_l2(g_gpu[k], a) for k, a in g_cpu.items()}
    print(f"{dtype} stage {stage}: leaf rel L2 card vs the CPU locked to it (bound {bound}): "
          f"{table}")
    over = lockstep.over_bound(g_gpu, g_cpu, bound)
    assert not over, over
    missed = lockstep.planted_faults(g_gpu, g_cpu, bound)
    assert not missed["zeroed"] and not missed["doubled"], missed
