"""The fused decode kernel (``csrc/decode_fused.cu``) against its plain
version ``kernels.ref.decode_fused_ref``, on the card.

Marked ``gpu``: each test skips on a host without a CUDA device (the kernel
has no interpret mode). On the card: ``PYTHONPATH=src python -m pytest -q
--noconftest -m gpu tests/test_torch_fused_decode_gpu.py``. This file
imports only the port, so it runs where JAX is not installed.

Tolerance, in two parts:

* phase by phase, at every layer: ``kernels.decode_fused_check`` ends the
  kernel after each MVM phase and recomputes every phase from the
  kernel's own inputs -- residual adds and V rows bitwise, K rows within
  two ulps, every DAC under ``tests/test_kernels.py``'s model, every MVM
  of a tensor-core item bitwise B1's decode design on the kernel's own
  DAC codes, every other MVM under the same model (see that module);
* end to end, against ``decode_fused_ref`` from the same cache: past the
  first MVMs the two sum norms, softmax and attention in different orders,
  and in bf16 a neighbouring activation is often the neighbouring DAC
  code, so ADC flips cascade. bf16 logits are held to the whole-step bound
  ``chip_smoke.py`` applies to the per-layer kernel path -- relative L2 <
  5%, greedy tokens equal on all but at most one slot. In f32 a flip
  needs an f32 rounding difference at a code boundary: the smoke-size
  logits read relative L2 0 on one H100 (every phase bitwise), so f32 is
  held to relative L2 < ``F32_REL_L2`` and every greedy token equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused decode kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: end-to-end f32 bound on the logits' relative L2 (measured: 0)
F32_REL_L2 = 1e-3


def _check(dec, logits_k, logits_p):
    dtype = dec.cfg.dtype
    assert logits_k.dtype == dtype and bool(logits_k.isfinite().all())
    lk, lp = logits_k[:, -1].float(), logits_p[:, -1].float()
    rel = float((lk - lp).norm() / lp.norm())
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    print(f"fused vs plain {dtype} depth {dec.plan.n_groups}: logits rel L2 {rel:.3e}, "
          f"greedy {agree}/{len(lk)}")
    if dtype == torch.float32:
        assert rel < F32_REL_L2 and agree == len(lk)
    else:
        assert rel < 0.05 and agree >= len(lk) - 1


def _setup(cuda, cfg, n_slots, s_max, prompt_lens, seed):
    from repro_torch import prng
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import decode_fused as df
    from repro_torch.models import lm

    params = lm.lm_init(prng.PRNGKey(seed), cfg, device=cuda)
    program = engine.compile_program(
        params, AnalogConfig(tile_rows=32 if cfg.d_model < 1024 else 1024).infer(b_adc=8),
        prng.PRNGKey(seed + 1), device=cuda,
    )
    params = engine.cast_weights(program.params, cfg.dtype)
    plan = engine.build_fused_plan(program)
    cache = df.init_fused_cache(cfg, plan.n_groups, n_slots, s_max, cfg.dtype,
                                device=cuda)
    rng = np.random.default_rng(seed)
    for slot, n in enumerate(prompt_lens):
        c = lm.init_lm_cache(cfg, 1, s_max, cfg.dtype, stacked=False, device=cuda)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=n), device=cuda)[None]
        _, c = lm.lm_forward(params, {"tokens": tok.long()}, program.cfg, cfg,
                             cache=c, last_token_only=True)
        df.write_fused_slot(cache, c, slot)
    dec = df.FusedDecoder(params, plan, cfg, program.cfg, n_slots, s_max)
    cur = torch.as_tensor(rng.integers(0, cfg.vocab, size=(n_slots, 1)), device=cuda)
    return dec, cache, cur


def _kernel_vs_plain(dec, cache, cur):
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels.decode_fused_check import NAMES, check_phases
    from repro_torch.kernels.ref import decode_fused_ref
    from repro_torch.models.common import embedding_apply

    res = check_phases(dec, cur, cache)
    print({k: {kk: v[kk] for kk in ("differing", "values", "max_steps") if kk in v}
           for k, v in res["checks"].items()})
    assert res["ok"], res["failures"]
    for p, item in enumerate(dec.items):  # tensor-core items: bitwise B1, no model
        c = res["checks"][f"mvm_{NAMES[p]}"]
        assert ("max_steps" not in c) == (item == "tensor_core")
        if item == "tensor_core":
            assert c["differing"] == 0
    cache_p = type(cache)(*(t.clone() for t in cache))
    lens = cache.length.clone()
    before = df.launches
    logits_k, out = dec.step(cur, cache)
    assert df.launches == before + 1
    assert torch.equal(out.length, lens + 1)
    h0 = embedding_apply(dec.params.embed, cur, dec.cfg.dtype)
    logits_p = decode_fused_ref(dec.tab, h0, lens, dec.n1, dec.n2, dec.stacks,
                                dec.w_head, dec.fin, cache_p.k, cache_p.v,
                                plan=dec.plan, cfg=dec.cfg)
    torch.cuda.synchronize()
    _check(dec, logits_k, logits_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_kernel_matches_plain_at_smoke_size(cuda, dtype):
    from repro_torch.configs import get_smoke

    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=dtype)
    # the third slot sits at s_max: its row lands on the clamped last position
    dec, cache, cur = _setup(cuda, cfg, 3, 16, (4, 9, 16), seed=1)
    _kernel_vs_plain(dec, cache, cur)


def test_fused_kernel_matches_plain_at_full_width_one_layer(cuda):
    from repro_torch.configs import get

    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=1)
    dec, cache, cur = _setup(cuda, cfg, 8, 512, (16, 32, 64, 128, 256, 300, 40, 8),
                             seed=2)
    _kernel_vs_plain(dec, cache, cur)


def test_fused_kernel_phases_at_full_width_three_layers(cuda):
    from repro_torch.configs import get

    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=3)
    dec, cache, cur = _setup(cuda, cfg, 8, 512, (16, 32, 64, 128, 256, 300, 40, 511),
                             seed=4)
    # every bf16 projection on the tensor cores, each MVM bitwise B1's decode design
    assert dec.items == ("tensor_core",) * 8
    _kernel_vs_plain(dec, cache, cur)


def test_too_large_cooperative_grid_is_refused(cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import decode_fused as df

    from repro_torch.models.common import embedding_apply

    dec, cache, cur = _setup(cuda, get_smoke("tinyllama-1.1b"), 2, 16, (3, 5), seed=3)
    h0 = embedding_apply(dec.params.embed, cur, dec.cfg.dtype).reshape(2, -1)
    before = df.launches
    with pytest.raises(RuntimeError, match="cooperative"):
        dec._launch(h0.contiguous(), cache, dec.grid + 1)
    assert df.launches == before
    dec.step(cur, cache)  # the card is still usable after the refusal
    torch.cuda.synchronize()
    assert df.launches == before + 1
