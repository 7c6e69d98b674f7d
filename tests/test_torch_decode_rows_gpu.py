"""The row kernels (``kernels/decode_rows.py``) and the RNG bridge's normal
kernel (``csrc/prng.cu``) on the card.

Marked ``gpu``: each test skips on a host without a CUDA device (the
kernels have no CPU mode; their plain versions are what the CPU runs). It
imports only the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_decode_rows_gpu.py

* each row kernel against its plain version, within the plain version's
  rounding model (one bf16 ulp; in f32 4 ulps plus 2^-20 of the largest
  output, for sums that cancel; twice that for attention, whose scores,
  softmax and AV sums take B2's orders);
* a per-layer decode step on the card is bitwise the fused kernel's step
  on the same chip and cache, at full width and depth 2;
* the normal draw on the card is bitwise the plain version on the CPU;
* a request's decode tokens depend neither on the engine's slot count nor
  on its ``s_max`` (per layer and fused): served alone by a 1-slot engine
  at ``s_max`` 256 they are bitwise its tokens inside an 8-slot engine at
  512, and the attention row kernel's rows are bitwise equal across the
  two launch shapes (the two size their passes of query heads apart).
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the row and prng kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, bf16_ulps: float) -> bool:
    """bf16: within ``bf16_ulps`` of the output's own ulp; f32: within
    ``bf16_ulps`` f32 ulps of |want| plus 2^-20 of max |want| (sums of
    hundreds of terms cancel near zero, and the two sum in other orders)."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    bits = 7 if want.dtype == torch.bfloat16 else 23
    tol = bf16_ulps * torch.exp2(torch.floor(torch.log2(w.clamp(min=1e-30))) - bits)
    if want.dtype == torch.float32:
        tol = tol + w.max() * 2.0 ** -20
    return bool((d <= tol).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_row_kernels_match_their_plain_versions(cuda, dtype):
    from repro_torch.kernels import decode_rows as dr

    g = torch.Generator("cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g, device=cuda).to(dtype)
    b, d, h, kv, hd, s, f = 8, 2048, 32, 4, 64, 300, 5632
    x, scale = randn(b, 1, d), 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    q, k = randn(b, 1, h, hd), randn(b, 1, kv, hd)
    pos = torch.randint(0, s - 1, (b,), generator=g, device=cuda, dtype=torch.int32)
    kc, vc = randn(b, s, kv, hd), randn(b, s, kv, hd)
    u, gg = randn(b, 1, f), randn(b, 1, f)
    before = dict(dr.launches)
    # one ulp of the dtype, 4 in f32 (reduction orders, rsqrtf); twice that
    # for attention
    tol = 1 if dtype == torch.bfloat16 else 4
    assert _close(dr.norm(x, scale, 1e-5), dr.norm_plain(x, scale, 1e-5), tol)
    for got, want in zip(dr.rope(q, k, pos, 10000.0), dr.rope_plain(q, k, pos, 10000.0)):
        assert _close(got, want, tol)
    q_r = dr.rope(q, k, pos, 10000.0)[0]
    assert _close(dr.attention(q_r, kc, vc, pos + 1),
                  dr.attention_plain(q_r, kc, vc, pos + 1), 2 * tol)
    assert _close(dr.gate(u, gg), dr.gate_plain(u, gg), tol)
    assert {n: dr.launches[n] - before[n] for n in before} == {
        "norm": 1, "rope": 2, "attn": 1, "gate": 1}


def test_per_layer_step_is_the_fused_step_bitwise(cuda):
    from repro_torch import prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import decode_fused as df
    from repro_torch.models import lm
    from repro_torch.models.attention import KVCache

    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=2)
    params = lm.lm_init(prng.PRNGKey(0), cfg, device=cuda)
    prog = engine.compile_program(params, AnalogConfig().infer(b_adc=6), prng.PRNGKey(1),
                                  device=cuda)
    w = engine.cast_weights(prog.params, cfg.dtype)
    b, s = 8, 128
    dec = df.FusedDecoder(w, engine.build_fused_plan(prog), cfg, prog.cfg, b, s)
    g = torch.Generator("cuda").manual_seed(1)
    lens = torch.randint(1, s - 1, (b,), generator=g, device=cuda, dtype=torch.int32)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd)
    k = torch.randn(shape, generator=g, device=cuda).to(cfg.dtype)
    v = torch.randn(shape, generator=g, device=cuda).to(cfg.dtype)
    tok = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=cuda)
    lf, fc = dec.step(tok, KVCache(k.clone(), v.clone(), lens.clone()))
    lcache = ([(KVCache(k[i].clone(), v[i].clone(), lens.clone()),) for i in range(2)], ())
    lp, lc = lm.lm_forward(w, {"tokens": tok}, prog.cfg, cfg, cache=lcache)
    assert torch.equal(lf, lp)
    assert torch.equal(fc.k, torch.stack([grp[0].k for grp in lc[0]]))
    assert torch.equal(fc.v, torch.stack([grp[0].v for grp in lc[0]]))


@pytest.mark.parametrize("shape", [(1,), (7, 13), (1 << 21,)], ids=str)
def test_normal_on_the_card_is_the_plain_version(cuda, shape):
    from repro_torch import prng

    before = prng.launches
    for seed in (0, 42):
        got = prng.normal(prng.PRNGKey(seed).to(cuda), shape)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), prng.normal(prng.PRNGKey(seed), shape))
        e = prng.normal_erf_inv(prng.PRNGKey(seed).to(cuda), shape)
        assert torch.equal(e.cpu(), prng.normal_erf_inv(prng.PRNGKey(seed), shape))
    assert prng.launches - before == 4


def test_attention_rows_independent_of_slots_and_s_max(cuda):
    from repro_torch.kernels import decode_rows as dr

    g = torch.Generator("cuda").manual_seed(3)
    h, kv, hd = 32, 4, 64
    randn = lambda *shape: torch.randn(shape, generator=g, device=cuda).bfloat16()
    q8, k8, v8 = randn(8, 1, h, hd), randn(8, 512, kv, hd), randn(8, 512, kv, hd)
    lens = torch.tensor([5, 256, 100, 17, 255, 1, 64, 200], device=cuda, dtype=torch.int32)
    grid = dr.sm_count(cuda)
    assert dr.heads_per_pass(h, kv, hd, 1, 256, grid) != dr.heads_per_pass(h, kv, hd, 8, 512,
                                                                            grid)
    wide = dr.attention(q8, k8, v8, lens)
    for b in range(8):
        alone = dr.attention(q8[b:b + 1], k8[b:b + 1, :256].contiguous(),
                             v8[b:b + 1, :256].contiguous(), lens[b:b + 1])
        assert torch.equal(alone[0], wide[b]), b


@pytest.mark.parametrize("fused", [False, True], ids=["per_layer", "fused"])
def test_decode_tokens_independent_of_slots_and_s_max(cuda, fused):
    from repro_torch import clock, prng
    from repro_torch.configs import get
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import ServingConfig, ServingEngine, poisson_trace

    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=2)
    params = lm_init(prng.PRNGKey(0), cfg, device=cuda)
    prog = engine.compile_program(params, AnalogConfig().infer(b_adc=8), prng.PRNGKey(1),
                                  device=cuda)
    w = engine.cast_weights(prog.params, cfg.dtype)
    trace = poisson_trace(prng.PRNGKey(7), 8, vocab=cfg.vocab, rate=50.0,
                          prompt_lens=(16, 32, 64), new_tokens=(8, 24))

    def serve(n_slots, s_max, reqs):
        scfg = ServingConfig(n_slots=n_slots, s_max=s_max, fused_decode=fused, ref_check=False)
        return ServingEngine(cfg, prog.cfg, w, scfg, program=prog, device=cuda).run(
            reqs, clock=clock.VirtualClock())

    wide = serve(8, 512, trace)
    for r in trace[:3]:
        alone = serve(1, 256, [r]).tokens_of(r.rid)
        assert alone.tolist() == wide.tokens_of(r.rid).tolist(), r.rid
