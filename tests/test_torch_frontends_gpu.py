"""The vision family on the card: paligemma-3b's decode through B2 and its
prefill attention through B3.

* paligemma's smoke config (8 image patches ahead of each prompt, one KV
  head), programmed on the card and served with every request's own
  ``features``: the tokens through B2 (``fused_decode``) equal the
  per-layer tokens, fp32 and bf16.
* B3 at paligemma's prefill heads, (1, 256 + 16, 8/1, 256): the image
  prefix and a 16-token prompt, causal, no window, against its plain
  version under ``chip_smoke.py`` phase 8's bound (f32 max |d| <= 1e-5 *
  max |o|; bf16 at most one output ulp, near zero ulp(|o|) + 1e-5 * max
  |o|, under 1% of outputs differing); its real rows bitwise the same
  under right-padding to 512.

Marked ``gpu``: each test skips on a host without a CUDA device (the kernels
have no interpret mode). On the card: ``PYTHONPATH=src python -m pytest -q
--noconftest -m gpu tests/test_torch_frontends_gpu.py``. This file imports
only the port, so it runs where JAX is not installed.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu

PALI = dict(h=8, kv=1, d=256, q_chunk=512, kv_chunk=1024)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(gen, s, dtype, dev):
    return [torch.randn((1, s, n, PALI["d"]), generator=gen, device=dev).to(dtype)
            for n in (PALI["h"], PALI["kv"], PALI["kv"])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_serves_the_per_layer_tokens(cuda, dtype):
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import decode_fused
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import Request, ServingConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke("paligemma-3b"), dtype=dtype)
    params = lm_init(prng.PRNGKey(0), cfg, device=cuda)
    program = engine.compile_program(params, AnalogConfig().infer(b_adc=8), prng.PRNGKey(1),
                                     device=cuda)
    gen = torch.Generator("cuda").manual_seed(0)
    patches = torch.randn((4, cfg.num_patches, cfg.d_model), generator=gen, device=cuda)
    prompts = torch.randint(0, cfg.vocab, (4, 12), generator=gen, device=cuda).cpu().numpy()
    reqs = [Request(rid=i, prompt=prompts[i, : 12 - 2 * i], max_new_tokens=6,
                    features={"patches": patches[i:i + 1]}) for i in range(4)]
    tokens = []
    for fused in (False, True):
        served = ServingEngine.for_program(
            program, cfg, ServingConfig(n_slots=2, s_max=32, fused_decode=fused), device=cuda)
        launches = decode_fused.launches
        rep = served.run(reqs)
        torch.cuda.synchronize()
        assert (decode_fused.launches > launches) == fused
        tokens.append([rep.tokens_of(i).tolist() for i in range(4)])
    assert tokens[0] == tokens[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_at_the_prefill_heads_matches_plain(cuda, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator("cuda").manual_seed(1)
    s = 256 + 16
    chunks = dict(q_chunk=PALI["q_chunk"], kv_chunk=PALI["kv_chunk"])
    q, k, v = _qkv(gen, s, dtype, cuda)
    launches = fa.flash_attention.launches
    o_k = fa.flash_attention(q, k, v, causal=True, **chunks)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    o_p = flash_attention_ref(q, k, v, True, **chunks)
    ok, op = o_k.float(), o_p.float()
    d = (ok - op).abs()
    scale = op.abs().max()
    assert bool(ok.isfinite().all())
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-5 * float(scale), float(d.max())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(op.abs().clamp(min=1e-30))) - 7)
        assert bool((d <= ulp + 1e-5 * scale).all()), float((d / ulp).max())
        assert float((d > 0).float().mean()) < 0.01
    pad = [torch.cat([x, 100 * torch.randn((1, 512 - s, *x.shape[2:]), generator=gen,
                                           device=cuda).to(dtype)], dim=1).contiguous()
           for x in (q, k, v)]
    assert torch.equal(fa.flash_attention(*pad, causal=True, **chunks)[:, :s], o_k)
