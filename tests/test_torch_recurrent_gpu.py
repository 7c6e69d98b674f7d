"""B3 with the local window and at head dim 256, and the row kernels at
recurrentgemma-9b's decode shapes, on the card.

Marked ``gpu``: each test skips on a host without a CUDA device (the kernels
have no interpret mode). On the card: ``PYTHONPATH=src python -m pytest -q
--noconftest -m gpu tests/test_torch_recurrent_gpu.py``. This file imports
only the port, so it runs where JAX is not installed.

Tolerance of B3 against its plain version (phase 8's): f32 max |d| <= 1e-5
* max |o|; bf16 at most one output ulp (near zero, ulp(|o|) + 1e-5 * max
|o|) with under 1% of outputs differing. The walk that starts at a block's
first live key is bitwise the walk from key 0, and real rows are bitwise
independent of right-padding. The row kernels: one bf16 ulp of their plain
versions (attention two), as ``chip_smoke.py`` phase 10 holds them; at hd
256 the attention also within one flipped p (see the test).
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

RG = dict(h=16, kv=1, d=256, q_chunk=512, kv_chunk=1024)
SMOKE = dict(h=4, kv=1, d=16, q_chunk=16, kv_chunk=32)
#: (rows, S, heads, window): recurrentgemma's heads at its window and at
#: windows that bite at serving lengths; the smoke width's window 32;
#: D = 256 without a window
CASES = [(1, 2048, RG, 2048), (1, 600, RG, 64), (2, 300, RG, 100), (2, 96, SMOKE, 32),
         (3, 77, SMOKE, 5), (1, 256, RG, None)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(gen, b, s, c, dtype, dev):
    return [torch.randn((b, s, n, c["d"]), generator=gen, device=dev).to(dtype)
            for n in (c["h"], c["kv"], c["kv"])]


def _check(o_k, o_p):
    assert o_k.dtype == o_p.dtype and o_k.shape == o_p.shape
    ok, op = o_k.float(), o_p.float()
    d = (ok - op).abs()
    scale = op.abs().max()
    assert bool(ok.isfinite().all())
    if o_p.dtype == torch.float32:
        assert float(d.max()) <= 1e-5 * float(scale), float(d.max())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(op.abs().clamp(min=1e-30))) - 7)
        assert bool((d <= ulp + 1e-5 * scale).all()), float((d / ulp).max())
        assert float((d > 0).float().mean()) < 0.01


@pytest.mark.parametrize("rows,s,heads,window", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_window_and_d256_match_plain(cuda, rows, s, heads, window, dtype, causal):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator("cuda").manual_seed(rows * s + causal)
    q, k, v = _qkv(gen, rows, s, heads, dtype, cuda)
    chunks = dict(q_chunk=heads["q_chunk"], kv_chunk=heads["kv_chunk"])
    launches = fa.flash_attention.launches
    o_k = fa.flash_attention(q, k, v, causal=causal, window=window, **chunks)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    _check(o_k, flash_attention_ref(q, k, v, causal, window=window, **chunks))
    if window is not None:
        o_all = fa._launch(q, k, v, causal=causal, kv_chunk=heads["kv_chunk"], window=window,
                           skip=False)
        assert torch.equal(o_k, o_all)


@pytest.mark.parametrize("heads,window,length,bucket", [
    (SMOKE, 32, 17, 64), (SMOKE, 32, 100, 256), (RG, 64, 100, 512), (RG, 64, 300, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_rows_independent_of_right_padding(cuda, heads, window, length, bucket, dtype):
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(length + bucket)
    chunks = dict(q_chunk=heads["q_chunk"], kv_chunk=heads["kv_chunk"])
    q, k, v = _qkv(gen, 1, length, heads, dtype, cuda)
    exact = fa.flash_attention(q, k, v, causal=True, window=window, **chunks)
    pad = [torch.cat([x, 100 * torch.randn((1, bucket - length, *x.shape[2:]), generator=gen,
                                           device=cuda).to(dtype)], dim=1).contiguous()
           for x in (q, k, v)]
    out = fa.flash_attention(*pad, causal=True, window=window, **chunks)
    assert torch.equal(out[:, :length], exact)


def test_row_kernels_at_recurrentgemma_decode(cuda):
    """norm at 4096, RoPE at hd 256, attention over a 256-row rolling buffer
    (one KV head) at lengths past it, the gate at 12288: bf16, 8 slots."""
    from repro_torch.kernels import decode_rows as dr

    gen = torch.Generator("cuda").manual_seed(0)
    bf = torch.bfloat16
    randn = lambda *shape: torch.randn(shape, generator=gen, device=cuda)
    b, d, h, kv, hd, s, f = 8, 4096, 16, 1, 256, 256, 12288
    lens = torch.tensor([1, 100, 255, 256, 257, 300, 600, 1000], dtype=torch.int32,
                        device=cuda)
    x, scale = randn(b, 1, d).to(bf), 1 + 0.1 * randn(d)
    q, k = randn(b, 1, h, hd).to(bf), randn(b, 1, kv, hd).to(bf)
    kc, vc = randn(b, s, kv, hd).to(bf), randn(b, s, kv, hd).to(bf)
    u, g = randn(b, 1, f).to(bf), randn(b, 1, f).to(bf)
    q_r, _ = dr.rope(q, k, lens - 1, 10000.0)
    pairs = [
        (dr.norm(x, scale, 1e-6), dr.norm_plain(x, scale, 1e-6), 1),
        (torch.cat([t.reshape(-1) for t in dr.rope(q, k, lens - 1, 10000.0)]),
         torch.cat([t.reshape(-1) for t in dr.rope_plain(q, k, lens - 1, 10000.0)]), 1),
        (dr.attention(q_r, kc, vc, lens), dr.attention_plain(q_r, kc, vc, lens), 2),
        (dr.gate(u, g), dr.gate_plain(u, g), 1),
    ]
    # attention: two ulps, or one p that rounds to the other bf16 neighbour
    # at a midpoint (both versions round p before AV): ulp(p) |v| <= 2^-7
    # p_max v_max of the output's (slot, head)
    live = torch.arange(s, device=cuda)[None, :] < lens.clamp(max=s)[:, None]
    sc = torch.einsum("bkgd,bskd->bkgs", q_r[:, 0].reshape(b, kv, h // kv, hd).float(),
                      kc.float()) * hd**-0.5
    p_max = torch.softmax(sc.masked_fill(~live[:, None, None], -torch.inf), -1).amax(-1)
    v_max = (vc.float().abs().amax(-1) * live[:, :, None]).amax(1)
    flip = (2.0**-7 * p_max * v_max[:, :, None]).reshape(b, 1, h, 1).expand(b, 1, h, hd)
    extra = [torch.zeros(1, device=cuda), torch.zeros(1, device=cuda), flip.reshape(-1),
             torch.zeros(1, device=cuda)]
    for (got, want, tol), slack in zip(pairs, extra):
        got, want = got.float().reshape(-1), want.float().reshape(-1)
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
        assert bool(got.isfinite().all())
        assert bool(((got - want).abs() <= tol * ulp + slack).all())
