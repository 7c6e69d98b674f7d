"""Port parity: the prefill attention and the plain version of its kernel.

* ``kernels.ref.flash_attention_ref`` (the port's chunked online-softmax
  loop, the plain version of ``csrc/flash_attention.cu``) against the
  reference's Pallas kernel ``flash_attention_fwd`` run in interpret mode,
  as ``tests/test_kernels.py`` runs it, with GQA broadcast for the JAX call.
  The port runs at ``kv_chunk`` = the Pallas ``block_k`` (128), so both form
  p against the same running max. Tolerance: f32 max |d| <= 1e-5 * max |o|
  (summation order, and the Pallas kernel scales q before QK^T where the
  port scales the scores after); bf16 at most one output ulp (near zero,
  where a bf16 ulp is finer than the f32 accumulation's error, the f32
  bound: ulp(|o|) + 1e-5 * max |o|) with under 1% of outputs differing.
* ``models.attention.chunked_attention`` against the reference's on prompts
  right-padded to a bucket, at the smoke config's chunks: f32 within
  1e-5 * max |o|, bf16 as above.
* Real rows are bitwise independent of right-padding (the plain version and
  ``chunked_attention``), for any pad content.
* On the CPU the kernel's wrapper runs the plain version and launches
  nothing.
* The local window (the hybrid family's): the plain version and
  ``chunked_attention`` with a window against the reference's
  ``chunked_attention`` at the smoke width (window 32) and at head dim 256,
  S past the window, f32 within 1e-5 * max |o| and bf16 as above, causal
  and full -- at head dim 256 bf16 also within one flipped p a row: both
  round p to bf16 before PV, and the frameworks' f32 score sums over 256
  products differ in their last bits, so a p at a bf16 midpoint may round
  to the other neighbour, moving the row's outputs by up to ulp(p) |v| <=
  2^-7 p_max max|v| (9 of 20480 outputs, up to 0.0039); real rows bitwise
  independent of right-padding with the window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as tattn

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(rng, b, s, h, kv, d):
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of |x| (x in f32)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _assert_close(o, ref, dtype_name, slack=0.0):
    o, ref = np.asarray(o, np.float32), np.asarray(ref, np.float32)
    d = np.abs(o - ref)
    if dtype_name == "f32":
        assert d.max() <= 1e-5 * np.abs(ref).max(), d.max()
    else:
        bound = _ulp(ref) + 1e-5 * np.abs(ref).max() + slack
        assert np.all(d <= bound), (d.max(), (d > bound).sum())
        assert (d > 0).mean() < 0.01, (d > 0).mean()


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _p_flip(q, k, v, causal, window):
    """(B, S, H, 1): one bf16 ulp of each row's largest p times the largest
    |v| of its KV head (q (B, S, H, D), k and v (B, S, Kv, D), f32)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    kk = np.repeat(k, h // kv, axis=2)
    sc = np.einsum("bqhd,bkhd->bhqk", q, kk) * d**-0.5
    i = np.arange(s)
    live = (i[:, None] - i[None, :] < window) & ((i[:, None] >= i[None, :]) | (not causal))
    sc = np.where(live, sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p_max = (p / p.sum(-1, keepdims=True)).max(-1)  # (B, H, S)
    v_max = np.repeat(np.abs(v).max(axis=(1, 3)), h // kv, axis=1)  # (B, H)
    return (2.0**-7 * p_max * v_max[:, :, None]).transpose(0, 2, 1)[..., None]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,d", [(4, 256, 64), (2, 128, 128)])
def test_plain_version_matches_pallas_interpret(dtype_name, causal, bh, s, d):
    tdt, jdt = DTYPES[dtype_name]
    kv = bh // 2  # GQA: two query heads per KV head
    q, k, v = _qkv(np.random.default_rng(bh * s + d), 1, s, bh, kv, d)
    o_t = flash_attention_ref(_to_torch(q, tdt), _to_torch(k, tdt), _to_torch(v, tdt),
                              causal, q_chunk=64, kv_chunk=128)
    # the Pallas kernel takes (BH, S, D) with GQA broadcast beforehand
    bcast = lambda x: np.repeat(x, bh // kv, axis=2)[0].transpose(1, 0, 2)
    o_j = flash_attention_fwd(
        _to_jax(q[0].transpose(1, 0, 2), jdt), _to_jax(bcast(k), jdt),
        _to_jax(bcast(v), jdt), causal=causal, block_q=128, block_k=128,
        interpret=True,
    )
    assert o_t.dtype == tdt and o_t.shape == (1, s, bh, d)
    _assert_close(o_t.float().numpy()[0].transpose(1, 0, 2),
                  np.asarray(o_j.astype(jnp.float32)), dtype_name)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("length,bucket", [(5, 32), (23, 32), (33, 64), (40, 48)])
def test_chunked_attention_matches_reference_on_padded_prompts(dtype_name, length, bucket):
    tdt, jdt = DTYPES[dtype_name]
    rng = np.random.default_rng(length * bucket)
    q, k, v = _qkv(rng, 2, bucket, 4, 2, 16)
    kw = dict(q_chunk=16, kv_chunk=32, causal=True)  # the smoke config's chunks
    o_t = tattn.chunked_attention(_to_torch(q, tdt), _to_torch(k, tdt), _to_torch(v, tdt), **kw)
    o_j = jattn.chunked_attention(_to_jax(q, jdt), _to_jax(k, jdt), _to_jax(v, jdt), **kw)
    # the real rows of a prompt of `length` tokens padded to `bucket`
    _assert_close(o_t.float().numpy()[:, :length],
                  np.asarray(o_j.astype(jnp.float32))[:, :length], dtype_name)


def test_chunked_attention_continuation_matches_reference():
    """The plain version's other case (q_offset > 0, Sq != Sk)."""
    q, _, _ = _qkv(np.random.default_rng(3), 1, 8, 4, 2, 16)
    _, k, v = _qkv(np.random.default_rng(4), 1, 40, 4, 2, 16)
    kw = dict(q_chunk=16, kv_chunk=32, causal=True, q_offset=32)
    o_t = tattn.chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    o_j = jattn.chunked_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    _assert_close(o_t.numpy(), np.asarray(o_j), "f32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunks", [(16, 32), (512, 1024), (64, 64)])
@pytest.mark.parametrize("length", [1, 7, 32, 33, 100])
def test_real_rows_bitwise_independent_of_right_padding(dtype, chunks, length):
    rng = np.random.default_rng(length)
    q, k, v = (_to_torch(x, dtype) for x in _qkv(rng, 1, length, 4, 2, 16))
    exact = tattn.chunked_attention(q, k, v, q_chunk=chunks[0], kv_chunk=chunks[1])
    for bucket in (length + 1, 128, 256):
        pads = [_to_torch(x, dtype) for x in _qkv(rng, 1, bucket - length, 4, 2, 16)]
        padded = [torch.cat([x, p * 100.0], dim=1) for x, p in zip((q, k, v), pads)]
        out = tattn.chunked_attention(*padded, q_chunk=chunks[0], kv_chunk=chunks[1])
        assert torch.equal(out[:, :length], exact), bucket


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(x) for x in _qkv(np.random.default_rng(5), 2, 40, 4, 2, 16))
    launches, calls = fa.flash_attention.launches, flash_attention_ref.calls
    out = fa.flash_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=32)
    assert fa.flash_attention.launches == launches
    assert flash_attention_ref.calls == calls + 1
    assert torch.equal(out, flash_attention_ref(q, k, v, True, q_chunk=16, kv_chunk=32))
    # the dense prefill's case reaches the kernel's wrapper
    assert torch.equal(tattn.chunked_attention(q, k, v, q_chunk=16, kv_chunk=32), out)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,kv,d,window,chunks", [
    (96, 4, 1, 16, 32, (16, 32)),     # the smoke width: window 32, kv_chunk 32
    (77, 4, 2, 16, 5, (16, 32)),      # a window inside a chunk
    (160, 2, 1, 256, 64, (64, 128)),  # recurrentgemma's head dim
])
def test_window_matches_reference(dtype_name, causal, s, h, kv, d, window, chunks):
    tdt, jdt = DTYPES[dtype_name]
    q, k, v = _qkv(np.random.default_rng(s * d + window), 2, s, h, kv, d)
    kw = dict(q_chunk=chunks[0], kv_chunk=chunks[1], causal=causal, window=window)
    o_j = np.asarray(jattn.chunked_attention(_to_jax(q, jdt), _to_jax(k, jdt), _to_jax(v, jdt),
                                             **kw).astype(jnp.float32))
    tq, tk, tv = (_to_torch(x, tdt) for x in (q, k, v))
    slack = _p_flip(*(x.float().numpy() for x in (tq, tk, tv)), causal, window) if d > 128 else 0
    o_t = tattn.chunked_attention(tq, tk, tv, **kw)
    _assert_close(o_t.float().numpy(), o_j, dtype_name, slack)
    kw.pop("causal")
    o_p = flash_attention_ref(tq, tk, tv, causal, **kw)
    assert torch.equal(o_p, o_t) if causal else o_p.dtype == tdt
    _assert_close(o_p.float().numpy(), o_j, dtype_name, slack)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 20, 40, 100])
def test_window_rows_bitwise_independent_of_right_padding(dtype, length):
    rng = np.random.default_rng(length + 7)
    kw = dict(q_chunk=16, kv_chunk=32, window=32)
    q, k, v = (_to_torch(x, dtype) for x in _qkv(rng, 1, length, 4, 1, 16))
    exact = tattn.chunked_attention(q, k, v, **kw)
    for bucket in (length + 1, 128):
        pads = [_to_torch(x, dtype) for x in _qkv(rng, 1, bucket - length, 4, 1, 16)]
        padded = [torch.cat([x, p * 100.0], dim=1) for x, p in zip((q, k, v), pads)]
        assert torch.equal(tattn.chunked_attention(*padded, **kw)[:, :length], exact), bucket
