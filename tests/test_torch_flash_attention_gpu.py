"""The Hopper prefill-attention kernel against its plain version, on the card.

Marked ``gpu``: each test skips on a host without a CUDA device (the kernel
has no interpret mode). On the card: ``PYTHONPATH=src python -m pytest -q
--noconftest -m gpu tests/test_torch_flash_attention_gpu.py``. This file
imports only the port, so it runs where JAX is not installed.

Shapes: tinyllama-1.1b's heads (H 32, Kv 4, D 64) at the exact prompt
lengths of the per-request prefill (one row), the bucketed engine's
(rows, bucket) shapes, its published context 2048, D 128 and the smoke
config (H 4, Kv 2, D 16, chunks 16/32). The plain version runs at the same
chunks as the kernel. Tolerance: f32 max |d| <= 1e-5 * max |o|; bf16 at
most one output ulp (near zero, ulp(|o|) + 1e-5 * max |o|) with under 1%
of outputs differing.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

#: (rows, S): exact-length prefills of one request (S below one 64-key
#: tile included), the bucketed engine at prefill_batch 4 (tinyllama), and
#: the published context
SHAPES = [(1, 16), (1, 32), (4, 32), (1, 64), (2, 64), (1, 128), (1, 256), (1, 512),
          (1, 2048)]
TINYLLAMA = dict(h=32, kv=4, d=64, q_chunk=512, kv_chunk=1024)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(gen, b, s, h, kv, d, dtype, dev):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


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


@pytest.mark.parametrize("rows,s", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_tinyllama(cuda, rows, s, dtype, causal):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    c = TINYLLAMA
    gen = torch.Generator("cuda").manual_seed(rows * s + causal)
    q, k, v = _qkv(gen, rows, s, c["h"], c["kv"], c["d"], dtype, cuda)
    launches = fa.flash_attention.launches
    o_k = fa.flash_attention(q, k, v, causal=causal, q_chunk=c["q_chunk"],
                             kv_chunk=c["kv_chunk"])
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    o_p = flash_attention_ref(q, k, v, causal, q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    _check(o_k, o_p)


@pytest.mark.parametrize("b,s,h,kv,d,chunks", [
    (2, 77, 4, 2, 16, (16, 32)),   # the smoke config: a chunk inside a tile
    (1, 300, 8, 2, 128, (512, 128)),
    (3, 100, 6, 3, 32, (64, 64)),
    (1, 130, 32, 2, 64, (512, 1024)),  # 16 query heads per KV head
    (2, 70, 6, 2, 32, (64, 96)),       # 3 per KV head, a chunk off the 64-key tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_other_shapes(cuda, b, s, h, kv, d, chunks, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator("cuda").manual_seed(s * d)
    q, k, v = _qkv(gen, b, s, h, kv, d, dtype, cuda)
    for causal in (True, False):
        o_k = fa.flash_attention(q, k, v, causal=causal, q_chunk=chunks[0], kv_chunk=chunks[1])
        o_p = flash_attention_ref(q, k, v, causal, q_chunk=chunks[0], kv_chunk=chunks[1])
        _check(o_k, o_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 17, 64, 100, 250])
def test_real_rows_bitwise_independent_of_padding(cuda, dtype, length):
    """A prompt at its exact length and right-padded to every larger bucket:
    the real rows match bitwise, whatever the pad rows hold."""
    from repro_torch.kernels import flash_attention as fa

    c = TINYLLAMA
    gen = torch.Generator("cuda").manual_seed(length)
    q, k, v = _qkv(gen, 1, length, c["h"], c["kv"], c["d"], dtype, cuda)
    kw = dict(causal=True, q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    exact = fa.flash_attention(q, k, v, **kw)
    for bucket in (32, 64, 128, 256, 512, 2048):
        if bucket <= length:
            continue
        pads = _qkv(gen, 1, bucket - length, c["h"], c["kv"], c["d"], dtype, cuda)
        padded = [torch.cat([x, p * 100], dim=1).contiguous() for x, p in zip((q, k, v), pads)]
        out = fa.flash_attention(*padded, **kw)
        assert torch.equal(out[:, :length], exact), bucket


def test_prefill_attention_reaches_the_kernel(cuda):
    """chunked_attention's dense-prefill case launches the kernel and never
    the plain version; its other cases run the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.attention import chunked_attention

    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = _qkv(gen, 1, 40, 4, 2, 16, torch.float32, cuda)
    launches, calls = fa.flash_attention.launches, flash_attention_ref.calls
    chunked_attention(q, k, v, q_chunk=16, kv_chunk=32)
    assert (fa.flash_attention.launches, flash_attention_ref.calls) == (launches + 1, calls)
    chunked_attention(q[:, :8], k, v, q_chunk=16, kv_chunk=32, q_offset=32)
    assert (fa.flash_attention.launches, flash_attention_ref.calls) == (launches + 1, calls + 1)


def test_failed_build_raises(cuda, tmp_path, monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    (tmp_path / "flash_attention.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(fa, "_FN", None)
    q, k, v = _qkv(torch.Generator("cuda").manual_seed(0), 1, 8, 4, 2, 16, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        fa.flash_attention(q, k, v, q_chunk=16, kv_chunk=32)


def test_failed_launch_raises(cuda, monkeypatch):
    """A head dim the kernel is not instantiated for passes the wrapper's
    check here, and the launcher refuses it: the wrapper raises."""
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(fa, "HEAD_DIMS", fa.HEAD_DIMS + (48,))
    q, k, v = _qkv(torch.Generator("cuda").manual_seed(0), 1, 8, 4, 2, 48, torch.float32, cuda)
    launches = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_attention(q, k, v, q_chunk=16, kv_chunk=32)
    assert fa.flash_attention.launches == launches
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, q_chunk=16, kv_chunk=32)


def test_misaligned_bf16_operands_raise(cuda):
    """The bf16 kernel moves rows in 16-byte copies: a contiguous view that
    starts off a 16-byte boundary is refused before the launch."""
    from repro_torch.kernels import flash_attention as fa

    c = TINYLLAMA
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = _qkv(gen, 1, 64, c["h"], c["kv"], c["d"], torch.bfloat16, cuda)
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)[1:].view(k.shape)
    shifted.copy_(k)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    launches = fa.flash_attention.launches
    for args in ((q, shifted, v), (q, k, shifted)):
        with pytest.raises(ValueError, match="aligned"):
            fa.flash_attention(*args, q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    assert fa.flash_attention.launches == launches
    o = fa.flash_attention(q, k, v, q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    assert o.data_ptr() % 16 == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("rows,s", SHAPES)
def test_bf16_matches_plain_on_more_seeds(cuda, seed, rows, s):
    """The bf16 tensor-core kernel on inputs from other seeds than the
    tests above, causal and full, under the same bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    c = TINYLLAMA
    gen = torch.Generator("cuda").manual_seed(1000 * seed + rows * s)
    q, k, v = _qkv(gen, rows, s, c["h"], c["kv"], c["d"], torch.bfloat16, cuda)
    for causal in (True, False):
        o_k = fa.flash_attention(q, k, v, causal=causal, q_chunk=c["q_chunk"],
                                 kv_chunk=c["kv_chunk"])
        o_p = flash_attention_ref(q, k, v, causal, q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
        _check(o_k, o_p)
