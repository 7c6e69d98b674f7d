"""Port parity: the Mamba-2 (SSD) block, ``models/ssm.py``, against the
reference's ``repro.models.ssm`` on the same numpy inputs (mamba2-2.7b's
smoke config: d_model 64, d_inner 128, 8 heads of 16, state 16, chunk 16).

* ``ssm_init`` through the RNG bridge: every leaf bitwise but ``dt_bias =
  log(exp(u) - 1)``, whose ``exp`` is torch's (XLA's differs by an ulp on
  ~2% of inputs): within 2e-4 of the reference's (|dt_bias| ~2-7; an ulp of
  exp(u) ~ 1.01 is 1.2e-7, divided by exp(u) - 1 >= 1e-3 in the log).
* ``_causal_conv`` with and without a cache tail: the tail bitwise; the
  taps summed in the reference's order (bitwise a numpy sum in that
  order); after the silu within 2e-6 relative (torch's silu and XLA's
  differ by ulps).
* ``_ssd_chunked`` at S not a multiple of the chunk (the dt = 0 pad), with
  and without ``h0``: y and the final state within 1e-5 relative L2 (the
  einsums contract in other orders; exp and cumsum differ by ulps).
* ``ssm_apply``: the decode step (one token against a cache) and a prefill
  followed by decode steps, digital: outputs and states within 1e-5
  relative L2 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro.configs import get_smoke as j_get_smoke
from repro.core import analog as janalog
from repro.models import ssm as jssm
from repro_torch import prng
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import analog as tanalog
from repro_torch.models import ssm as tssm

ARCH = "mamba2-2.7b"
RTOL = 1e-5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = j_get_smoke(ARCH), t_get_smoke(ARCH)
    jp = jssm.ssm_init(jax.random.PRNGKey(3), jcfg)
    tp = tssm.ssm_init(prng.PRNGKey(3), tcfg)
    # the reference's params, so the forwards see the same inputs
    tp_j = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(np.array(v)))
            for k, v in jp.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, tp_j=tp_j,
                jctx=janalog.AnalogCtx(cfg=janalog.AnalogConfig(), gain_s=jnp.ones(())),
                tctx=tanalog.AnalogCtx(cfg=tanalog.AnalogConfig(), gain_s=torch.ones(())))


def test_init_matches_reference(block):
    jp, tp = block["jp"], block["tp"]
    assert sorted(jp) == sorted(tp)
    for name in sorted(jp):
        if name == "dt_bias":
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]), atol=2e-4,
                                       rtol=0)
            continue
        want = jax.tree.leaves(jp[name])
        got = [tp[name][k] for k in sorted(tp[name])] if isinstance(tp[name], dict) else [
            tp[name]]
        for a, b in zip(want, got, strict=True):
            assert np.asarray(a).tobytes() == b.numpy().tobytes(), name


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_bitwise(block, with_cache):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 160)).astype(np.float32)
    w = rng.standard_normal((4, 160)).astype(np.float32)
    b = rng.standard_normal((160,)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 160)).astype(np.float32) if with_cache else None
    jy, jt = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if tail is None else jnp.asarray(tail))
    ty, tt = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               None if tail is None else torch.from_numpy(tail))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-6, atol=1e-7)
    # before the silu the taps are bitwise the reference's order
    yp, _ = tssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             None if tail is None else torch.from_numpy(tail))
    pad = np.zeros((2, 3, 160), np.float32) if tail is None else tail
    xp = np.concatenate([pad, x], axis=1)
    want = xp[:, 0:9] * w[0]
    for i in range(1, 4):
        want = want + xp[:, i:i + 9] * w[i]
    assert np.array_equal(yp.numpy(), want + b)


@pytest.mark.parametrize("s", [1, 16, 23, 40])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(s, with_h0):
    rng = np.random.default_rng(s + 10 * with_h0)
    b, h, p, n = 2, 8, 16, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -rng.uniform(1, 16, (h,)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_h0 else None
    jy, jh = jssm._ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)),
                               None if h0 is None else jnp.asarray(h0), 16)
    ty, th = tssm._ssd_chunked(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm)),
                               None if h0 is None else torch.from_numpy(h0), 16)
    assert ty.shape == (b, s, h, p) and th.shape == (b, h, p, n)
    assert _rel(ty.numpy(), jy) <= RTOL and _rel(th.numpy(), jh) <= RTOL


def test_prefill_then_decode_matches_reference(block):
    jcfg, tcfg = block["jcfg"], block["tcfg"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    jc = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tc = tssm.init_ssm_cache(tcfg, 2, torch.float32, device="cpu")
    jy, jc = jssm.ssm_apply(block["jp"], jnp.asarray(x), block["jctx"], jcfg, jc)
    ty, tc = tssm.ssm_apply(block["tp_j"], torch.from_numpy(x), block["tctx"], tcfg, tc)
    assert _rel(ty.numpy(), jy) <= RTOL
    assert np.array_equal(tc.conv.numpy(), np.asarray(jc.conv))  # the inputs' tail
    assert _rel(tc.h.numpy(), jc.h) <= RTOL
    for step in range(3):  # the exact one-step recurrence
        tok = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jssm.ssm_apply(block["jp"], jnp.asarray(tok), block["jctx"], jcfg, jc)
        ty, tc = tssm.ssm_apply(block["tp_j"], torch.from_numpy(tok), block["tctx"], tcfg, tc)
        assert ty.shape == (2, 1, jcfg.d_model)
        assert _rel(ty.numpy(), jy) <= RTOL and _rel(tc.h.numpy(), jc.h) <= RTOL, step
        assert _rel(tc.conv.numpy(), jc.conv) <= RTOL, step


def test_no_cache_forward_matches_reference(block):
    x = np.random.default_rng(6).standard_normal((1, 33, 64)).astype(np.float32)
    jy, jc = jssm.ssm_apply(block["jp"], jnp.asarray(x), block["jctx"], block["jcfg"])
    ty, tc = tssm.ssm_apply(block["tp_j"], torch.from_numpy(x), block["tctx"], block["tcfg"])
    assert jc is None and tc is None
    assert _rel(ty.numpy(), jy) <= RTOL
