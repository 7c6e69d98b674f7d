"""Port parity: the Griffin recurrent block (RG-LRU), ``models/griffin.py``,
against the reference's ``repro.models.griffin`` on the same numpy inputs
(recurrentgemma-9b's smoke config: d_model 64, lru width 64).

* ``griffin_init`` through the RNG bridge: bitwise.
* ``_rg_lru_scan`` against ``jax.lax.associative_scan`` at S = 1, odd S and
  powers of two, with and without ``h0``: the port runs the reference's
  combine tree, so op by op it is bitwise the reference run eagerly; under
  ``jax.jit`` XLA contracts the combine's ``b_l * a_r + b_r`` into a fused
  multiply-add, a one-rounding difference per combine: within 1e-6
  relative L2 of the jitted scan.
* the tanh gelu (``jax.nn.gelu``'s default): within 1e-6 relative of
  XLA's (1e-6 absolute in its far negative tail), where the exact erf
  gelu is 1e-4 away.
* ``griffin_apply``: a prefill with a cache (the conv tail and the final
  state), decode steps after it, and a cache-free forward, digital: within
  1e-5 relative L2 of JAX's (torch's sigmoid, softplus and exp differ from
  XLA's by ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro.configs import get_smoke as j_get_smoke
from repro.core import analog as janalog
from repro.models import griffin as jgriffin
from repro_torch import prng
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import analog as tanalog
from repro_torch.models import griffin as tgriffin

ARCH = "recurrentgemma-9b"
RTOL = 1e-5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = j_get_smoke(ARCH), t_get_smoke(ARCH)
    jp = jgriffin.griffin_init(jax.random.PRNGKey(4), jcfg)
    tp = tgriffin.griffin_init(prng.PRNGKey(4), tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                jctx=janalog.AnalogCtx(cfg=janalog.AnalogConfig(), gain_s=jnp.ones(())),
                tctx=tanalog.AnalogCtx(cfg=tanalog.AnalogConfig(), gain_s=torch.ones(())))


def test_init_bitwise(block):
    jp, tp = block["jp"], block["tp"]
    assert sorted(jp) == sorted(tp)
    for name in sorted(jp):
        want = jax.tree.leaves(jp[name])
        got = ([tp[name][k] for k in sorted(tp[name])] if isinstance(tp[name], dict)
               else [tp[name]])
        for a, b in zip(want, got, strict=True):
            assert np.asarray(a).tobytes() == b.numpy().tobytes(), name


_JIT_SCAN = jax.jit(jgriffin._rg_lru_scan)


@pytest.mark.parametrize("s", [1, 2, 7, 8, 16, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan_is_the_reference_tree(s, with_h0):
    rng = np.random.default_rng(s + 100 * with_h0)
    a = rng.uniform(0.3, 1.0, (2, s, 24)).astype(np.float32)
    bx = rng.standard_normal((2, s, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32) if with_h0 else None
    args = (jnp.asarray(a), jnp.asarray(bx), None if h0 is None else jnp.asarray(h0))
    got = tgriffin._rg_lru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                                None if h0 is None else torch.from_numpy(h0)).numpy()
    assert np.array_equal(got, np.asarray(jgriffin._rg_lru_scan(*args)))
    assert _rel(got, _JIT_SCAN(*args)) <= 1e-6
    # the scan's recurrence, sequentially in f64
    h = np.zeros((2, 24)) if h0 is None else h0.astype(np.float64)
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
    assert _rel(got[:, -1], h) <= 1e-5


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_prefill_then_decode_matches_reference(block):
    jcfg, tcfg = block["jcfg"], block["tcfg"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 19, jcfg.d_model)).astype(np.float32)
    jc = jgriffin.init_rglru_cache(jcfg, 2, jnp.float32)
    tc = tgriffin.init_rglru_cache(tcfg, 2, torch.float32, device="cpu")
    jy, jc = jgriffin.griffin_apply(block["jp"], jnp.asarray(x), block["jctx"], jcfg, jc)
    ty, tc = tgriffin.griffin_apply(block["tp"], torch.from_numpy(x), block["tctx"], tcfg, tc)
    assert _rel(ty.numpy(), jy) <= RTOL
    assert _rel(tc.conv.numpy(), jc.conv) <= RTOL and _rel(tc.h.numpy(), jc.h) <= RTOL
    for step in range(3):
        tok = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jgriffin.griffin_apply(block["jp"], jnp.asarray(tok), block["jctx"], jcfg, jc)
        ty, tc = tgriffin.griffin_apply(block["tp"], torch.from_numpy(tok), block["tctx"], tcfg,
                                        tc)
        assert ty.shape == (2, 1, jcfg.d_model)
        assert _rel(ty.numpy(), jy) <= RTOL and _rel(tc.h.numpy(), jc.h) <= RTOL, step


def test_no_cache_forward_matches_reference(block):
    x = np.random.default_rng(8).standard_normal((1, 40, 64)).astype(np.float32)
    jy, jc = jgriffin.griffin_apply(block["jp"], jnp.asarray(x), block["jctx"], block["jcfg"])
    ty, tc = tgriffin.griffin_apply(block["tp"], torch.from_numpy(x), block["tctx"],
                                    block["tcfg"])
    assert jc is None and tc is None
    assert _rel(ty.numpy(), jy) <= RTOL
