"""The training half of the port's quantizers and noise injection against
the reference, on the CPU (``core/quant.py``, ``core/noise.py``,
``prng.bernoulli``):

* ``round_ste``, ``fake_quant`` (values and the VJP in x and r, clipped
  and unclipped elements, ties at the clip), ``quant_noise`` and the keyed
  ``dac_quantize``/``adc_quantize``: values bitwise, input gradients equal
  (the sign of a zero aside), range gradients -- sums over the elements
  with cancellation, added in another order (measured worst 2e-5
  relative) -- within ``RANGE_RTOL``, against ``jax.vjp``;
* ``prng.bernoulli`` against ``jax.random.bernoulli`` over shapes and p;
* ``noise.inject``'s draw against the reference's, jitted as its train
  step runs it (the compiler fuses the noise into one FMA), and its
  straight-through gradient;
* ``clip_ranges_from_std`` (within one f32 rounding of ``jnp.std``: the
  reductions add in another order), ``layer_noise_key`` bitwise,
  ``init_quant_params`` and ``clip_s_gradient``;
* ``|.|`` at 0 takes JAX's subgradient (+1) in every range gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.core import noise as jnoise
from repro.core import quant as jquant
from repro_torch import prng
from repro_torch.core import noise as tnoise
from repro_torch.core import quant as tquant


#: range gradients sum every element's term in another order than XLA's
RANGE_RTOL = 1e-4


def _key(k) -> torch.Tensor:
    return torch.tensor(np.asarray(k).astype(np.int64))


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _equal(a, b) -> bool:
    """Equal values, dtype and shape; a gradient's zeros may differ in sign
    (0 * -g is -0 in one package and +0 in the other)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _torch_vjp(fn, args, g):
    ts = [torch.tensor(np.asarray(a)).requires_grad_() for a in args]
    y = fn(*ts)
    grads = torch.autograd.grad(y, ts, torch.tensor(np.asarray(g)), allow_unused=True)
    return y.detach().numpy(), [None if x is None else x.numpy() for x in grads]


def _inputs(seed, shape=(6, 37)):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2.0).astype(np.float32)
    x.flat[:3] = [1.5, -1.5, 1.5]  # exactly at the clip: a tie of maximum/minimum
    g = rng.normal(size=shape).astype(np.float32)
    return x, g


def test_round_ste_values_and_straight_through_gradient():
    x, g = _inputs(0)
    x.flat[3:7] = [0.5, 1.5, -2.5, 2.5]  # halves round to even
    y, (gx,) = _torch_vjp(tquant.round_ste, [x], g)
    jy, jvjp = jax.vjp(jquant.round_ste, jnp.asarray(x))
    assert _bits_equal(y, jy)
    assert _equal(gx, jvjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("bits", [4, 6, 8, 9])
def test_fake_quant_values_and_vjp_bitwise(bits):
    x, g = _inputs(bits)
    r = np.float32(1.5)
    y, (gx, gr) = _torch_vjp(lambda a, b: tquant.fake_quant(a, b, bits), [x, r], g)
    jy, jvjp = jax.vjp(lambda a, b: jquant.fake_quant(a, b, bits), jnp.asarray(x),
                       jnp.asarray(r))
    jgx, jgr = jvjp(jnp.asarray(g))
    assert _bits_equal(y, jy)
    assert _equal(gx, jgx)
    np.testing.assert_allclose(gr, jgr, rtol=RANGE_RTOL)


@pytest.mark.parametrize("p", [0.5, 0.25, 1.0])
def test_quant_noise_and_keyed_quantizers_bitwise(p):
    x, g = _inputs(11, (4, 5, 23))
    r_adc, gain, w_max = np.float32(2.0), np.float32(1.3), np.float32(0.4)
    spec_j = jquant.QuantSpec(b_adc=6, quant_noise_p=p)
    spec_t = tquant.QuantSpec(b_adc=6, quant_noise_p=p)
    key = jax.random.PRNGKey(3)
    y, grads = _torch_vjp(
        lambda a, r, s, wm: tquant.dac_quantize(a, r, s, wm, spec_t, _key(key)),
        [x, r_adc, gain, w_max], g)
    jy, jvjp = jax.vjp(lambda a, r, s, wm: jquant.dac_quantize(a, r, s, wm, spec_j, key),
                       *map(jnp.asarray, (x, r_adc, gain, w_max)))
    jg = jvjp(jnp.asarray(g))
    assert _bits_equal(y, jy)
    assert _equal(grads[0], jg[0])
    for a, b in zip(grads[1:], jg[1:]):
        np.testing.assert_allclose(a, b, rtol=RANGE_RTOL)
    y, grads = _torch_vjp(lambda a, r: tquant.adc_quantize(a, r, spec_t, _key(key)),
                          [x, r_adc], g)
    jy, jvjp = jax.vjp(lambda a, r: jquant.adc_quantize(a, r, spec_j, key),
                       jnp.asarray(x), jnp.asarray(r_adc))
    jg = jvjp(jnp.asarray(g))
    assert _bits_equal(y, jy) and _equal(grads[0], jg[0])
    np.testing.assert_allclose(grads[1], jg[1], rtol=RANGE_RTOL)
    xq = jquant.fake_quant(jnp.asarray(x), 2.0, 6)
    assert _bits_equal(
        tquant.quant_noise(torch.tensor(x), torch.tensor(np.asarray(xq)), _key(key), p),
        jquant.quant_noise(jnp.asarray(x), xq, key, p))
    # no key, or p >= 1: plain quantization
    assert tquant.quant_noise(torch.tensor(x), torch.tensor(np.asarray(xq)), None, p) is not None


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (64, 2, 13), (2, 49, 10, 106)])
def test_bernoulli_bitwise(shape, p):
    key = jax.random.fold_in(jax.random.PRNGKey(5), len(shape))
    want = np.asarray(jax.random.bernoulli(key, p, shape))
    got = prng.bernoulli(_key(key), p, shape)
    assert got.dtype == torch.bool
    assert _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("eta", [0.1, 0.05])
def test_inject_draw_bitwise_and_straight_through(eta):
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(97, 24)) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(9)
    inject = jax.jit(lambda k, w_, lo, hi: jnoise.inject(k, w_, eta, lo, hi))
    for w_max in rng.uniform(0.02, 0.5, 6).astype(np.float32):
        w_min = np.float32(-0.8 * w_max)
        want = inject(key, jnp.asarray(w), jnp.asarray(w_min), jnp.asarray(w_max))
        wt = torch.tensor(w, requires_grad=True)
        got = tnoise.inject(_key(key), wt, eta, torch.tensor(w_min), torch.tensor(w_max))
        assert _bits_equal(got.detach().numpy(), want)
        (gw,) = torch.autograd.grad(got.sum(), wt)
        assert bool((gw == 1).all())
    # the noise is N(0, (eta |w_max|)^2), drawn by jax.random.normal's bits
    noise = tnoise.sample_weight_noise(_key(key), torch.tensor(w), eta, torch.tensor(0.3))
    want = jnoise.sample_weight_noise(key, jnp.asarray(w), eta, jnp.asarray(np.float32(0.3)))
    assert _bits_equal(noise.numpy(), want)
    # no key or eta 0: the STE clip alone
    clip = tnoise.inject(None, torch.tensor(w), eta, torch.tensor(-0.01), torch.tensor(0.02))
    want = jnoise.inject(None, jnp.asarray(w), eta, -0.01, 0.02)
    assert _bits_equal(clip.numpy(), want)


def test_clip_ranges_and_layer_keys():
    rng = np.random.default_rng(4)
    for shape in [(3, 3, 1, 12), (954, 106), (16, 4)]:
        w = (rng.normal(size=shape) * 0.1).astype(np.float32)
        lo, hi = tnoise.clip_ranges_from_std(torch.tensor(w))
        jlo, jhi = jnoise.clip_ranges_from_std(jnp.asarray(w))
        np.testing.assert_allclose([float(lo), float(hi)], [float(jlo), float(jhi)], rtol=1e-6)
    base = jax.random.PRNGKey(17)
    for layer, step in [(0, 0), (3, 11), (7, 2**20)]:
        assert _bits_equal(tnoise.layer_noise_key(_key(base), layer, step).numpy().astype(np.uint32),
                           jnoise.layer_noise_key(base, layer, step))


def test_init_quant_params_and_clip_s_gradient():
    for arg in [(), 3, (2, 4)]:
        got = tquant.init_quant_params(arg)
        want = jquant.init_quant_params(arg)
        assert set(got) == set(want)
        for k in want:
            assert _bits_equal(got[k].numpy(), want[k])
    g = np.array([-1.0, -0.01, -0.004, 0.0, 0.02, 5.0], np.float32)
    assert _bits_equal(tquant.clip_s_gradient(torch.tensor(g)).numpy(),
                       jquant.clip_s_gradient(jnp.asarray(g)))
    assert _bits_equal(tquant.clip_s_gradient(torch.tensor(g), 0.5).numpy(),
                       jquant.clip_s_gradient(jnp.asarray(g), 0.5))


@pytest.mark.parametrize("zero", ["r_adc", "gain_s", "w_max"])
def test_abs_at_zero_takes_jax_subgradient(zero):
    vals = {"r_adc": np.float32(0.7), "gain_s": np.float32(1.2), "w_max": np.float32(0.3)}
    vals[zero] = np.float32(0.0)
    args = [vals["r_adc"], vals["gain_s"], vals["w_max"]]
    g = np.float32(1.0)
    _, grads = _torch_vjp(tquant.dac_range, args, g)
    _, jvjp = jax.vjp(jquant.dac_range, *map(jnp.asarray, args))
    for a, b in zip(grads, jvjp(jnp.asarray(g))):
        assert _equal(a, b)
    # at 0 itself: jax.grad(jnp.abs)(0.0) == 1, torch's own abs gives 0
    x = torch.tensor(0.0, requires_grad=True)
    (gx,) = torch.autograd.grad(tquant.abs_(x), x)
    assert float(gx) == float(jax.grad(jnp.abs)(0.0)) == 1.0
    # fake_quant's range at 0
    xs, gs = _inputs(3)
    _, (gx2, gr) = _torch_vjp(lambda a, b: tquant.fake_quant(a, b, 6), [xs, np.float32(0.0)], gs)
    _, jvjp = jax.vjp(lambda a, b: jquant.fake_quant(a, b, 6), jnp.asarray(xs),
                      jnp.asarray(np.float32(0.0)))
    jgx, jgr = jvjp(jnp.asarray(gs))
    assert _equal(gx2, jgx)
    np.testing.assert_allclose(gr, jgr, rtol=RANGE_RTOL)
