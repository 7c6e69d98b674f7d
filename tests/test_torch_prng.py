"""The RNG bridge (``repro_torch.prng``) against ``jax.random`` itself.

Keys, ``split``, ``fold_in`` and ``bits`` and the samplers ``uniform``,
``randint``, ``choice``, ``exponential`` and ``normal`` are held bitwise
against JAX in partitionable-threefry mode (``repro/__init__.py``), over
several keys and shapes: 0-d, odd sizes, more than 2^16 elements, and 2^20
normal draws with a tail of |u| near 1 (the ``w >= 5`` branch of
``erf_inv``). The float helpers the samplers and the PCM model use --
``log1p``, ``log``, ``erf_inv``, glibc's ``powf`` and the exact ``fma`` --
are held against XLA-CPU's compiled functions and exact arithmetic.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (selects partitionable threefry)
from repro_torch import prng

SEEDS = [0, 1, 7, 42, 123_456, -3]
SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4), (70_001,)]
SMALL_SHAPES = [(), (7,), (3, 5)]


def _k(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert torch.equal(_k(jk), tk)
    for num in (2, 3, 5, (2, 3)):
        assert torch.equal(_k(jax.random.split(jk, num)), prng.split(tk, num))
    for data in (0, 1, 7, 10_000, 1_000_003, 7_000_016, 2**32 - 1):
        assert torch.equal(_k(jax.random.fold_in(jk, data)), prng.fold_in(tk, data))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 42])
def test_bits_uniform_bitwise(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(np.asarray(jax.random.bits(jk, shape)).astype(np.int64),
                          prng.bits(tk, shape).numpy())
    for lo, hi in ((0.0, 1.0), (-0.99999994, 1.0), (-2.5, 3.0)):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        assert np.array_equal(want, prng.uniform(tk, shape, lo, hi).numpy())


@pytest.mark.parametrize("shape", SMALL_SHAPES + [(70_001,)], ids=str)
@pytest.mark.parametrize("lo,hi", [(0, 256), (3, 1000), (-5, 5), (7, 7), (0, 2**31 - 1)])
def test_randint_bitwise(shape, lo, hi):
    jk, tk = jax.random.PRNGKey(lo + 11), prng.PRNGKey(lo + 11)
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    got = prng.randint(tk, shape, lo, hi)
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())


@pytest.mark.parametrize("seed", [0, 42, -3])
def test_choice_and_exponential_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for a, shape in (((8, 16, 24, 32), (9,)), ((2, 4, 6, 8), (1_001,)), ((5,), ())):
        want = np.asarray(jax.random.choice(jk, jnp.asarray(a), shape=shape))
        assert np.array_equal(want, prng.choice(tk, torch.tensor(a), shape).numpy())
    assert np.array_equal(np.asarray(jax.random.choice(jk, 10, shape=(33,))),
                          prng.choice(tk, 10, (33,)).numpy())
    for shape in ((), (6,), (4_097,)):
        want = np.asarray(jax.random.exponential(jk, shape, jnp.float32))
        assert np.array_equal(want, prng.exponential(tk, shape).numpy())


@pytest.mark.parametrize("seed", [3])
def test_normal_bitwise_on_a_million_draws(seed):
    n = 1 << 20
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32))
    got = prng.normal(prng.PRNGKey(seed), (n,)).numpy()
    assert np.array_equal(want, got), f"{(want != got).sum()} of {n} differ"
    # the draws reach the tail branch of erf_inv (w >= 5, |x| > ~2.9)
    assert (np.abs(got) > 3.0).sum() > 1000


@pytest.mark.parametrize("shape", [(), (1,), (5, 7), (4_097,)], ids=str)
def test_normal_bitwise_small_and_odd_shapes(shape):
    for seed in (0, 9):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        assert np.array_equal(want, prng.normal(prng.PRNGKey(seed), shape).numpy())


def test_erf_inv_tail_and_edges_bitwise():
    rng = np.random.default_rng(0)
    u = np.concatenate([
        rng.uniform(-1, 1, 1 << 16),
        1 - rng.uniform(0, 0.01, 1 << 15), -1 + rng.uniform(0, 0.01, 1 << 15),
        np.nextafter(np.float32(1), np.float32(0)) * np.ones(4), [0.0, -0.0, 1.0, -1.0],
    ]).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    assert np.array_equal(want, prng.erf_inv(torch.from_numpy(u)).numpy(), equal_nan=True)


def test_log1p_and_log_bitwise():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-0.9999, 4, 1 << 16), rng.uniform(-1e-3, 1e-3, 1 << 12),
                        [0.0, -0.5, 0.41421354, 0.41421357, -0.41421357, 1e30]]).astype(np.float32)
    assert np.array_equal(np.asarray(jax.jit(jnp.log1p)(x)), prng.log1p(torch.from_numpy(x)).numpy())
    y = np.concatenate([rng.uniform(1e-30, 10, 1 << 14), rng.uniform(1e3, 1e8, 1 << 10),
                        [1.0, 2.0, 0.5, np.inf, 0.0]]).astype(np.float32)
    assert np.array_equal(np.asarray(jax.jit(jnp.log)(y)), prng.log(torch.from_numpy(y)).numpy())


def test_powf_bitwise_on_the_pcm_models_arguments():
    """x ** y on the CPU is glibc's powf: the read-noise coefficient's
    g^-0.65 and the drift law's (t / t_c)^-nu."""
    rng = np.random.default_rng(2)
    power = jax.jit(lambda x, y: x ** y)
    g = np.maximum(rng.uniform(0, 1.2, 1 << 16), 1e-9).astype(np.float32)
    for e in (0.65, -0.65):
        want = np.asarray(power(g, np.float32(e)))
        assert np.array_equal(want, prng.powf(torch.from_numpy(g), torch.tensor(e)).numpy())
    nu = np.maximum(rng.normal(0.06, 0.02, 1 << 16), 0).astype(np.float32)
    for t in (1.0, 144.0, 3456.0, 1_260_000.0, 493.8271):
        base = np.float32(t)
        want = np.asarray(power(base, -nu))
        got = prng.powf(torch.tensor(base), -torch.from_numpy(nu)).numpy()
        assert np.array_equal(want, got)


def test_fma_is_exactly_rounded():
    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal(20_000).astype(np.float32) * s for s in (1.0, 3.0, 1e-3))
    # cancellation-heavy cases: c close to -a*b
    c[:5000] = -(a[:5000].astype(np.float64) * b[:5000]).astype(np.float32)
    got = prng.fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(0, 20_000, 37):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        # the nearest f32, ties to even: compare with both neighbours
        r = np.float32(float(exact))
        lo, hi = np.nextafter(r, np.float32(-np.inf)), np.nextafter(r, np.float32(np.inf))
        best = min((lo, r, hi), key=lambda v: (abs(Fraction(float(v)) - exact),
                                               int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i])


def test_keys_live_on_their_device_and_reject_bad_shapes():
    k = prng.PRNGKey(0)
    assert k.dtype == torch.int64 and k.shape == (2,) and k.device.type == "cpu"
    with pytest.raises(ValueError, match="shape"):
        prng.split(prng.split(k, 3))
    with pytest.raises(ValueError, match="int32"):
        prng.PRNGKey(2**31)


def test_cpu_slices_bitwise_with_a_partial_last_slice():
    """A large CPU draw or ``fma`` runs in ``_CPU_SLICE``-value slices: at a
    size that is no multiple of it, ``bernoulli`` and ``uniform`` are
    bitwise JAX's and a broadcast ``fma`` is bitwise one unsliced pass."""
    shape = (3, 2, 70_001)
    assert np.prod(shape) % prng._CPU_SLICE and np.prod(shape) > prng._CPU_SLICE
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    want = np.asarray(jax.random.bernoulli(jk, 0.5, shape))
    assert np.array_equal(want, prng.bernoulli(tk, 0.5, shape).numpy())
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, -2.0, 3.0))
    assert np.array_equal(want, prng.uniform(tk, shape, -2.0, 3.0).numpy())
    a = torch.rand((3, 1, 70_001), generator=torch.Generator().manual_seed(0))
    b = prng.normal(tk, shape)
    c = torch.rand((2, 1), generator=torch.Generator().manual_seed(1))
    whole = prng._fma(*torch.broadcast_tensors(a, b, c))
    assert torch.equal(prng.fma(a, b, c), whole)
    assert torch.equal(prng.fma(a, b, 0.1), prng._fma(a.expand(shape), b, 0.1))


def test_card_fma_slices_bitwise_one_pass():
    """A card's ``fma`` of more than ``_CARD_SLICE`` values runs in slices
    (``_fma_slices``, here on the CPU at a slice of 1,000): a broadcast
    operand, a scalar addend and a partial last slice, bitwise one pass."""
    g = torch.Generator().manual_seed(2)
    a = torch.rand((3, 1, 2_345), generator=g)
    b = prng.normal(prng.PRNGKey(6), (3, 4, 2_345))
    c = torch.rand((4, 1), generator=g)
    assert torch.equal(prng._fma_slices(a, b, c, 1_000),
                       prng._fma(*torch.broadcast_tensors(a, b, c)))
    assert torch.equal(prng._fma_slices(a, b, 0.1, 1_000), prng._fma(a.expand(b.shape), b, 0.1))
    assert prng._CARD_SLICE >= prng._CPU_SLICE
