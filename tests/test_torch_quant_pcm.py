"""Port parity: quantizers and the PCM model (repro_torch.core.quant / .pcm).

The same numpy inputs, made from a seed, go through the JAX reference and
the port. Tolerances: ``fake_quant``, the DAC/ADC quantizers and ``det_sum``
are bitwise (identical IEEE ops on identical f32 inputs; det_sum sums
integer limbs); the rest of the PCM model is within 1e-6 relative (pow/log
implementations may differ in the last ulp). Noise draws use different RNGs
in the two packages, so they are held to the model's distributions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pcm as jpcm
from repro.core import quant as jquant
from repro_torch import prng
from repro_torch.core import pcm as tpcm
from repro_torch.core import quant as tquant


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("bits", [4, 6, 8, 9])
@pytest.mark.parametrize("r_max", [0.37, 1.0, -2.5])
def test_fake_quant_bitwise(bits, r_max):
    x = np.random.default_rng(bits).standard_normal((64, 257)).astype(np.float32) * 2
    r = np.float32(r_max)
    want = np.asarray(jquant.fake_quant(jnp.asarray(x), jnp.asarray(r), bits))
    got = _np(tquant.fake_quant(_t(x), _t(r), bits))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_fake_quant_promotes_bf16_like_jax():
    x = np.random.default_rng(0).standard_normal((32, 33)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    r = np.float32(1.3)
    want = np.asarray(
        jquant.fake_quant(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(r), 8)
    )
    got = tquant.fake_quant(xb, _t(r), 8)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("b_adc", [4, 6, 8])
def test_dac_adc_quantize_bitwise(b_adc):
    rng = np.random.default_rng(b_adc)
    x = rng.standard_normal((16, 100)).astype(np.float32)
    r_adc, gain_s, w_max = (np.float32(v) for v in (0.8, -1.7, 0.45))
    jspec, tspec = jquant.QuantSpec(b_adc=b_adc), tquant.QuantSpec(b_adc=b_adc)
    assert jspec.b_dac == tspec.b_dac == b_adc + 1
    j = [jnp.asarray(v) for v in (r_adc, gain_s, w_max)]
    t = [_t(v) for v in (r_adc, gain_s, w_max)]
    assert np.array_equal(_np(tquant.dac_range(*t)), np.asarray(jquant.dac_range(*j)))
    want = np.asarray(jquant.dac_quantize(jnp.asarray(x), *j, jspec))
    assert np.array_equal(_np(tquant.dac_quantize(_t(x), *t, tspec)), want)
    want = np.asarray(jquant.adc_quantize(jnp.asarray(x), j[0], jspec))
    assert np.array_equal(_np(tquant.adc_quantize(_t(x), t[0], tspec)), want)


def test_validate_b_adc_matches_reference():
    assert tquant.SUPPORTED_B_ADC == jquant.SUPPORTED_B_ADC
    for b in (4, 6, 8):
        assert tquant.validate_b_adc(b) == jquant.validate_b_adc(b)
    for b in (3, 5, 16):
        with pytest.raises(ValueError):
            tquant.validate_b_adc(b)


@pytest.mark.parametrize("shape", [(7,), (64, 130), (3, 128, 96)])
def test_det_sum_bitwise(shape):
    g = np.random.default_rng(len(shape)).uniform(0, 2.4, shape).astype(np.float32)
    want = np.asarray(jpcm.det_sum(jnp.asarray(g)))
    got = _np(tpcm.det_sum(_t(g)))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # order independence: a permutation sums to the same bits
    perm = np.random.default_rng(1).permutation(g.reshape(-1))
    assert _np(tpcm.det_sum(_t(perm))).tobytes() == want.tobytes()


def test_pcm_constants_and_config():
    assert (tpcm.G_MAX_US, tpcm.T_C, tpcm.T_READ) == (jpcm.G_MAX_US, jpcm.T_C, jpcm.T_READ)
    assert tpcm.FIG7_TIMES == jpcm.FIG7_TIMES
    assert tpcm.DET_SUM_SCALE == jpcm.DET_SUM_SCALE
    assert dataclasses.asdict(tpcm.PCMConfig()) == dataclasses.asdict(jpcm.PCMConfig())
    for t in (25.0, 60.0, 3600.0, 9000.0, 86400.0, 2.5 * 86400, 3.15e7, 12.3):
        assert tpcm.format_age(t) == jpcm.format_age(t)
    for args in ((1.0, 1e6, 5), (25.0, 25.0, 3), (100.0, 3.15e7, 1)):
        assert tpcm.log_spaced_times(*args) == jpcm.log_spaced_times(*args)


def test_pcm_deterministic_model_within_1e6():
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((96, 80)) * 0.3).astype(np.float32)
    jg = jpcm.weights_to_conductances(jnp.asarray(w))
    tg = tpcm.weights_to_conductances(_t(w))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=0)
    g = rng.uniform(0, 1.2, (50, 40)).astype(np.float32)
    pairs = [
        (tpcm.programming_noise_sigma(_t(g)), jpcm.programming_noise_sigma(jnp.asarray(g))),
        (tpcm.read_noise_q(_t(g)), jpcm.read_noise_q(jnp.asarray(g))),
    ]
    nu = rng.uniform(0, 0.12, (50, 40)).astype(np.float32)
    for t in (25.0, 3600.0, 86400.0, 3.15e7):
        pairs.append((tpcm.drift_factor(_t(nu), t),
                      jpcm.drift_factor(jnp.asarray(nu), jnp.float32(t))))
        pairs.append((tpcm.read_noise_scale(t), jpcm.read_noise_scale(jnp.float32(t))))
    for a, b in pairs:
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-12)


def test_pcm_noise_draws_follow_the_model():
    k_nu, k_prog = prng.split(prng.PRNGKey(0))
    nu = tpcm.sample_drift_nu(k_nu, (200_000,))
    assert abs(float(nu.mean()) - 0.06) < 1e-3
    assert abs(float(nu.std()) - 0.02) / 0.02 < 0.05
    assert float(nu.min()) >= 0.0
    g_t = torch.full((200_000,), 0.5)
    g = tpcm.program(k_prog, g_t)
    sigma = float(tpcm.programming_noise_sigma(torch.tensor(0.5)))
    assert abs(float((g - g_t).std()) - sigma) / sigma < 0.05
    assert float(g.min()) >= 0.0 and float(g.max()) <= 1.2
    off = tpcm.PCMConfig(programming_noise=False)
    assert tpcm.program(k_prog, g_t, off) is g_t
