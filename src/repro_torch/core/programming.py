"""Closed-loop (write-verify) PCM programming (paper Sec. 6.3, Joshi et
al.), port of ``repro.core.programming``.

The prototype chip programs devices iteratively: program, read back,
correct -- until the conductance is within a tolerance or the pulse budget
is spent (>99% convergence overall, ~98.5% for large weights):

    g_0 = G_T + N(0, sigma_P(G_T))                 (initial shot)
    g_{i+1} = g_i + kappa * (G_T - g_i) + N(0, sigma_P(G_T) * beta)

Devices with |g - G_T| <= tol stop updating (read-verify). Every draw goes
through the RNG bridge with the reference's keys -- one ``split`` and one
``normal`` per pulse -- and the arithmetic takes the reference's compiled
forms (``prng.fma`` where its compiler fuses a product into a sum), so a
key gives the reference's conductances bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.core import pcm as pcm_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class WriteVerifyConfig:
    n_iter: int = 12  # programming pulses budget per device
    kappa: float = 0.7  # fraction of the residual corrected per pulse
    beta: float = 0.5  # re-program noise relative to initial-shot sigma
    tol: float = 0.015  # acceptance band, fraction of G_max (~0.4 uS)


def program_write_verify(
    key: Tensor,
    g_target: Tensor,
    wv: WriteVerifyConfig = WriteVerifyConfig(),
    cfg: pcm_lib.PCMConfig = pcm_lib.PCMConfig(),
) -> tuple[Tensor, Tensor]:
    """Iteratively program conductances. Returns (g_programmed, converged):
    ``converged`` is |g - G_T| <= tol per device at exit."""
    sigma0 = pcm_lib.programming_noise_sigma(g_target, cfg.g_max)
    tol = prng._f32(wv.tol)
    k0, key = prng.split(key)
    g = prng.fma(sigma0, prng.normal(k0, g_target.shape), g_target).clamp(0.0, 1.2)
    noise_scale = sigma0 * prng._f32(wv.beta)
    kappa = torch.full_like(g, prng._f32(wv.kappa))
    for _ in range(wv.n_iter):
        key, sub = prng.split(key)
        resid = g_target - g
        done = resid.abs() <= tol
        # the reference's compiler fuses both products: the correction into
        # g, then the noise into that sum
        g_new = prng.fma(noise_scale, prng.normal(sub, g.shape),
                         prng.fma(kappa, resid, g)).clamp(0.0, 1.2)
        g = torch.where(done, g, g_new)
    return g, (g - g_target).abs() <= tol


def simulate_weights_write_verify(
    key: Tensor,
    w: Tensor,
    t_seconds,
    cfg: pcm_lib.PCMConfig = pcm_lib.PCMConfig(),
    wv: WriteVerifyConfig = WriteVerifyConfig(),
) -> tuple[Tensor, Tensor, Tensor]:
    """``pcm.simulate_weights`` with closed-loop programming: returns
    (w_eff, gdc_scale, convergence_rate), the simulator upgrade the paper
    flags in Sec. 6.3."""
    t = pcm_lib._age(t_seconds, w.device)
    g_pos_t, g_neg_t, w_scale = pcm_lib.weights_to_conductances(w)
    k_pp, k_pn, k_dp, k_dn, k_rp, k_rn = prng.split(key, 6)
    g_pos, conv_p = program_write_verify(k_pp, g_pos_t, wv, cfg)
    g_neg, conv_n = program_write_verify(k_pn, g_neg_t, wv, cfg)
    convergence = (conv_p.float().mean() + conv_n.float().mean()) / 2.0
    g_pos = pcm_lib.drift(k_dp, g_pos, t, cfg)
    g_neg = pcm_lib.drift(k_dn, g_neg, t, cfg)
    if cfg.gdc:
        scale = pcm_lib.gdc_scale(g_pos_t + g_neg_t, g_pos + g_neg)
    else:
        scale = torch.ones((), dtype=torch.float32, device=w.device)
    g_pos = pcm_lib.read(k_rp, g_pos, g_pos_t, t, cfg)
    g_neg = pcm_lib.read(k_rn, g_neg, g_neg_t, t, cfg)
    return ((g_pos - g_neg) * w_scale).to(w.dtype), scale, convergence
