"""Calibrated PCM statistical model (paper Sec. 6.1), port of ``repro.core.pcm``.

Bitwise the reference on the CPU: noise draws take a threefry key and draw
through the RNG bridge (``repro_torch.prng``), the drift law and the read-
noise coefficient use the bridge's ``powf``, its ``log`` and correctly
rounded ``sqrt``, and every multiply-add the reference's compiled code
fuses is one exact FMA here (``prng.fma``). ``det_sum`` sums on a fixed-
point grid, so it is the same bits under any reduction order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import prng

Tensor = torch.Tensor

G_MAX_US = 25.0  # uS, maximal device conductance (paper Appendix C)
T_C = 25.0  # s, reference time of programming for the drift law
T_READ = 250e-9  # s, read-noise reference time

#: The paper's Fig. 7 evaluation ages.
FIG7_TIMES: dict[str, float] = {
    "25s": T_C,
    "1h": 3600.0,
    "1d": 86400.0,
    "1mo": 30 * 86400.0,
    "1y": 365 * 86400.0,
}


def log_spaced_times(t_start: float, t_end: float, n: int) -> tuple[float, ...]:
    """Up to ``n`` log-spaced chip ages in [max(t_start, t_c), t_end],
    strictly increasing, endpoints exact."""
    if n < 1:
        raise ValueError(f"need at least one checkpoint, got n={n}")
    t0 = max(float(t_start), T_C)
    t1 = max(float(t_end), t0)
    if n == 1 or t1 == t0:
        return (t1,)
    la, lb = math.log(t0), math.log(t1)
    ts = [math.exp(la + (lb - la) * i / (n - 1)) for i in range(n)]
    ts[0], ts[-1] = t0, t1
    out: list[float] = []
    for t in ts:
        if not out or t > out[-1]:
            out.append(t)
    return tuple(out)


def format_age(t_seconds: float) -> str:
    """Human label for a chip age: 25s, 1h, 1d, 1mo, 1y, 2.5d, ..."""
    for unit, sec in (("y", 365 * 86400.0), ("mo", 30 * 86400.0),
                      ("d", 86400.0), ("h", 3600.0), ("min", 60.0)):
        if t_seconds >= sec * 0.98:
            v = t_seconds / sec
            return f"{v:.0f}{unit}" if abs(v - round(v)) < 5e-3 else f"{v:.1f}{unit}"
    return (f"{t_seconds:.0f}s" if abs(t_seconds - round(t_seconds)) < 5e-3
            else f"{t_seconds:.1f}s")


@dataclasses.dataclass(frozen=True)
class PCMConfig:
    g_max: float = G_MAX_US
    drift_nu_mean: float = 0.06
    drift_nu_std: float = 0.02
    programming_noise: bool = True
    drift: bool = True
    read_noise: bool = True
    gdc: bool = True  # global drift compensation


def weights_to_conductances(w: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Rescale W to [-1,1] and split into differential (G+, G-) fractions.

    Returns (g_pos, g_neg, w_scale), W = (g_pos - g_neg) * w_scale.
    """
    w_scale = w.abs().max() + 1e-12
    return (*split_conductances(w, w_scale), w_scale)


def split_conductances(w: Tensor, w_scale: Tensor) -> tuple[Tensor, Tensor]:
    """(G+, G-) fractions of ``w`` (or of a slice of it) at ``w_scale``."""
    g = w / w_scale
    return g.clamp(min=0.0), (-g).clamp(min=0.0)


def programming_noise_sigma(g_frac: Tensor, g_max: float = G_MAX_US) -> Tensor:
    """sigma_P in fraction-of-G_max units for target fraction g_frac."""
    g = g_frac.float()
    quad = prng.fma(torch.full_like(g, prng._f32(1.9650)), g, (g * g) * prng._f32(-1.1731))
    sigma_us = (quad + prng._f32(0.2635)).clamp(min=0.0)
    # the reference's compiler divides by a constant as a multiply by its
    # f32 reciprocal
    return sigma_us * _recip(g_max)


def program(key: Tensor, g_target: Tensor, cfg: PCMConfig = PCMConfig(),
            offset: int = 0, stride=None) -> Tensor:
    """Apply programming (write) noise to target conductance fractions
    (``offset``, ``stride``: ``g_target`` is a slice of a larger block whose
    flat index starts there, with rows ``stride`` apart, see
    ``prng.normal``)."""
    if not cfg.programming_noise:
        return g_target
    sigma = programming_noise_sigma(g_target, cfg.g_max)
    g = prng.fma(sigma, prng.normal(key, g_target.shape, offset, stride), g_target)
    return g.clamp(0.0, 1.2)


def sample_drift_nu(key: Tensor, shape, cfg: PCMConfig = PCMConfig(),
                    offset: int = 0, stride=None) -> Tensor:
    """Per-device drift exponent nu ~ N(mean, std), truncated at 0."""
    # std * (e * sqrt2) compiles to e * (std * sqrt2), one FMA with the mean
    e = prng.normal_erf_inv(key, shape, offset, stride)
    scale = prng._f32(cfg.drift_nu_std) * torch.tensor(prng.SQRT2, device=e.device)
    nu = prng.fma(e, scale.expand(e.shape), cfg.drift_nu_mean)
    return nu.clamp(min=0.0)


def _recip(c: float) -> float:
    """The f32 reciprocal of the f32 constant ``c`` (IEEE f32 division, on
    the host)."""
    return float(np.float32(1.0) / np.float32(c))


def _age(t_seconds, device) -> Tensor:
    return torch.as_tensor(t_seconds, dtype=torch.float32, device=device)


def drift_factor(nu: Tensor, t_seconds) -> Tensor:
    """Multiplicative drift law (t/t_c)^-nu, defined for t >= t_c."""
    t = _age(t_seconds, nu.device)
    t = torch.maximum(t, torch.full_like(t, T_C))
    return prng.powf(t * _recip(T_C), -nu)


def drift(key: Tensor, g_prog: Tensor, t_seconds, cfg: PCMConfig = PCMConfig(),
          offset: int = 0, stride=None) -> Tensor:
    """Conductance drift G_D = G_P (t/t_c)^-nu with per-device nu
    (``offset``, ``stride``: as :func:`program`'s)."""
    if not cfg.drift:
        return g_prog
    nu = sample_drift_nu(key, g_prog.shape, cfg, offset, stride)
    return g_prog * drift_factor(nu, t_seconds)


def read_noise_q(g_target: Tensor) -> Tensor:
    """Device 1/f noise coefficient Q(G_T) = min(0.0088/g^0.65, 0.2)."""
    g = g_target.float().clamp(min=prng._f32(1e-9))
    # the reference's compiler rewrites a / x**c as a * x**-c
    q = prng._f32(0.0088) * prng.powf(g, torch.tensor(-0.65, device=g.device))
    return q.clamp(max=0.2)


def read_noise_scale(t_seconds, device=None) -> Tensor:
    """Time growth of the 1/f read noise: sqrt(log((t + t_r)/t_r))."""
    t = _age(t_seconds, device)
    t_r = prng._f32(T_READ)
    return prng.sqrt(prng.log((t + t_r) * _recip(T_READ)))


def read_noise_sigma(g_drifted: Tensor, g_target: Tensor, t_seconds) -> Tensor:
    """Instantaneous 1/f read-noise sigma at time t (fractions of G_max)."""
    return g_drifted * read_noise_q(g_target) * read_noise_scale(t_seconds, g_drifted.device)


def read(key: Tensor, g_drifted: Tensor, g_target: Tensor, t_seconds,
         cfg: PCMConfig = PCMConfig(), offset: int = 0, stride=None) -> Tensor:
    """Sample effective conductances at MVM time (adds 1/f read noise;
    ``offset``, ``stride``: as :func:`program`'s)."""
    if not cfg.read_noise:
        return g_drifted
    sigma = read_noise_sigma(g_drifted, g_target, t_seconds)
    g = prng.fma(sigma, prng.normal(key, g_drifted.shape, offset, stride), g_drifted)
    return g.clamp(min=0.0)


def gdc_scale(g_target: Tensor, g_now: Tensor, axis=None) -> Tensor:
    """Global drift compensation factor: sum(G_T)/sum(G_now) (one scalar).
    ``axis`` (a ``collectives.Axis``): the tensors are a rank's block of the
    layer's, and the sums are the layer's (:func:`det_limbs` summed over
    the axis as integers)."""
    if axis is None:
        return det_sum(g_target) / (det_sum(g_now) + prng._f32(1e-12))
    from repro_torch import collectives

    total = lambda g: det_total(collectives.all_reduce_sum_int(det_limbs(g), axis))
    return total(g_target) / (total(g_now) + prng._f32(1e-12))


DET_SUM_SCALE = float(1 << 20)  # fixed-point grid for deterministic sums


def det_sum(g: Tensor) -> Tensor:
    """Order-independent sum of non-negative conductance fractions.

    Values are rounded to 2^-20 fractions of G_max and summed as 4-bit
    integer limbs: integer addition is associative, so the result is the
    same bits under any reduction order -- and the same bits as the
    reference's int32-limb ``det_sum`` (the limb sums stay below 2^31, so
    torch's int64 accumulation equals JAX's int32 one).
    """
    return det_total(det_limbs(g))


def det_limbs(g: Tensor) -> Tensor:
    """The integer limb sums :func:`det_sum` adds (int64, one per 4-bit
    limb); those of a block's slices add up to the block's exactly (so a
    sharded chip ``all_reduce``s its ranks' limbs as an integer SUM)."""
    v = torch.round(g * DET_SUM_SCALE).to(torch.int32)
    return torch.stack([((v >> shift) & 0xF).sum() for shift in range(0, 24, 4)])


def det_total(limbs: Tensor) -> Tensor:
    """:func:`det_sum` from its limb sums."""
    total = torch.zeros((), dtype=torch.float32, device=limbs.device)
    for i, shift in enumerate(range(0, 24, 4)):
        total = total + limbs[i].to(torch.float32) * float(2**shift)
    return total / DET_SUM_SCALE


def simulate_weights(key: Tensor, w: Tensor, t_seconds, cfg: PCMConfig = PCMConfig(),
                     offset: int = 0, stride=None, axis=None):
    """Full device chain: W -> (program -> drift -> read) -> (w_eff, gdc).

    ``gdc`` is the layer's global-drift-compensation scalar, applied to the
    MVM output digitally.

    ``offset``, ``stride``, ``axis``: ``w`` is a rank's block of a layer
    sharded over ``axis`` (a ``collectives.Axis``) whose draws' counters
    start at ``offset`` with rows ``stride`` apart (``prng.normal``): every
    draw is the rank's slice of the whole layer's, the weight scale the
    layer's (an f32 MAX over the axis) and ``gdc`` the layer's (integer
    limb sums over the axis), so the block is bitwise the whole chain's
    slice.
    """
    t = _age(t_seconds, w.device)
    if axis is None:
        g_pos_t, g_neg_t, w_scale = weights_to_conductances(w)
    else:
        from repro_torch import collectives

        w_scale = collectives.all_reduce_max(w.abs().max(), axis) + 1e-12
        g_pos_t, g_neg_t = split_conductances(w, w_scale)
    k_pp, k_pn, k_dp, k_dn, k_rp, k_rn = prng.split(key, 6)
    at = (offset, stride)
    g_pos = drift(k_dp, program(k_pp, g_pos_t, cfg, *at), t, cfg, *at)
    g_neg = drift(k_dn, program(k_pn, g_neg_t, cfg, *at), t, cfg, *at)
    if cfg.gdc:
        scale = gdc_scale(g_pos_t + g_neg_t, g_pos + g_neg, axis)
    else:
        scale = torch.ones((), dtype=torch.float32, device=w.device)
    g_pos = read(k_rp, g_pos, g_pos_t, t, cfg, *at)
    g_neg = read(k_rn, g_neg, g_neg_t, t, cfg, *at)
    return ((g_pos - g_neg) * w_scale).to(w.dtype), scale
