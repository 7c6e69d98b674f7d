"""Calibrated PCM statistical model (paper Sec. 6.1), port of ``repro.core.pcm``.

The deterministic half (conductance mapping, noise sigmas, drift law, read-
noise scale, ``det_sum``) computes what the reference computes; ``det_sum``
is bitwise. Noise draws take an explicit ``torch.Generator``: they follow
the reference's distributions but not its threefry bits.
"""

from __future__ import annotations

import dataclasses
import math

import torch

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
    g = w / w_scale
    return g.clamp(min=0.0), (-g).clamp(min=0.0), w_scale


def programming_noise_sigma(g_frac: Tensor, g_max: float = G_MAX_US) -> Tensor:
    """sigma_P in fraction-of-G_max units for target fraction g_frac."""
    sigma_us = (-1.1731 * g_frac**2 + 1.9650 * g_frac + 0.2635).clamp(min=0.0)
    return sigma_us / g_max


def _normal(gen: torch.Generator, like: Tensor) -> Tensor:
    return torch.randn(
        like.shape, generator=gen, dtype=torch.float32, device=like.device
    )


def program(
    gen: torch.Generator, g_target: Tensor, cfg: PCMConfig = PCMConfig()
) -> Tensor:
    """Apply programming (write) noise to target conductance fractions."""
    if not cfg.programming_noise:
        return g_target
    sigma = programming_noise_sigma(g_target, cfg.g_max)
    g = g_target + sigma * _normal(gen, g_target)
    return g.clamp(0.0, 1.2)


def sample_drift_nu(
    gen: torch.Generator, like: Tensor, cfg: PCMConfig = PCMConfig()
) -> Tensor:
    """Per-device drift exponent nu ~ N(mean, std), truncated at 0."""
    nu = cfg.drift_nu_mean + cfg.drift_nu_std * _normal(gen, like)
    return nu.clamp(min=0.0)


def drift_factor(nu: Tensor, t_seconds) -> Tensor:
    """Multiplicative drift law (t/t_c)^-nu, defined for t >= t_c."""
    t = torch.as_tensor(t_seconds, dtype=torch.float32, device=nu.device)
    t = torch.maximum(t, torch.full_like(t, T_C))
    return (t / T_C) ** (-nu)


def read_noise_q(g_target: Tensor) -> Tensor:
    """Device 1/f noise coefficient Q(G_T) = min(0.0088/g^0.65, 0.2)."""
    return (0.0088 / g_target.clamp(min=1e-9) ** 0.65).clamp(max=0.2)


def read_noise_scale(t_seconds, device=None) -> Tensor:
    """Time growth of the 1/f read noise: sqrt(log((t + t_r)/t_r))."""
    t = torch.as_tensor(t_seconds, dtype=torch.float32, device=device)
    return torch.sqrt(torch.log((t + T_READ) / T_READ))


DET_SUM_SCALE = float(1 << 20)  # fixed-point grid for deterministic sums


def det_sum(g: Tensor) -> Tensor:
    """Order-independent sum of non-negative conductance fractions.

    Values are rounded to 2^-20 fractions of G_max and summed as 4-bit
    integer limbs: integer addition is associative, so the result is the
    same bits under any reduction order -- and the same bits as the
    reference's int32-limb ``det_sum`` (the limb sums stay below 2^31, so
    torch's int64 accumulation equals JAX's int32 one).
    """
    v = torch.round(g * DET_SUM_SCALE).to(torch.int32)
    total = torch.zeros((), dtype=torch.float32, device=g.device)
    for shift in range(0, 24, 4):
        limb_sum = ((v >> shift) & 0xF).sum()
        total = total + limb_sum.to(torch.float32) * float(2**shift)
    return total / DET_SUM_SCALE
