"""Three-term roofline model of one step on an NVIDIA H100 SXM, port of
``repro.analysis.roofline`` (the formulas unchanged, the card's peaks in
place of the reference's).

    compute term    = FLOPs_per_device / peak_FLOP/s                [s]
    memory term     = bytes_per_device / HBM_bw                     [s]
    collective term = wire_bytes_per_device / link_bw               [s]

The per-device figures are one rank's step as dispatched
(``analysis.cost``). The dominant term is the bottleneck; the roofline
fraction of a step is model_useful_time / max(term)s, and MODEL_FLOPS /
counted FLOPs measures how much dispatched compute is useful (catching
remat and padding waste).

The peaks are NVIDIA's H100 SXM data sheet's, dense (no sparsity), at the
card's 700 W power limit: 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s
of HBM3, and 450 GB/s of NVLink in one direction, one link counted per
card as the reference counts one. A card set below 700 W runs slower
under load; every time derived here is a bound computed from shapes, not
a measurement.
"""

from __future__ import annotations

import dataclasses

#: the card these peaks are for
CARD = "NVIDIA H100 SXM, 700 W"
PEAK_FLOPS_BF16 = 989e12  # per card, dense
HBM_BW = 3.35e12  # bytes/s per card
LINK_BW = 450e9  # bytes/s per card, NVLink one direction


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    wire_bytes_per_dev: float
    model_flops_total: float  # 6ND / 2ND-style useful flops (whole step)
    collective_counts: dict
    model_bytes_total: float = 0.0  # minimal bytes a perfect step must move

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        """Roofline step time: the max term (perfect overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips)."""
        total = self.flops_per_dev * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the relevant roofline achieved (the reported score).

        Compute-dominated steps score useful-FLOPs MFU; memory-dominated
        steps (decode) score useful-bytes/HBM-roofline -- the larger of the
        two, since whichever resource the workload fundamentally needs sets
        its roofline.
        """
        t = self.t_step
        if t <= 0:
            return 0.0
        f_flops = self.model_flops_total / (self.chips * PEAK_FLOPS_BF16 * t)
        f_bytes = self.model_bytes_total / (self.chips * HBM_BW * t)
        return max(f_flops, f_bytes)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_total,
            "model_bytes": self.model_bytes_total,
            "hlo_flops_per_dev": self.flops_per_dev,
            "useful_flops_frac": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collective_counts,
        }


def model_bytes(
    cell,
    cache_bytes: float,
    param_bytes: float,
    n_params: int,
    n_active_params: int,
) -> float:
    """Minimal HBM traffic for one step: weights once (+cache for serving).

    train: params read in fwd+bwd + grads + opt state ~ 3x param bytes as a
    floor; prefill/decode: routed-active params once + the KV/state cache.
    """
    if cell.kind == "train":
        return 3.0 * param_bytes
    active_frac = n_active_params / max(n_params, 1)
    return param_bytes * active_frac + cache_bytes


def model_flops(cfg, n_params: int, n_active_params: int, cell) -> float:
    """Useful FLOPs for one step of a shape cell.

    train: 6 * N_active * tokens; prefill: 2 * N_active * tokens;
    decode: 2 * N_active * batch (one token per sequence).
    """
    if cell.kind == "train":
        return 6.0 * n_active_params * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active_params * cell.global_batch * cell.seq_len
    return 2.0 * n_active_params * cell.global_batch


def active_params(cfg, n_params: int) -> int:
    """MoE: count only routed-active expert weights (+ everything else)."""
    if cfg.family != "moe" or not cfg.n_experts:
        return n_params
    expert_block = 3 * cfg.d_model * cfg.d_ff  # w1, w3, w2
    n_moe_layers = cfg.n_layers // max(cfg.moe_every, 1)
    total_expert = n_moe_layers * cfg.n_experts * expert_block
    active_expert = n_moe_layers * cfg.top_k * expert_block
    return n_params - total_expert + active_expert
