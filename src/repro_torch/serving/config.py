"""Serving configuration, port of ``repro.serving.config.ServingConfig``.

The fields this slice serves: slot count, per-slot capacity and whether the
digital-reference counters run. The paged-cache, fused-decode and fleet
settings arrive with their slices.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Plain-value configuration of one ServingEngine.

    ``n_slots``: decode slots (the continuous-batching width). ``s_max``:
    per-slot capacity in tokens (prompt + budget). ``ref_check``: run the
    digital-reference accuracy counters when the engine has ``ref_params``.
    """

    n_slots: int
    s_max: int
    ref_check: bool = True

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError("need at least one decode slot")
        if self.s_max < 1:
            raise ValueError(f"s_max must be >= 1, got {self.s_max}")
