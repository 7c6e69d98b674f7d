"""Serving configuration, port of ``repro.serving.config.ServingConfig``.

The fields ported so far: slot count, per-slot capacity, whether the
digital-reference counters run, and fused decode. The paged-cache and
fleet settings arrive with their slices.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Plain-value configuration of one ServingEngine.

    ``n_slots``: decode slots (the continuous-batching width). ``s_max``:
    per-slot capacity in tokens (prompt + budget). ``ref_check``: run the
    digital-reference accuracy counters when the engine has ``ref_params``.
    ``fused_decode``: execute the whole programmed decode step as ONE
    kernel launch (``kernels/decode_fused.py``). Requires a compiled
    ``CiMProgram`` whose plans pass ``engine.build_fused_plan``; on the CPU
    it is bitwise the per-layer decode. The reference also refuses it
    together with the paged KV cache; that check arrives here with the
    ``paged`` field.
    """

    n_slots: int
    s_max: int
    ref_check: bool = True
    fused_decode: bool = False

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError("need at least one decode slot")
        if self.s_max < 1:
            raise ValueError(f"s_max must be >= 1, got {self.s_max}")
