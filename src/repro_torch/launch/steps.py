"""Program-phase steps of serving, port of the unsharded half of
``repro.launch.steps``.

:func:`program_for_serving` programs a chip for a serving deployment;
:func:`refresh_program` is what the refresh policy calls to rewrite a
drifted chip from its source weights. Sharded programming is the
distribution slice's work (queue A item 13).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import engine
from repro_torch.core import pcm as pcm_lib
from repro_torch.core.analog import AnalogConfig


def program_for_serving(
    params: Any,
    analog_cfg: AnalogConfig,
    key: torch.Tensor,
    *,
    b_adc_overrides: Optional[dict] = None,
    t_seconds: Optional[float] = None,
    chip_id: Optional[int] = None,
) -> engine.CiMProgram:
    """Program phase of an analog serving deployment -> CiMProgram, on the
    device ``params`` live on. ``t_seconds`` overrides the config's age for
    the first evaluation."""
    return engine.compile_program(
        params, analog_cfg, key, t_seconds=t_seconds,
        b_adc_overrides=b_adc_overrides, chip_id=chip_id,
        device=params.gain_s.device,
    )


def refresh_program(
    program: engine.CiMProgram, src_params: Any, key: torch.Tensor,
) -> engine.CiMProgram:
    """Rewrite a drifted chip from the stored source weights: fresh write
    noise, the drift clock reset to t_c, the same per-layer bitwidths and
    the same chip id."""
    return program_for_serving(
        src_params, program.cfg, key,
        b_adc_overrides=engine.plan_bit_overrides(program) or None,
        t_seconds=pcm_lib.T_C,
        chip_id=program.chip_id,
    )
