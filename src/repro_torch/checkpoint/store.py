"""Programmed-chip artifacts: the cim-program v1 reader, port of the
``load_program`` half of ``repro.checkpoint.store``.

Layout (written by the reference's ``save_program``)::

    program_dir/
      arrays.npz   # "params::<path>" effective weights, GDC scalars, digital
                   # leaves; "state::<layer path>::<name>" PCM state
      meta.json    # format, version, t_seconds, age_history, chip_id, cfg,
                   # per-layer plans [K, N, b_adc] (legacy [K, N]), mapping
      COMMIT       # written last: presence marks a complete artifact

A loaded program serves bitwise the chip that was saved: every array is
moved to ``device`` unchanged. ``mapping`` stays the raw dict until
``core/crossbar.py`` is ported. Writing artifacts (``save_program``) comes
with the program-phase slice.
"""

from __future__ import annotations

import json
import os

import numpy as np

from repro_torch import convert
from repro_torch.core import engine as engine_lib
from repro_torch.core import pcm as pcm_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.analog import AnalogConfig
from repro_torch.device import resolve_device

PROGRAM_FORMAT = "cim-program"
PROGRAM_VERSION = 1
_LM_FIELDS = frozenset({"embed", "blocks", "lm_head", "gain_s"})

_nest = convert.nest


def load_program(path: str, *, device="cuda") -> engine_lib.CiMProgram:
    """Load a cim-program v1 artifact onto ``device``.

    Refuses an artifact without ``COMMIT``, of another format, or of a newer
    version, and malformed or unsupported per-layer plans. LM artifacts come
    back as :class:`~repro_torch.models.lm.LMParams`, others as nested dicts.
    """
    dev = resolve_device(device)
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed program artifact at {path}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != PROGRAM_FORMAT:
        raise ValueError(f"not a {PROGRAM_FORMAT} artifact: {path}")
    if meta.get("version", 0) > PROGRAM_VERSION:
        raise ValueError(
            f"program artifact version {meta['version']} is newer than "
            f"supported version {PROGRAM_VERSION}"
        )

    flat_params, flat_state = {}, {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k in data.files:
            head, rest = k.split(convert.SEP, 1)
            (flat_params if head == "params" else flat_state)[rest] = data[k]

    cfg_d = dict(meta["cfg"])
    cfg = AnalogConfig(**{**cfg_d, "pcm": pcm_lib.PCMConfig(**cfg_d["pcm"])})
    nested = _nest(flat_params)
    if _LM_FIELDS <= set(nested):
        params = convert.lm_params_from_nested(nested, dev)
    else:
        params = convert.tree_to_torch(nested, dev)
    state = convert.tree_to_torch(_nest(flat_state), dev)

    plans = {}
    for p, entry in meta["plans"].items():
        # v1 artifacts predating mixed precision stored [K, N]
        if len(entry) not in (2, 3):
            raise ValueError(
                f"malformed quant plan for layer {p!r} in {path}: {entry!r} "
                "(expected [K, N] or [K, N, b_adc])"
            )
        k, n = int(entry[0]), int(entry[1])
        bits = int(entry[2]) if len(entry) == 3 else cfg.b_adc
        if bits != cfg.b_adc:
            quant_lib.validate_b_adc(bits, f"stored b_adc for layer {p!r}")
        plans[p] = engine_lib.plan_for(cfg, k, n, b_adc=bits)

    return engine_lib.CiMProgram(
        params=params,
        cfg=cfg,
        t_seconds=float(meta["t_seconds"]),
        state=state,
        plans=plans,
        mapping=meta.get("mapping") or None,
        # pre-age_history artifacts know only their final age
        age_history=tuple(
            float(t) for t in meta.get("age_history", [meta["t_seconds"]])
        ),
        chip_id=int(meta["chip_id"]) if meta.get("chip_id") is not None else None,
    )
