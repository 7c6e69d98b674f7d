"""Programmed-chip artifacts: the cim-program v1 format, port of the
program half of ``repro.checkpoint.store`` (``save_program``,
``load_program``).

Layout (written by the reference's ``save_program``)::

    program_dir/
      arrays.npz   # "params::<path>" effective weights, GDC scalars, digital
                   # leaves; "state::<layer path>::<name>" PCM state
      meta.json    # format, version, t_seconds, age_history, chip_id, cfg,
                   # per-layer plans [K, N, b_adc] (legacy [K, N]), mapping
      COMMIT       # written last: presence marks a complete artifact

A loaded program serves bitwise the chip that was saved: every array is
moved to ``device`` unchanged (state keys, uint32 in the file, become the
port's int64 key words). ``save_program`` writes what the reference's
``load_program`` reads, array for array, and the physical-array mapping
(``crossbar.mapping_to_dict`` / ``mapping_from_dict``) both ways.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import crossbar
from repro_torch.core import engine as engine_lib
from repro_torch.core import pcm as pcm_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.analog import AnalogConfig
from repro_torch.device import resolve_device

PROGRAM_FORMAT = "cim-program"
PROGRAM_VERSION = 1
_LM_FIELDS = frozenset({"embed", "blocks", "lm_head", "gain_s"})

_nest = convert.nest
_KEY_LEAF = "key"  # state leaves holding threefry keys (uint32 in the file)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """'::'-joined path -> leaf, as the reference's tree flattening names
    them (NamedTuple fields, dict keys, sequence indices)."""
    join = lambda k: f"{prefix}{convert.SEP}{k}" if prefix else str(k)
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, join(k)))
    return out


def _to_numpy(t: torch.Tensor, *, key: bool = False) -> np.ndarray:
    t = t.detach().cpu()
    if key:
        return t.numpy().astype(np.uint32)
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as the reference writes it

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def save_program(path: str, program: engine_lib.CiMProgram) -> str:
    """Atomically persist a compiled CiMProgram (cim-program v1); returns
    the final path. The reference's ``load_program`` reads it back bitwise."""
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {f"params{convert.SEP}{k}": _to_numpy(v)
              for k, v in _flatten(program.params).items()}
    arrays.update({
        f"state{convert.SEP}{k}": _to_numpy(v, key=k.rsplit(convert.SEP, 1)[-1] == _KEY_LEAF)
        for k, v in _flatten(program.state).items()
    })
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {
        "format": PROGRAM_FORMAT,
        "version": PROGRAM_VERSION,
        "t_seconds": program.t_seconds,
        "age_history": [float(t) for t in program.age_history],
        "chip_id": program.chip_id,
        "cfg": dataclasses.asdict(program.cfg),
        "plans": {p: [plan.k, plan.n, plan.spec.b_adc]
                  for p, plan in program.plans.items()},
        "mapping": (crossbar.mapping_to_dict(program.mapping)
                    if program.mapping is not None else None),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    # no window without a committed artifact: move the old one aside,
    # swing the new one into place, then drop the old one
    old = path + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)
    return path


def _check_fits(path: str, flat_params: dict, params_like: Any) -> None:
    """Refuse an artifact that does not cover ``params_like``: a template
    leaf absent from it, or one whose shape differs at the same rank (the
    reference's check and message). A rank change is legitimate: program
    transforms flatten conv kernels to their 2D crossbar blocks, so a CNN
    chip loads against ``cnn_init``'s 4D tree."""
    template = {k: tuple(v.shape) for k, v in _flatten(params_like).items()}
    missing = sorted(set(template) - set(flat_params))
    wrong_shape = sorted(
        k for k, shape in template.items()
        if k in flat_params
        and flat_params[k].ndim == len(shape)
        and flat_params[k].shape != shape
    )
    if missing or wrong_shape:
        raise ValueError(
            f"program artifact at {path} does not match the model: "
            f"{len(missing)} template leaves absent "
            f"(first few: {missing[:3]}), {len(wrong_shape)} with "
            f"mismatched shapes (first few: "
            f"{[(k, flat_params[k].shape, template[k]) for k in wrong_shape[:3]]}) "
            "-- was it saved from a different architecture/config?"
        )


def load_program(path: str, *, params_like: Any = None, device="cuda") -> engine_lib.CiMProgram:
    """Load a cim-program v1 artifact onto ``device``.

    Refuses an artifact without ``COMMIT``, of another format, or of a newer
    version, and malformed or unsupported per-layer plans; with
    ``params_like`` (the model's param tree, e.g. from ``lm_init``) also
    one that does not fit the model. LM artifacts come back as
    :class:`~repro_torch.models.lm.LMParams`, others as nested dicts.
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

    if params_like is not None:
        _check_fits(path, flat_params, params_like)
    for k in flat_state:
        if k.rsplit(convert.SEP, 1)[-1] == _KEY_LEAF:
            flat_state[k] = flat_state[k].astype(np.int64)
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
        mapping=(crossbar.mapping_from_dict(meta["mapping"])
                 if meta.get("mapping") else None),
        # pre-age_history artifacts know only their final age
        age_history=tuple(
            float(t) for t in meta.get("age_history", [meta["t_seconds"]])
        ),
        chip_id=int(meta["chip_id"]) if meta.get("chip_id") is not None else None,
    )
