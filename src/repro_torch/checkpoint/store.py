"""Training checkpoints and programmed-chip artifacts, port of
``repro.checkpoint.store``.

Training checkpoints (:func:`save`, :func:`latest_step`, :func:`restore`,
:func:`read_meta`, :func:`gc_old`, :class:`AsyncCheckpointer`) use the
reference's layout, so a checkpoint of either package restores in the
other, bitwise::

    ckpt_dir/
      step_00000100/
        host_000.npz   # '::'-joined tree path -> array (jax.tree's walk:
                       # dict keys sorted; repro_torch.tree)
        meta.json      # step, host_count, sorted keys, extra meta
        COMMIT         # written last: presence marks a complete checkpoint

A write lands in ``step_X.tmp<host>`` and is renamed after COMMIT, so a
crash mid-write never corrupts the newest checkpoint; the asynchronous
writer copies the tensors to host memory when ``save`` is called and
writes them on its own thread.

Programmed chips: the cim-program v1 format (``save_program``,
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
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch import tree as tree_lib
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


# ---------------------------------------------------------------------------
# Training checkpoints
# ---------------------------------------------------------------------------


def _tree_arrays(tree: Any) -> dict[str, np.ndarray]:
    """'::'-joined path -> host array of every leaf, in jax.tree's order."""
    return {tree_lib.path_name(path, convert.SEP): _to_numpy(leaf) if isinstance(
        leaf, torch.Tensor) else np.asarray(leaf)
        for path, leaf in tree_lib.flatten_with_path(tree)}


def save(
    ckpt_dir: str,
    step: int,
    tree: Any,
    *,
    host_index: int = 0,
    host_count: int = 1,
    extra_meta: Optional[dict] = None,
) -> str:
    """Synchronous atomic save of ``tree`` (tensors or host arrays);
    returns the final checkpoint path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp{host_index}"
    os.makedirs(tmp, exist_ok=True)
    arrays = _tree_arrays(tree)
    np.savez(os.path.join(tmp, f"host_{host_index:03d}.npz"), **arrays)
    if host_index == 0:
        meta = {"step": step, "host_count": host_count,
                "keys": sorted(arrays.keys()), **(extra_meta or {})}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _committed_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and ".tmp" not in n
        and os.path.exists(os.path.join(ckpt_dir, n, "COMMIT"))
    )


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest COMMITted step, or None."""
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, tree_like: Any, *, host_index: int = 0) -> Any:
    """The checkpoint of ``step`` in ``tree_like``'s structure (dicts in
    jax.tree's sorted order, as the reference restores them), each leaf at
    the dtype and on the device of ``tree_like``'s."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    leaves = []
    with np.load(os.path.join(path, f"host_{host_index:03d}.npz")) as data:
        for p, leaf in tree_lib.flatten_with_path(tree_like):
            key = tree_lib.path_name(p, convert.SEP)
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint/model shape mismatch at {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            t = convert.to_tensor(arr, leaf.device)
            leaves.append(t if t.dtype == leaf.dtype else t.to(leaf.dtype))
    return tree_lib.unflatten(tree_like, leaves)


def read_meta(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    for s in _committed_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))


class AsyncCheckpointer:
    """Background writer thread: ``save`` copies the tree to host memory
    and returns; the thread writes it (and keeps the newest ``keep``). A
    writer failure is raised by the next ``save`` or ``close``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, arrays, meta = item
            try:
                save(self.ckpt_dir, step, arrays, extra_meta=meta)
                gc_old(self.ckpt_dir, self.keep)
            except BaseException as e:  # surfaced on the next save()/close()
                self._err = e

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        if self._err is not None:
            raise RuntimeError("async checkpoint writer failed") from self._err
        # copy to host memory now: training goes on updating the tensors
        self._q.put((step, tree_lib.tree_map(
            lambda x: np.array(_to_numpy(x) if isinstance(x, torch.Tensor) else x), tree),
            meta))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise RuntimeError("async checkpoint writer failed") from self._err


def save_program(path: str, program: engine_lib.CiMProgram) -> str:
    """Atomically persist a compiled CiMProgram (cim-program v1); returns
    the final path. The reference's ``load_program`` reads it back bitwise.

    A sharded chip is gathered (every rank calls this) and rank 0 writes the
    host chip's artifact, layout-free and bitwise the unsharded chip's; the
    ranks leave together, the artifact written."""
    if program.mesh is not None:
        import torch.distributed as dist

        host = program.gather()
        if dist.get_rank() == 0:
            save_program(path, host)
        dist.barrier()
        return path
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


def _cast_like(template: Any, loaded: Any, dev) -> Any:
    """``loaded`` (nested dicts from :func:`_nest`) on ``dev``, rebuilt in
    the container types of ``template`` (``LMParams``, tuples, lists,
    dicts), as the reference's ``_cast_like`` rebuilds it: keys only
    ``loaded`` has (``out_scale_buf``, added by the program phase) are
    kept, and template subtrees with no stored leaves (the empty ``norm1``
    and ``norm2`` of a model with non-parametric norms) come from the
    template. Leaf shapes may differ from the template's (programmed conv
    kernels come back as 2D crossbar blocks)."""
    on_dev = lambda t: tree_lib.tree_map(lambda leaf: leaf.to(dev), t)
    if not isinstance(loaded, dict):
        return convert.to_tensor(loaded, dev)
    if hasattr(template, "_fields"):
        return type(template)(*(
            _cast_like(getattr(template, f), loaded[f], dev) if f in loaded
            else on_dev(getattr(template, f)) for f in template._fields))
    if isinstance(template, (list, tuple)):
        out = [_cast_like(t, loaded[str(i)], dev) if str(i) in loaded else on_dev(t)
               for i, t in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    if isinstance(template, dict):
        merged = {k: _cast_like(template.get(k), v, dev) for k, v in loaded.items()}
        merged.update((k, on_dev(v)) for k, v in template.items() if k not in merged)
        return merged
    return convert.tree_to_torch(loaded, dev)  # no template guidance: nested dicts


def load_program(path: str, *, params_like: Any = None, shardings: Any = None,
                 device="cuda") -> engine_lib.CiMProgram:
    """Load a cim-program v1 artifact onto ``device``.

    Refuses an artifact without ``COMMIT``, of another format, or of a newer
    version, and malformed or unsupported per-layer plans; with
    ``params_like`` (the model's param tree, e.g. from ``lm_init``) also
    one that does not fit the model, and the params are rebuilt on its
    structure (:func:`_cast_like`). Without it, LM artifacts come back as
    :class:`~repro_torch.models.lm.LMParams`, others as nested dicts.

    ``shardings`` (``launch.sharding.program_shardings`` over a mesh): each
    rank keeps its shard of the loaded chip (``engine.shard_program``), and
    the mesh's logical rules are installed if none are.
    """
    program = _load_program(path, params_like, device)
    if shardings is None:
        return program
    from repro_torch.launch import sharding as shd
    from repro_torch.models import common

    program = engine_lib.shard_program(program, shardings)
    if common.mesh_axis("model") is None:
        common.set_logical_rules(shd.logical_rules(program.mesh), program.mesh)
    return program


def _load_program(path: str, params_like: Any, device) -> engine_lib.CiMProgram:
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
    if params_like is not None:
        params = _cast_like(params_like, nested, dev)
    elif _LM_FIELDS <= set(nested):
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
