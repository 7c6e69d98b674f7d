"""Multi-rank dry run: one rank's step of every (arch x shape x mesh) cell
traced on fake tensors, port of ``repro.launch.dryrun``.

For each cell the production mesh is built over a fake process group --
rank 0 of 256 ranks (16x16) or 512 (2x16x16, its (pod, data) axes one
data axis of 32: ``step_mesh``), torch's ``fake`` backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``), or a card
host's layouts (1x1, 1x4, 1x8) -- the params, optimizer state, batch and
cache are sharded with the port's rules (``launch.sharding``: the
reference's FSDP x TP layout with the crossbar rule), and the rank's step
(``launch.steps``, ``mesh=``) runs once on fake tensors under
``analysis.cost.count``: nothing is computed, nothing is allocated, and no
card is needed. The trace yields

  * memory  -- per-rank bytes (arguments, outputs, temporaries, aliases):
    does the cell fit one card's 80 GB;
  * cost    -- per-rank FLOPs, bytes moved and collective wire bytes;
  * roofline -- those against an H100's peaks (``analysis.roofline``).

Where ``torch.cuda.is_available()`` the fake tensors are ``cuda`` ones;
on a host without a card they are CPU ones under
``kernels.build.card_trace`` (a CPU-only torch's autograd engine aborts on
a CUDA-device tensor), which take the card's route everywhere. Either way
the counts are the card's. Results append to a JSONL
(``analysis.report`` renders it).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod] [--mode analog_train]
  python -m repro_torch.launch.dryrun --all --mesh 1x4
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Optional

import torch

from repro_torch import configs, prng
from repro_torch import tree as tree_lib
from repro_torch.analysis import cost as cost_lib
from repro_torch.analysis import roofline as roof_lib
from repro_torch.configs import shapes as shapes_lib
from repro_torch.core.analog import AnalogConfig
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm as lm_lib
from repro_torch.training import optim as optim_lib

# >=40B models use Adafactor so optimizer state fits (the reference's rule)
ADAFACTOR_ARCHS = {"qwen2-72b", "llama4-maverick-400b-a17b"}
#: the layouts ``--mesh`` takes besides the production ones: a card host's
HOST_MESHES = ("1x1", "1x4", "1x8")


def analog_config(mode: str) -> AnalogConfig:
    if mode == "digital":
        return AnalogConfig()
    if mode == "analog_train":
        return AnalogConfig().train(eta=0.1, b_adc=8)
    if mode == "analog_infer":
        return AnalogConfig().infer(b_adc=8, t_seconds=86400.0)
    raise ValueError(mode)


def mesh_layout(mesh: str = "", multi_pod: bool = False) -> mesh_lib.MeshLayout:
    """``"DATAxMODEL"`` (or ``"PODxDATAxMODEL"``) -> its layout; "" -> the
    production mesh (16x16, or 2x16x16 with ``multi_pod``)."""
    if not mesh:
        return mesh_lib.production_layout(multi_pod=multi_pod)
    sizes = tuple(int(v) for v in mesh.lower().split("x"))
    names = ("pod", "data", "model")[-len(sizes):]
    if len(sizes) not in (2, 3) or min(sizes) < 1:
        raise ValueError(f"--mesh takes DATAxMODEL or PODxDATAxMODEL, got {mesh!r}")
    return mesh_lib.MeshLayout(names, sizes)


@contextlib.contextmanager
def fake_group(layout: mesh_lib.MeshLayout):
    """Rank 0 of a fake process group of ``layout.size`` ranks and the mesh
    over it; the group is destroyed on the way out."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run makes its own fake process group: this process is "
                           "already in one (pass mesh= to run_cell to trace over it)")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=layout.size)
    try:
        sizes, names = step_mesh(layout)
        yield init_device_mesh("cpu", sizes, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def step_mesh(layout: mesh_lib.MeshLayout) -> tuple:
    """(sizes, axis names) of the (data, model) mesh the port's step runs
    over for ``layout``: the 2-pod mesh's (pod, data) axes -- the
    reference's FSDP and batch axes -- are one ``data`` axis of 32 ranks in
    pod-major order, so each rank holds the slices it holds there."""
    if layout.axis_names == ("pod", "data", "model"):
        pod, data, model = layout.sizes
        return (pod * data, model), ("data", "model")
    return layout.sizes, layout.axis_names


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree)
               if isinstance(t, torch.Tensor))


def _rows_bytes(batch: dict, mesh) -> int:
    """The bytes of a rank's rows of the batch (``batch_shardings``)."""
    from repro_torch import collectives

    total = 0
    for t in batch.values():
        n = t.numel() * t.element_size()
        if shd.batch_axis(mesh, t.shape[0]) is not None:
            n //= collectives.axis_of(mesh, "data").size
        total += n
    return total


@dataclasses.dataclass
class CellStep:
    """A cell's rank-0 step and its inputs, on fake or real tensors."""

    step: Any
    args: tuple
    n_params: int
    param_bytes: int  # the whole params (serving: bf16 weights)
    cache_bytes: int  # the whole cache
    argument_bytes: int  # what the rank is handed


def prepare(cfg, cell: shapes_lib.ShapeCell, mesh, mode: str, *, arch: str = "",
            layout: str = "2d", accum_steps: int = 1, device="cuda", seed: int = 0) -> CellStep:
    """The rank's step of ``cell`` over ``mesh`` and its inputs: under a
    ``FakeTensorMode`` fake tensors, else real ones drawn from ``seed``
    (params by ``lm_init``, token ids and features by torch's generator).
    ``params`` is the rank's slices; serving casts >= 2-D f32 weights to
    bf16 first, as the reference's dry run does."""
    acfg = analog_config(mode)
    params = lm_lib.lm_init(prng.PRNGKey(seed), cfg, device=device)
    n_params = sum(t.numel() for t in tree_lib.leaves(params))
    if cell.kind != "train":
        params = tree_lib.tree_map(
            lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 and t.dim() >= 2 else t,
            params)
    param_bytes = _nbytes(params)
    # serving replicates a small model's weights over the data axes (no
    # per-step FSDP gathers); >= 8B models keep the 2-D layout
    inference = cell.kind != "train" and n_params < 8e9
    p_sh = shd.param_shardings(params, mesh, cfg, inference=inference, layout=layout,
                               analog_cfg=acfg)
    local = shd.shard_tree(params, p_sh)
    opt_cfg = optim_lib.OptimizerConfig(kind="adafactor" if arch in ADAFACTOR_ARCHS else "adamw")
    opt = None
    if cell.kind == "train":
        opt = optim_lib.init(opt_cfg, params)
        o_sh = shd.build_opt_shardings(opt, params, p_sh, mesh)
        opt = shd.shard_tree(opt, o_sh)
    del params
    gen = torch.Generator().manual_seed(seed)

    def batch_of(specs: dict) -> dict:
        """Each spec made on the host, filled from ``gen`` (features normal,
        token ids and labels below the vocab), moved to ``device``."""
        out = {}
        for k, sp in specs.items():
            t = sp.make("cpu")
            if sp.dtype.is_floating_point:
                t.normal_(generator=gen)
            else:
                t.random_(0, cfg.vocab, generator=gen)
            out[k] = t.to(device)
        return out

    b, s = cell.global_batch, cell.seq_len
    rng = prng.PRNGKey(seed).to(device)
    if cell.kind == "train":
        batch = batch_of(shapes_lib._token_batch_specs(cfg, b, s, with_labels=True))
        step = steps_lib.make_train_step(cfg, acfg, opt_cfg, accum_steps, mesh=mesh,
                                         shardings=(p_sh, o_sh))
        args = (local, opt, batch, rng)
        arg_bytes = _nbytes(local) + _nbytes(opt) + _rows_bytes(batch, mesh) + _nbytes(rng)
        return CellStep(step, args, n_params, param_bytes, 0, arg_bytes)
    prefill = cell.kind == "prefill"
    if prefill:
        batch = batch_of(shapes_lib._token_batch_specs(cfg, b, s, with_labels=False))
    elif cfg.frontend == "audio_frames":
        batch = batch_of({"frames": shapes_lib.TensorSpec((b, 1, cfg.d_model), cfg.dtype)})
    else:
        batch = batch_of({"tokens": shapes_lib.TensorSpec((b, 1), torch.int32)})
    cache_bytes = sum(sp.nbytes for sp in tree_lib.leaves(
        shapes_lib.cache_specs(cfg, b, s, stacked=prefill)))
    cache = steps_lib.sharded_cache(cfg, local, p_sh, mesh, b, s, stacked=prefill,
                                    device=device)
    make = steps_lib.make_prefill_step if prefill else steps_lib.make_serve_step
    step = make(cfg, acfg, device=device, mesh=mesh, shardings=p_sh)
    args = (local, batch, cache, rng)
    arg_bytes = _nbytes(local) + _rows_bytes(batch, mesh) + _nbytes(cache) + _nbytes(rng)
    return CellStep(step, args, n_params, param_bytes, cache_bytes, arg_bytes)


def memory_of(counter: cost_lib.Counter, argument_bytes: int, out) -> dict:
    """The reference's ``memory_analysis`` fields from a counted run:
    ``output_bytes`` every output (``alias_bytes`` of them an argument's
    storage, updated in place: the cache), ``temp_bytes`` the run's peak
    of new storage less the outputs it made, so ``total_nonaliased_gib``
    (arguments + temp + outputs - aliases) is the rank's peak."""
    outs = [t for t in tree_lib.leaves(out) if isinstance(t, torch.Tensor)]
    new = sum(cost_lib.alloc_bytes(cost_lib.storage_bytes(t)) for t in outs
              if counter.tracked(t))
    alias = sum(cost_lib.nbytes(t) for t in outs if not counter.tracked(t))
    output = new + alias
    temp = counter.peak_bytes - new
    total = argument_bytes + temp + output - alias
    return {"argument_bytes": argument_bytes, "output_bytes": output, "temp_bytes": temp,
            "alias_bytes": alias, "peak_bytes": argument_bytes + counter.peak_bytes,
            "total_nonaliased_gib": round(total / 2**30, 3)}


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    mode: str = "digital",
    verbose: bool = True,
    override_cfg=None,
    layout: str = "2d",
    accum_steps: int = 1,
    *,
    mesh: Any = "",
    cell: Optional[shapes_lib.ShapeCell] = None,
) -> dict:
    """Trace rank 0's step of one cell on fake tensors -> its record (the
    reference's keys). ``mesh``: a layout string (``"1x4"``; "" the
    production mesh, ``multi_pod`` its 2-pod form), traced over a fake
    process group of its size, or a ``DeviceMesh`` of a group this process
    is in (traced over it: every collective still runs no data). ``cell``
    overrides ``SHAPES[shape_name]`` (a cut-down shape). A failure is
    recorded as data."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cell = cell or shapes_lib.SHAPES[shape_name]
    cfg = override_cfg or configs.get(arch)
    layout_of = mesh_lib.layout_of(mesh) if not isinstance(mesh, str) else mesh_layout(
        mesh, multi_pod)
    mesh_name = "x".join(str(s) for s in layout_of.sizes)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mode": mode,
        "layout": layout,
        "accum_steps": accum_steps,
        "chips": layout_of.size,
        "status": "start",
    }
    t0 = time.time()
    dev = "cuda" if torch.cuda.is_available() else "cpu"  # see the module docstring
    try:
        group = fake_group(layout_of) if isinstance(mesh, str) else contextlib.nullcontext(mesh)
        with group as m, FakeTensorMode(), build.card_trace(dev == "cpu"):
            c = prepare(cfg, cell, m, mode, arch=arch, layout=layout, accum_steps=accum_steps,
                        device=dev)
            t_build = time.time() - t0
            with cost_lib.count() as counter:
                out = c.step(*c.args)
            memory = memory_of(counter, c.argument_bytes, out)
            del out
        t_trace = time.time() - t0 - t_build

        n_active = roof_lib.active_params(cfg, c.n_params)
        mf = roof_lib.model_flops(cfg, c.n_params, n_active, cell)
        mb = roof_lib.model_bytes(cell, c.cache_bytes, c.param_bytes, c.n_params, n_active)
        roof = roof_lib.Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=rec["chips"],
            flops_per_dev=counter.flops, bytes_per_dev=counter.bytes,
            wire_bytes_per_dev=counter.wire_bytes, model_flops_total=mf,
            collective_counts=counter.collective_counts, model_bytes_total=mb)
        rec.update(
            status="ok",
            n_params=c.n_params,
            n_active_params=n_active,
            t_build_s=round(t_build, 2),
            t_trace_s=round(t_trace, 2),
            memory=memory,
            cost={"flops": counter.flops, "bytes": counter.bytes,
                  "wire_bytes": counter.wire_bytes},
            collectives={
                "counts": counter.collective_counts,
                "operand_bytes": {k: v["operand_bytes"] for k, v in counter.collectives.items()},
                "wire_bytes": {k: v["wire_bytes"] for k, v in counter.collectives.items()},
            },
            op_histogram=counter.histogram(),
            op_counts=dict(sorted(counter.ops.items())),
            roofline=roof.row(),
        )
        rec["roofline"]["t_step_s"] = roof.t_step
        if verbose:
            print(f"[ok] {arch} {shape_name} {mesh_name} {mode}: trace {t_trace:.1f}s, "
                  f"{memory['total_nonaliased_gib']:.2f} GiB/rank, "
                  f"bottleneck={roof.bottleneck}, t_step={roof.t_step:.3g}s, "
                  f"roofline_frac={roof.roofline_fraction:.3f}")
    except Exception as e:  # noqa: BLE001 -- record failures as data
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} {shape_name} {mesh_name} {mode}: {e}")
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shapes_lib.SHAPES) + [None])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="DATAxMODEL: the same rules over a card host's layout "
                         f"({', '.join(HOST_MESHES)}); default the production mesh")
    ap.add_argument("--mode", default="digital",
                    choices=["digital", "analog_train", "analog_infer"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(configs.LM_ARCHS)
    shape_names = [args.shape] if args.shape else list(shapes_lib.SHAPES)
    if args.mesh:
        meshes = [(args.mesh, False)]
    else:
        meshes = [("", False), ("", True)] if args.both_meshes else [("", args.multipod)]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for arch in archs:
            for shape_name in shape_names:
                if not shapes_lib.applicable(arch, shape_name):
                    rec = {
                        "arch": arch, "shape": shape_name,
                        "status": "skip", "reason": "full-attention arch; "
                        "long_500k requires sub-quadratic mixing",
                    }
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    print(f"[skip] {arch} {shape_name}")
                    continue
                for mesh, mp in meshes:
                    rec = run_cell(arch, shape_name, mp, args.mode, mesh=mesh)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()


if __name__ == "__main__":
    main()
