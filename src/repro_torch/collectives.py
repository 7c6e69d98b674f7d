"""The collectives of sharded programming and serving, over a
``torch.distributed`` group (gloo on the CPU, NCCL on a card).

Every float combine is exact: an all-gather (the columns of a
column-parallel MVM, the per-tile partials of a row-parallel one, the
shards of a state tensor) after which the caller sums in a fixed order, or
a selection in which exactly one rank contributes each element. NCCL's
reduction order depends on the world size and the algorithm, so no float
goes through an ``all_reduce``; the program phase reduces only integers
(``det_sum``'s limbs, a SUM) and f32 maxima (MAX, exact in any order).

Training adds a conjugate pair of autograd operators, both exact because
the activations between layers are whole and identical on every rank:
:func:`gather` all-gathers forward and keeps the rank's slice of the
gradient backward; :func:`split` keeps the rank's slice forward and
all-gathers the gradient backward. :func:`own_slice` keeps the rank's
slice forward and its own rows' gradient backward.
:func:`sum_in_rank_order` sums the ranks' partial gradients of a
data-parallel step: all-gathered, then added in rank order, as
``engine.tile_sum`` adds tiles.

``stats`` counts the calls and their host-clock seconds since the last
:func:`reset_stats` (``chip_smoke.py`` reports them per decode step and per
training step), and under ``"ops"`` each kind's calls, operand bytes and
per-rank wire bytes at ``repro.analysis.hlo``'s ring factors over a group
of g ranks: an all-gather moves out (g - 1) / g of its gathered bytes
(operand: out / g), an all-reduce 2 size (g - 1) / g, an all-to-all size
(g - 1) / g (``analysis.cost`` reads them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.clock import SYSTEM

Tensor = torch.Tensor

stats = {"calls": 0, "seconds": 0.0, "ops": {}}


def reset_stats() -> None:
    stats["calls"] = 0
    stats["seconds"] = 0.0
    stats["ops"] = {}


def wire_bytes(kind: str, size: int, g: int) -> tuple:
    """(operand bytes, per-rank wire bytes) of one ``kind`` collective over
    ``g`` ranks whose result (an all-gather's: the gathered tensor) or
    operand is ``size`` bytes (``repro.analysis.hlo``'s ring factors)."""
    ring = (g - 1) / g
    if kind == "all-gather":
        return size // g, size * ring
    if kind == "all-reduce":
        return size, 2 * size * ring
    return size, size * ring  # all-to-all


class _timed:
    """Times one collective and counts it under ``kind`` with ``size``
    bytes over ``g`` ranks (:func:`wire_bytes`)."""

    def __init__(self, kind: str, size: int, g: int):
        self.kind, self.size, self.g = kind, size, g

    def __enter__(self):
        self.t0 = SYSTEM.now()

    def __exit__(self, *exc):
        stats["calls"] += 1
        stats["seconds"] += SYSTEM.now() - self.t0
        op = stats["ops"].setdefault(self.kind, {"calls": 0, "operand_bytes": 0,
                                                 "wire_bytes": 0.0})
        operand, wire = wire_bytes(self.kind, self.size, self.g)
        op["calls"] += 1
        op["operand_bytes"] += operand
        op["wire_bytes"] += wire


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as a process group: this rank's index on it and its
    size."""

    group: Any
    rank: int
    size: int


_AXES: dict = {}  # (id(mesh), name) -> (mesh, Axis)


def axis_of(mesh, name: str = "model") -> Optional[Axis]:
    """The axis ``name`` of a ``DeviceMesh`` (None for a mesh without it).
    Remembered per mesh: a DeviceMesh takes ~0.25 ms of host to answer,
    and the forward asks every layer."""
    hit = _AXES.get((id(mesh), name))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    axis = None
    if name in names:
        axis = Axis(mesh.get_group(name), int(mesh.get_local_rank(name)),
                    int(mesh.size(names.index(name))))
    _AXES[(id(mesh), name)] = (mesh, axis)
    return axis


def _wire(t: Tensor) -> Tensor:
    # a gather moves bits: 16-bit floats go as bytes (gloo has no bf16, NCCL
    # no int16; the last dim doubles, and viewing back halves it), and a
    # mask as bytes (gloo has no bool)
    return t.view(torch.uint8) if t.dtype in (torch.bfloat16, torch.float16, torch.bool) else t


def all_gather_dim(t: Tensor, dim: int, bounds: tuple, axis: Axis) -> Tensor:
    """The global tensor whose slice ``[bounds[r], bounds[r + 1])`` along
    ``dim`` rank ``r`` holds (``t`` this rank's slice; slices may differ in
    size: each is padded to the largest and trimmed after the gather). The
    ranks' slices land in one buffer, stacked on a new leading dim."""
    import torch.distributed as dist

    dim = dim % t.dim()
    sizes = [b - a for a, b in zip(bounds, bounds[1:])]
    width = max(sizes)
    src = t.contiguous()
    if src.shape[dim] < width:
        pad = list(src.shape)
        pad[dim] = width - src.shape[dim]
        src = torch.cat([src, src.new_zeros(pad)], dim=dim)
    wire = _wire(src)
    out = torch.empty((axis.size * wire.shape[0], *wire.shape[1:]), dtype=wire.dtype,
                      device=wire.device)
    with _timed("all-gather", wire.numel() * wire.element_size() * axis.size, axis.size):
        _gather_into(out, wire, axis.group)
    out = out.view(t.dtype).view(axis.size, *src.shape)
    if all(s == width for s in sizes):  # rank r's slice at [r w, (r + 1) w)
        shape = list(src.shape)
        shape[dim] *= axis.size
        return out.movedim(0, dim).reshape(shape).contiguous()
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(out.unbind(0), sizes)], dim=dim)


def _gather_into(out: Tensor, t: Tensor, group) -> None:
    """``torch.distributed``'s all-gather into one tensor (``all_gather_single``
    where this torch has it, else its older name)."""
    import torch.distributed as dist

    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(out, t, group=group)


def all_reduce_max(t: Tensor, axis: Axis) -> Tensor:
    """Elementwise maximum over the axis (exact in any order); it carries no
    gradient."""
    import torch.distributed as dist

    out = t.detach().clone()
    with _timed("all-reduce", out.numel() * out.element_size(), axis.size):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out


def all_reduce_sum_int(t: Tensor, axis: Axis) -> Tensor:
    """Sum of an integer tensor over the axis (exact in any order)."""
    import torch.distributed as dist

    if t.dtype.is_floating_point:
        raise TypeError("all_reduce_sum_int sums integers only: a float sum's bits "
                        "would follow the collective's order")
    out = t.clone()
    with _timed("all-reduce", out.numel() * out.element_size(), axis.size):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
    return out


def all_to_all(t: Tensor, axis: Axis) -> Tensor:
    """``t`` (n, ...) -> (n, ...): row ``j`` goes to rank ``j``; row ``j`` of
    the result came from rank ``j``."""
    import torch.distributed as dist

    src = _wire(t.contiguous())
    out = torch.empty_like(src)
    with _timed("all-to-all", src.numel() * src.element_size(), axis.size):
        dist.all_to_all_single(out, src, group=axis.group)
    return out.view(t.dtype)


def rank_slice(t: Tensor, dim: int, bounds: tuple, axis: Axis) -> Tensor:
    """This rank's slice ``[bounds[r], bounds[r + 1])`` of ``t`` along ``dim``."""
    lo, hi = bounds[axis.rank], bounds[axis.rank + 1]
    return t.narrow(dim, lo, hi - lo).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, bounds, axis):
        ctx.args = (dim, bounds, axis)
        return all_gather_dim(t, dim, bounds, axis)

    @staticmethod
    def backward(ctx, g):
        return rank_slice(g, *ctx.args), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, bounds, axis):
        ctx.args = (dim, bounds, axis)
        return rank_slice(t, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, *ctx.args), None, None, None


class _Own(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, bounds, axis):
        ctx.args, ctx.shape = (dim, bounds, axis), t.shape
        return rank_slice(t, dim, bounds, axis)

    @staticmethod
    def backward(ctx, g):
        dim, bounds, axis = ctx.args
        whole = g.new_zeros(ctx.shape)
        whole.narrow(dim, bounds[axis.rank], bounds[axis.rank + 1] - bounds[axis.rank]).copy_(g)
        return whole, None, None, None


def gather(t: Tensor, dim: int, bounds: tuple, axis: Axis) -> Tensor:
    """:func:`all_gather_dim` with a gradient: backward keeps this rank's
    slice of the (whole, on every rank the same) output gradient."""
    return _Gather.apply(t, dim, bounds, axis)


def split(t: Tensor, dim: int, bounds: tuple, axis: Axis) -> Tensor:
    """This rank's slice ``[bounds[r], bounds[r + 1])`` of ``t`` along
    ``dim``, with a gradient: backward all-gathers the ranks' slices of the
    gradient, so the input's gradient is whole on every rank."""
    return _Split.apply(t, dim, bounds, axis)


def own_slice(t: Tensor, dim: int, bounds: tuple, axis: Axis) -> Tensor:
    """This rank's slice of ``t`` along ``dim``, whose gradient stays on the
    rank: backward puts the rank's slice of the gradient in zeros, and
    nothing crosses the ranks. Where every rank computes ``t`` whole from
    the gathered rows of a data-parallel batch, the parameters that made
    it then get back this rank's rows' part of their gradient, as they do
    from a rank's own rows, and ``training.loop.value_and_grad`` sums the
    parts over ``data`` once (:func:`split` would hand every rank the whole
    batch's gradient, and the sum would count it once a rank)."""
    return _Own.apply(t, dim, bounds, axis)


def sum_in_rank_order(t: Tensor, axis: Axis) -> Tensor:
    """The sum over the axis of each rank's ``t``, the same bits on every
    rank: the ranks' tensors all-gathered as f32, then rank 0's plus rank
    1's plus ... in rank order (one rank: ``t`` itself), returned in ``t``'s
    dtype. No float goes through a collective's own reduction."""
    parts = all_gather_dim(t.float()[None], 0, tuple(range(axis.size + 1)), axis)
    y = parts[0]
    for r in range(1, axis.size):
        y = y + parts[r]
    return y.to(t.dtype)
