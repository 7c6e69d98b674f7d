"""One rank's cost of a step as it is dispatched: the counterpart of
``repro.analysis.hlo`` and ``repro.analysis.hlo_cost``.

The reference reads its costs off the compiled HLO of a jitted step. The
port has no HLO: a step is the sequence of ops and kernel launches one
rank dispatches, and :func:`count` counts them while the step runs -- on
real tensors, or on fake ones (``torch._subclasses.fake_tensor``), where
nothing is computed and nothing is allocated (``launch.dryrun``). Both
runs of a step give the same counts: every figure is a function of the
shapes and dtypes the step dispatches.

* **FLOPs, once per unit of work, whoever implements it.** The kernels'
  dispatchers -- B1 (``kernels.ops.analog_mvm``, ``analog_mvm_bank``,
  ``core.engine.execute_mvm``), B3 (``kernels.flash_attention``), the row
  kernels (``kernels.decode_rows``) and the normal draw
  (``prng.normal``) -- each wrap their work in :func:`unit`, which adds
  the unit's FLOPs (B1: 2 M K N; B3: the query-key pairs its mask leaves
  live times 4 D) and bytes once, whichever route runs: the kernel, its
  fake-tensor branch or its plain version, whose own ops are not counted
  a second time. Every other aten op adds what ``FlopCounterMode``'s
  formulas give it (``torch.utils.flop_counter.flop_registry``: the
  matmuls and convolutions; elementwise ops count none).
* **Bytes, as a roofline reads them.** Each launched op reads each of its
  inputs once and writes each of its outputs once, each tensor's distinct
  elements (a broadcast dim read once, :func:`nbytes`); a view, an
  allocation, a detach or a host-to-device copy of a constant launches
  nothing on the card and moves no HBM bytes.
* **Peak bytes.** The storages a step allocates are tracked from the op
  that makes them to the last tensor that holds them (a finalizer on each
  tensor; views share their base's record), each rounded up to the CUDA
  caching allocator's 512-byte granularity. ``peak_bytes`` is the most
  that lived at once; what the step was handed (its arguments) is not in
  it.
* **Collectives.** ``collectives.stats`` counts each call by kind with its
  operand bytes and its wire bytes, at ``repro.analysis.hlo``'s ring
  factors; the counter keeps the step's share. The collective ops' own
  buffers are not HBM traffic and add no bytes here.
* **An op histogram**, the counterpart of ``op_histogram``: launched ops
  by name (``aten.mm``, ``B1``, ``rows.attn``, ...).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: the CUDA caching allocator's block granularity (bytes)
ALLOC_ROUND = 512

#: ops that launch nothing: allocations, views, metadata
_FREE = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "_unsafe_view", "set_",
    "resize_", "_reshape_alias", "view", "as_strided", "expand", "t", "transpose",
    "permute", "unsqueeze", "squeeze", "slice", "select", "narrow", "split",
    "split_with_sizes", "unbind", "chunk", "view_as_real", "view_as_complex",
    "_unsafe_split", "unfold", "diagonal", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type",
    "_local_scalar_dense",  # a read to the host
})
#: ops whose output shares its first input's storage though their schema
#: does not say so (matmul's and einsum's reshape of a product)
_UNNOTED_VIEWS = frozenset({"_unsafe_view"})
#: namespaces counted elsewhere or launching nothing: the collectives
#: (``collectives`` counts their traffic) and device queries
_SKIP_NS = ("c10d", "_c10d_functional", "c10d_functional", "prim")

_ACTIVE: dict = {"counter": None}


def nbytes(t: torch.Tensor) -> int:
    """The bytes of a tensor's distinct elements: a broadcast (stride-0) dim
    is read once, so an expanded operand moves what its source holds."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return (n if t.numel() else 0) * t.element_size()


def storage_bytes(t: torch.Tensor) -> int:
    """The bytes a new tensor's storage spans (its strides' extent)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    return span * t.element_size()


def alloc_bytes(n: int) -> int:
    """``n`` bytes as the caching allocator hands them out."""
    return 0 if n <= 0 else -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Counter:
    """One counted run (see the module docstring)."""

    flops: int = 0
    bytes: int = 0
    ops: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    live_bytes: int = 0
    peak_bytes: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)
    depth: int = 0  # inside a unit: its own ops are not counted
    _records: Any = None  # tensor -> its storage's [bytes, holders]
    _memo: dict = dataclasses.field(default_factory=dict)  # :func:`memoized`

    @property
    def wire_bytes(self) -> float:
        return sum(v["wire_bytes"] for v in self.collectives.values())

    @property
    def collective_counts(self) -> dict:
        return {k: v["calls"] for k, v in self.collectives.items()}

    def add(self, name: str, flops: int, nbytes_: int) -> None:
        self.flops += int(flops)
        self.bytes += int(nbytes_)
        self.ops[name] += 1

    def tracked(self, t: torch.Tensor) -> bool:
        """``t``'s storage was allocated inside the counted run."""
        return t in self._records

    def histogram(self, top: int = 15) -> list:
        """The ``top`` most launched ops, as ``op_histogram`` gives them."""
        return self.ops.most_common(top)

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "wire_bytes": self.wire_bytes,
                "peak_bytes": self.peak_bytes, "ops": dict(sorted(self.ops.items())),
                "collectives": {k: dict(v) for k, v in sorted(self.collectives.items())}}

    # -- storage lifetimes ---------------------------------------------------

    def _hold(self, t: torch.Tensor, rec: list) -> None:
        self._records[t] = rec
        rec[1] += 1
        weakref.finalize(t, _release, weakref.ref(self), rec)

    def _track(self, func, args, kwargs, out) -> None:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        schema = func._schema
        for i, t in enumerate(outs):
            if not isinstance(t, torch.Tensor) or t in self._records:
                continue
            src = (args[0] if func.overloadpacket.__name__ in _UNNOTED_VIEWS
                   else _aliased_input(schema, i, args, kwargs))
            if src is not None:
                rec = self._records.get(src)
                if rec is not None:  # a view of a tensor the run allocated
                    self._hold(t, rec)
                continue  # a view of an argument: not the run's
            rec = [alloc_bytes(storage_bytes(t)), 0]
            self.live_bytes += rec[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._hold(t, rec)


def _release(counter_ref, rec: list) -> None:
    rec[1] -= 1
    counter = counter_ref()
    if rec[1] == 0 and counter is not None:
        counter.live_bytes -= rec[0]


def _aliased_input(schema, i: int, args, kwargs) -> Optional[torch.Tensor]:
    """The input tensor whose storage output ``i`` shares, by the op's
    schema (a view or an in-place op), else None."""
    ret = schema.returns[i if len(schema.returns) > 1 else 0] if schema.returns else None
    if ret is None or ret.alias_info is None:  # (one list return: every element)
        return None
    want = set(ret.alias_info.before_set)
    for j, arg in enumerate(schema.arguments):
        info = arg.alias_info
        if info is None or not want & set(info.before_set):
            continue
        val = args[j] if j < len(args) else kwargs.get(arg.name)
        if isinstance(val, torch.Tensor):
            return val
        if isinstance(val, (tuple, list)) and val and isinstance(val[0], torch.Tensor):
            return val[0]
    return None


def _host_copy(name: str, args, out) -> bool:
    """A copy from the host to the device: how ``torch.tensor(x,
    device=...)`` reaches a device under a fake mode (a real run makes it
    below the dispatcher, uncounted). No HBM traffic of the step's."""
    return (name == "_to_copy" and bool(args) and isinstance(args[0], torch.Tensor)
            and isinstance(out, torch.Tensor) and args[0].device.type == "cpu"
            and out.device.type != "cpu")


class _Mode(TorchDispatchMode):
    def __init__(self, counter: Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counter
        c._track(func, args, kwargs, out)
        name = func.overloadpacket.__name__
        if (c.depth or func.namespace in _SKIP_NS or name in _FREE
                or getattr(func, "is_view", False) or _host_copy(name, args, out)):
            return out
        from torch.utils.flop_counter import flop_registry

        f = flop_registry.get(func.overloadpacket)
        flops = f(*args, **kwargs, out_val=out) if f is not None else 0
        moved = sum(nbytes(t) for t in _tensors((args, kwargs))) + sum(
            nbytes(t) for t in _tensors(out))
        c.add(f"{func.namespace}.{name}", flops, moved)
        return out


def counting() -> bool:
    """A :func:`count` is running."""
    return _ACTIVE["counter"] is not None


def unit(name: str, flops: int, inputs: tuple, fn: Callable[..., Any], *args) -> Any:
    """``fn(*args)`` as one unit of work of a kernel's dispatcher: while a
    :func:`count` runs, it adds ``flops``, the bytes of ``inputs`` (read
    once) and of ``fn``'s outputs (written once) and one ``name`` op, and
    nothing for the ops ``fn`` dispatches; inside another unit it adds
    nothing. Without a counter it is ``fn(*args)`` (a dispatcher whose
    ``flops`` or ``inputs`` take work to form asks :func:`counting` first)."""
    c = _ACTIVE["counter"]
    if c is None or c.depth:
        return fn(*args)
    c.depth += 1
    try:
        out = fn(*args)
    finally:
        c.depth -= 1
    c.add(name, flops, sum(nbytes(t) for t in _tensors(inputs)) + sum(
        nbytes(t) for t in _tensors(out)))
    return out


def memoized(key: tuple, fn: Callable[[], Any]) -> Any:
    """``fn()`` inside a :func:`count`, for an operation whose ops, bytes
    and temporaries follow from ``key`` alone (an emulation on fake
    operands, ``prng._emulated``). The first call with a key runs ``fn``
    and keeps what it added: FLOPs, bytes, ops, the peak it reached above
    the live bytes it started from, and its outputs' shapes and dtypes.
    A later call adds the same and makes fresh outputs of those shapes,
    dispatching none of ``fn``'s ops. A call whose outputs are not each a
    contiguous storage of their own, or that leaves a temporary alive, is
    never replayed."""
    c = _ACTIVE["counter"]
    key = (key, c.depth > 0)
    hit = c._memo.get(key)
    if hit:
        flops, moved, ops, excess, outs = hit
        c.flops += flops
        c.bytes += moved
        c.ops.update(ops)
        c.peak_bytes = max(c.peak_bytes, c.live_bytes + excess)
        made = tuple(torch.empty(shape, dtype=dtype, device=dev) for shape, dtype, dev in outs)
        return made if len(made) > 1 else made[0]
    flops, moved, ops, live, peak = c.flops, c.bytes, c.ops.copy(), c.live_bytes, c.peak_bytes
    c.peak_bytes = live
    try:
        out = fn()
    finally:
        excess, c.peak_bytes = c.peak_bytes - live, max(peak, c.peak_bytes)
    outs = out if isinstance(out, tuple) else (out,)
    recs = [c._records.get(t) for t in outs]
    own = (all(r is not None and t.is_contiguous() and r[0] == alloc_bytes(storage_bytes(t))
               for t, r in zip(outs, recs))
           and len({id(r) for r in recs}) == len(recs)
           and c.live_bytes - live == sum(r[0] for r in recs))
    c._memo[key] = own and (c.flops - flops, c.bytes - moved, c.ops - ops, excess,
                            tuple((t.shape, t.dtype, t.device) for t in outs))
    return out


def _collective_snapshot() -> dict:
    from repro_torch import collectives

    return {k: dict(v) for k, v in collectives.stats["ops"].items()}


@contextlib.contextmanager
def count():
    """Count the ops the block dispatches on this thread (and its autograd
    backward) -> a :class:`Counter`, filled when the block ends."""
    if _ACTIVE["counter"] is not None:
        raise RuntimeError("cost.count() does not nest")
    c = Counter(_records=torch.utils.weak.WeakTensorKeyDictionary())
    before = _collective_snapshot()
    _ACTIVE["counter"] = c
    try:
        with _Mode(c):
            yield c
    finally:
        _ACTIVE["counter"] = None
        after = _collective_snapshot()
        for kind, v in after.items():
            b = before.get(kind, {})
            d = {k: v[k] - b.get(k, 0) for k in v}
            if d["calls"]:
                c.collectives[kind] = d
