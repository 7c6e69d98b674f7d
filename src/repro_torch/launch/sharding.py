"""Sharding rules, port of ``repro.launch.sharding``: the 2D FSDP x TP
parameter layout and the batch and cache specs, plus the port's own rule
for where an analog weight's rows may be cut.

Every function returns, per leaf, which tensor dim goes over which mesh
axis: a tuple with one entry per dim, each an axis name, a tuple of axis
names or None (:class:`NamedSharding` pairs it with its mesh). The tuples
are the reference's ``PartitionSpec`` entry by entry (``tests/
test_torch_sharding.py`` holds them against it for every registered arch):

  * every >=2D weight is sharded on both mesh axes: the tensor-parallel dim
    over ``model`` (Megatron column/row convention), the other dim over the
    FSDP axes (``data``, plus ``pod``); ``inference=True`` drops the FSDP
    axes (serving has no optimizer state);
  * MoE expert banks put the expert dim over ``model``;
  * small vectors (norms, biases, quantizer ranges) are replicated;
  * an axis whose dim it does not divide is dropped (mamba2's vocab 50,280
    over 16).

The rules are name-based over the param-tree paths, so stacked leaves get
a leading None.

**The crossbar rule (the port's own).** The reference's even split is
GSPMD's layout, not what a crossbar holds: a weight's rows are summed tile
by tile (``AnalogConfig.tile_rows``), each tile's partial through its own
ADC. So an analog weight whose K (rows) goes over ``model`` is split only at
tile boundaries (:func:`tile_bounds`): tinyllama-1.1b's ``w2`` (K = 5,632,
6 tiles) over 2 ranks is 3 + 3 tiles (3,072 + 2,560 rows), never 2,816 +
2,816. Where a weight has fewer tiles than the ``model`` degree, or one ADC
converts the whole K (``per_tile_adc=False``), its rows stay whole and its
columns are split instead: the rank computes its output columns from the
gathered input. :func:`layer_split` applies it to a programmed layer.

**The training layout.** ``param_shardings(analog_cfg=)`` is the
reference's FSDP x TP layout with the crossbar rule on the TP dim: a
row-parallel analog weight's K over ``model`` at whole tiles of
``analog_cfg`` (its :class:`NamedSharding` carries the uneven split points
in ``bounds``), or -- in ``digital`` mode, which has no tile, or where the
tiles are fewer than the ranks -- its columns over ``model`` and its rows
over the FSDP axes. :func:`shard_tree` keeps a rank's slice of every leaf
(``jax.device_put``'s counterpart), :func:`gather_tree` gives the global
tree back, bitwise, and :func:`train_view` is the tree a rank's forward
runs on (each layer's split, the vocab-sharded embedding gathered).
Training supports a (data, model) mesh: a dim over more than one axis (a
``pod`` axis) is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import layout_of

# Megatron convention: "column" = output dim over model; "row" = input dim.
_COLUMN = {"wq", "wk", "wv", "w1", "w3", "in_proj", "gate_proj", "x_proj",
           "a_gate", "i_gate", "patch_proj"}
_ROW = {"wo", "w2", "out_proj"}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: ``spec`` (one entry per dim) over ``mesh``.
    ``bounds``, where not empty, has one entry per dim of ``spec``: None
    where the dim's axis splits it evenly, else its split points (the
    crossbar rule's whole tiles, :func:`tile_bounds`)."""

    mesh: Any
    spec: tuple
    bounds: tuple = ()


def fsdp_axes(mesh) -> tuple:
    names = layout_of(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _names(path: tuple) -> list:
    """The key and field names of a path; sequence indices carry none (as
    the reference's key paths: a tuple index has no key or name)."""
    return [str(p) for p in path if not isinstance(p, int)]


def _owner(path: tuple) -> tuple[str, str]:
    """(enclosing module name, leaf name) of a path."""
    names = _names(path)
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    return parent, leaf


def _is_expert_bank(path: tuple) -> bool:
    return "moe" in _names(path)


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _axis_size(mesh, ax) -> int:
    shape = layout_of(mesh).shape
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        return _size(shape[a] for a in ax)
    return shape[ax]


def param_pspec(path: tuple, shape: tuple, mesh, cfg=None, inference: bool = False) -> tuple:
    """The spec of one parameter leaf (``path`` a tuple of dict keys, field
    names and indices; ``shape`` its shape)."""
    parent, leaf = _owner(path)
    fsdp = () if inference else fsdp_axes(mesh)
    fsdp_ax: Any = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    shape = tuple(shape)
    ndim = len(shape)

    def spec(*tail) -> tuple:
        # stacked leading dims get None; an axis that does not divide its
        # dim exactly is dropped
        full = [None] * (ndim - len(tail)) + list(tail)
        return tuple(ax if shape[i] % _axis_size(mesh, ax) == 0 else None
                     for i, ax in enumerate(full))

    if leaf.endswith("_buf") or ndim == 0:
        return ()
    if parent == "moe" or (ndim >= 3 and leaf in ("w1", "w2", "w3") and _is_expert_bank(path)):
        if leaf in ("w1", "w3"):
            return spec("model", fsdp_ax, None)
        if leaf == "w2":
            return spec("model", None, fsdp_ax)
    if leaf == "table":  # embedding (V, M)
        return spec("model", fsdp_ax)
    if parent == "lm_head" and leaf == "w":
        return spec(fsdp_ax, "model")
    if leaf == "w" and ndim >= 2:
        if parent in _COLUMN:
            return spec(fsdp_ax, "model")
        if parent in _ROW:
            return spec("model", fsdp_ax)
        # default 2D weight (router, CNN convs, fc): replicate small ones
        if _size(shape) >= 1 << 20:
            return spec(fsdp_ax, "model")
        return ()
    if leaf == "conv_w":  # depthwise conv (W, C): channels over model
        return spec(None, "model")
    if leaf == "conv_b":
        return spec("model")
    if leaf == "b" and parent in _COLUMN:
        return spec("model")
    return ()  # norms, biases, r_adc, gain_s, A_log, D, dt_bias, ...


def param_shardings(params: Any, mesh, cfg=None, inference: bool = False,
                    layout: str = "2d", analog_cfg=None) -> Any:
    """A :class:`NamedSharding` per leaf of ``params`` (tensors, or anything
    with a ``shape``: a meta-device tree works), in ``params``' structure.

    ``layout="dp"``: every mesh axis acts as one FSDP/DP axis, no tensor
    parallelism (right-sized for small models on the production mesh).
    ``analog_cfg``: the training layout of a step in that config (the
    crossbar rule on the TP dim, see the module docstring).
    """
    flat = tree_lib.flatten_with_path(params)
    if layout == "dp":
        specs = [_dp_pspec(p, tuple(x.shape), mesh) for p, x in flat]
    else:
        specs = [param_pspec(p, tuple(x.shape), mesh, cfg, inference) for p, x in flat]
    out = [NamedSharding(mesh, s) for s in specs]
    if analog_cfg is not None:
        out = [_crossbar(p, tuple(x.shape), sh, analog_cfg) for (p, x), sh in zip(flat, out)]
    return tree_lib.unflatten(params, out)


def _crossbar(path: tuple, shape: tuple, sh: NamedSharding, analog_cfg) -> NamedSharding:
    """The crossbar rule on a row-parallel analog weight's placement."""
    n = _axis_size(sh.mesh, "model") if "model" in layout_of(sh.mesh).axis_names else 1
    if _owner(path)[1] != "w" or n == 1 or _model_entry(sh.spec) != -2:
        return sh
    per_tile = analog_cfg.per_tile_adc and analog_cfg.mode != "digital"
    bounds = tile_bounds(shape[-2], n, analog_cfg.tile_rows, per_tile)
    spec = list(sh.spec)
    if bounds is not None:
        return NamedSharding(sh.mesh, sh.spec, (None,) * (len(spec) - 2) + (bounds, None))
    # rows whole: the columns over model (where it divides them), the FSDP
    # axes over the rows
    fsdp = spec[-1]
    spec[-2] = fsdp if fsdp is not None and shape[-2] % _axis_size(sh.mesh, fsdp) == 0 else None
    spec[-1] = "model" if shape[-1] % n == 0 else None
    return NamedSharding(sh.mesh, tuple(spec))


def program_shardings(params: Any, mesh, cfg=None) -> Any:
    """The program phase's layout: weights TP-sharded over ``model`` and
    replicated over the data axes (``param_shardings(inference=True)``);
    ``engine.compile_program(shardings=)`` programs each rank's shard."""
    return param_shardings(params, mesh, cfg, inference=True)


def _dp_pspec(path: tuple, shape: tuple, mesh) -> tuple:
    """``layout="dp"``: the largest dim the whole mesh divides, over it."""
    _, leaf = _owner(path)
    lay = layout_of(mesh)
    if leaf.endswith("_buf") or len(shape) == 0:
        return ()
    n = lay.size
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % n == 0 and shape[i] >= n:
            spec = [None] * len(shape)
            spec[i] = tuple(lay.axis_names)
            return tuple(spec)
    return ()


# ---------------------------------------------------------------------------
# Data / cache shardings
# ---------------------------------------------------------------------------


def batch_axis(mesh, global_batch: int, layout: str = "2d"):
    """The batch over (pod, data) when they divide it, else replicated;
    ``layout="dp"``: over every mesh axis."""
    lay = layout_of(mesh)
    fsdp = tuple(lay.axis_names) if layout == "dp" else fsdp_axes(lay)
    n = _size(lay.shape[a] for a in fsdp)
    if global_batch % n == 0 and global_batch >= n:
        return fsdp if len(fsdp) > 1 else fsdp[0]
    return None


def batch_pspec(path: tuple, shape: tuple, mesh, layout: str = "2d") -> tuple:
    _, leaf = _owner(path)
    b_ax = batch_axis(mesh, shape[0], layout)
    if leaf in ("frames", "patches"):
        return (b_ax, None, None)
    return (b_ax,) + (None,) * (len(shape) - 1)


def batch_shardings(batch: Any, mesh, layout: str = "2d") -> Any:
    """Inputs: tokens/labels (B, S ...), frames/patches (B, S, M)."""
    flat = tree_lib.flatten_with_path(batch)
    return tree_lib.unflatten(batch, [
        NamedSharding(mesh, batch_pspec(p, tuple(x.shape), mesh, layout)) for p, x in flat])


def cache_pspec(shape: tuple, mesh, global_batch: int) -> tuple:
    """One cache leaf: the dim of size ``global_batch`` over the batch axes,
    the next dim ``model`` divides over ``model`` (the flash-decode layout:
    a KV cache's S, an SSM state's heads, an RG-LRU state's width)."""
    b_ax = batch_axis(mesh, global_batch)
    model_n = layout_of(mesh).shape.get("model", 1)
    spec = [None] * len(shape)
    for i, s in enumerate(shape):
        if s == global_batch:
            spec[i] = b_ax
            for j in (i + 1, i + 2):
                if j < len(shape) and shape[j] % model_n == 0:
                    spec[j] = "model"
                    break
            break
    return tuple(spec)


def cache_shardings(cache: Any, mesh, global_batch: int) -> Any:
    """KV caches (.., B, S, kv, hd), SSM states, RG-LRU states; stacked
    group caches have a leading (n_groups,) dim."""
    return tree_lib.tree_map(
        lambda x: NamedSharding(mesh, cache_pspec(tuple(x.shape), mesh, global_batch)), cache)


def logical_rules(mesh, cfg=None, layout: str = "2d", training: bool = False,
                  rows: bool = False) -> dict:
    """Logical activation dims -> mesh axes (None: replicated). With
    ``cfg``, a heads or kv-heads count the ``model`` degree does not divide
    is replicated (padding a tiny kv-head dim would cost more than it
    saves). ``training`` (or ``rows``, a sharded serving step's): also
    ``rows`` -- the step's batch rows, a data-parallel rank's of one
    global batch, over ``data`` (``models.common.row_axis``)."""
    lay = layout_of(mesh)
    if layout == "dp":
        axes = tuple(lay.axis_names)
        return {"batch": axes, "heads": None, "ffn": None, "vocab": None,
                "experts": None, "moe_groups": axes, "kv_heads": None,
                "seq": None}
    b_ax = fsdp_axes(lay)
    b = b_ax if len(b_ax) > 1 else (b_ax[0] if b_ax else None)
    model_n = lay.shape.get("model", 1)
    rules = {
        "batch": b,
        "heads": "model",
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "moe_groups": b,
        "kv_heads": "model",
        "seq": "model",
    }
    if cfg is not None:
        if cfg.n_kv_heads and cfg.n_kv_heads % model_n != 0:
            rules["kv_heads"] = None
        if cfg.n_heads and cfg.n_heads % model_n != 0:
            rules["heads"] = None
    if training or rows:
        rules["rows"] = b
    return rules


def opt_pspec(state_shape: tuple, param_shape: tuple, param_spec: tuple) -> tuple:
    """An optimizer-state leaf's spec from its parameter's: the same where
    the shapes match; a factored statistic drops the reduced dim; a scalar
    (or anything else) is replicated."""
    spec = list(param_spec) + [None] * (len(param_shape) - len(param_spec))
    sshape, pshape = tuple(state_shape), tuple(param_shape)
    if sshape == pshape:
        return tuple(param_spec)
    if len(sshape) == 0:
        return ()
    if sshape == pshape[:-1]:
        return tuple(spec[:-1])
    if sshape == pshape[:-2] + pshape[-1:]:
        return tuple(spec[:-2] + spec[-1:])
    return ()


def _opt_sharding(state_shape: tuple, param_shape: tuple, sh: NamedSharding) -> NamedSharding:
    """:func:`opt_pspec`, the parameter's ``bounds`` carried the same way."""
    spec = opt_pspec(state_shape, param_shape, sh.spec)
    if not sh.bounds or not spec:
        return NamedSharding(sh.mesh, spec)
    bounds = opt_pspec(state_shape, param_shape, sh.bounds)
    return NamedSharding(sh.mesh, spec, bounds)


def build_opt_shardings(opt_state: Any, params: Any, param_shards: Any, mesh) -> Any:
    """Optimizer-state shardings that mirror the parameters'
    (``training.optim.OptState``): the step replicated, each moment leaf by
    :func:`opt_pspec`."""
    from repro_torch.training import optim as optim_lib

    p_leaves = tree_lib.leaves(params)
    s_leaves = tree_lib.leaves(param_shards)

    def match(states):
        return tree_lib.unflatten(states, [
            dataclasses.replace(_opt_sharding(tuple(s.shape), tuple(p.shape), sh), mesh=mesh)
            for s, p, sh in zip(tree_lib.leaves(states), p_leaves, s_leaves, strict=True)])

    return optim_lib.OptState(
        step=NamedSharding(mesh, ()),
        m=match(opt_state.m), v=match(opt_state.v), v_col=match(opt_state.v_col),
    )


# ---------------------------------------------------------------------------
# The crossbar rule and a programmed layer's split
# ---------------------------------------------------------------------------


def even_bounds(size: int, n: int) -> tuple:
    """Split points of ``size`` into ``n`` equal parts (``n`` divides it)."""
    return tuple(i * (size // n) for i in range(n + 1))


def tile_bounds(k: int, n: int, tile_rows: int, per_tile_adc: bool = True) -> Optional[tuple]:
    """Split points of a weight's K rows over ``n`` ranks at crossbar tile
    boundaries: the first ``T % n`` ranks take one tile more than the rest
    (a ragged last tile stays last). None where the rows cannot be cut: one
    ADC over the whole K, or fewer tiles than ranks."""
    t = -(-k // tile_rows)
    if not per_tile_adc or k <= tile_rows or t < n:
        return None
    out, tile = [0], 0
    for r in range(n):
        tile += t // n + (1 if r < t % n else 0)
        out.append(min(tile * tile_rows, k))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Split:
    """How one programmed layer lies across the ``model`` axis: ``dim`` is
    the split dim of its weight counted from the end (-1 its N columns, -2
    its K rows, -3 the experts of a bank), ``bounds`` the ``n + 1`` global
    split points, ``rank`` this rank's index. Rank ``r`` holds
    ``[bounds[r], bounds[r + 1])``."""

    dim: int
    bounds: tuple
    rank: int

    @property
    def n(self) -> int:
        return len(self.bounds) - 1

    @property
    def start(self) -> int:
        return self.bounds[self.rank]

    @property
    def stop(self) -> int:
        return self.bounds[self.rank + 1]

    @property
    def size(self) -> int:
        return self.bounds[-1]

    def take(self, t, dim: Optional[int] = None):
        """This rank's slice of ``t`` along ``dim`` (default: the split's),
        a tensor of its own (the whole one is not kept alive)."""
        d = self.dim if dim is None else dim
        if t.shape[d] == self.stop - self.start:
            return t
        return t.narrow(d, self.start, self.stop - self.start).clone()

    def aligned(self, unit: int) -> bool:
        """Every split point a multiple of ``unit`` (whole heads)."""
        return all(b % unit == 0 for b in self.bounds)


def _model_entry(spec: tuple) -> Optional[int]:
    """The dim of ``spec`` (counted from the end) that ``model`` is on."""
    for i, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return i - len(spec)
    return None


def layer_split(spec: tuple, shape: tuple, n: int, rank: int, tile_rows: int,
                per_tile_adc: bool, bank: bool = False) -> Optional[Split]:
    """The :class:`Split` of a programmed layer's weight (``shape``, stack
    dims first) from its spec and the crossbar rule; None where it is
    replicated. ``bank``: an expert bank family (its experts split)."""
    dim = _model_entry(tuple(spec) + (None,) * (len(shape) - len(spec)))
    if dim is None:
        return None
    if bank:
        return Split(dim, even_bounds(shape[dim], n), rank)
    if dim == -2:
        bounds = tile_bounds(shape[-2], n, tile_rows, per_tile_adc)
        if bounds is not None:
            return Split(-2, bounds, rank)
        if shape[-1] % n:
            return None
        return Split(-1, even_bounds(shape[-1], n), rank)
    return Split(dim, even_bounds(shape[dim], n), rank)


# ---------------------------------------------------------------------------
# A rank's slices of a tree in a layout, and the global tree back
# ---------------------------------------------------------------------------


def placed_dims(sh: NamedSharding) -> list:
    """(dim from the end, axis name, split points or None) of each dim of a
    leaf that ``sh`` splits."""
    out = []
    for i, ax in enumerate(sh.spec):
        if ax is None:
            continue
        names = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        if len(names) != 1:
            raise NotImplementedError(
                f"a dim over mesh axes {names}: the sharded step takes a (data, model) mesh")
        out.append((i - len(sh.spec), names[0], sh.bounds[i] if sh.bounds else None))
    return out


def _axis(sh: NamedSharding, name: str):
    from repro_torch import collectives

    axis = collectives.axis_of(sh.mesh, name)
    if axis is None:
        raise ValueError(f"the mesh has no axis {name!r}")
    return axis


def take_leaf(t, sh: NamedSharding, names: Optional[tuple] = None):
    """This rank's slice of the global leaf ``t`` in ``sh`` (over the axes
    ``names``, default every one it is split over), a tensor of its own."""
    for dim, name, bounds in placed_dims(sh):
        if names is not None and name not in names:
            continue
        axis = _axis(sh, name)
        b = bounds or even_bounds(t.shape[dim], axis.size)
        t = t.narrow(dim, b[axis.rank], b[axis.rank + 1] - b[axis.rank])
    return t.clone(memory_format=torch.contiguous_format)


def gather_leaf(t, sh: NamedSharding, names: Optional[tuple] = None):
    """The leaf whose slices the ranks hold in ``sh`` (``t`` this rank's),
    all-gathered over the axes ``names`` (default every one): an exact
    concatenation."""
    from repro_torch import collectives

    for dim, name, bounds in placed_dims(sh):
        if names is not None and name not in names:
            continue
        axis = _axis(sh, name)
        b = bounds or even_bounds(t.shape[dim] * axis.size, axis.size)
        t = collectives.all_gather_dim(t, dim, b, axis)
    return t


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf's slice this rank holds in ``shardings`` (the counterpart
    of ``jax.device_put(tree, shardings)``): every rank passes the global
    tree."""
    return tree_lib.tree_map(take_leaf, tree, shardings)


def gather_tree(tree: Any, shardings: Any) -> Any:
    """The global tree of a rank's slices in ``shardings``, bitwise."""
    return tree_lib.tree_map(gather_leaf, tree, shardings)


def leaf_split(t, sh: NamedSharding) -> Optional[Split]:
    """The :class:`Split` over ``model`` of a leaf whose rank holds ``t``
    (its slice over ``model``, whole over the FSDP axes); None where it is
    not split over more than one rank."""
    dim = _model_entry(sh.spec)
    if dim is None:
        return None
    axis = _axis(sh, "model")
    if axis.size == 1:
        return None
    bounds = sh.bounds[dim] if sh.bounds and sh.bounds[dim] is not None else \
        even_bounds(t.shape[dim] * axis.size, axis.size)
    return Split(dim, bounds, axis.rank)


def train_view(params: Any, shardings: Any) -> Any:
    """The tree a tensor-parallel rank's training forward runs on, from its
    leaves gathered over the FSDP axes: each analog layer and expert bank
    split over ``model`` carries its :class:`Split` under ``"tp"`` (the
    layer's bias its columns), and every other leaf split over ``model`` --
    one the forward consumes whole: the vocab-sharded embedding table, the
    causal conv's channel-sharded ``conv_w`` and ``conv_b`` -- is gathered
    over ``model`` (``collectives.gather``: its gradient keeps the rank's
    slice), so the forward is the unsharded one."""
    from repro_torch import collectives
    from repro_torch.core import engine

    by_path = _by_path(shardings)

    def whole(t, path: str):
        sh = by_path[path]
        split = leaf_split(t, sh)
        if split is None:
            return t
        return collectives.gather(t, split.dim, split.bounds, _axis(sh, "model"))

    def walk(tree, path: str):
        join = lambda k: f"{path}/{k}" if path else str(k)
        if isinstance(tree, torch.Tensor):
            return whole(tree, path)
        if isinstance(tree, dict):
            if engine._is_linear_layer(tree):
                return tree  # its split is its own (node_fn)
            bank = engine._is_expert_bank(tree)
            return {k: v if bank and k in engine._BANK_KEYS else walk(v, join(k))
                    for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(walk(getattr(tree, f), join(f)) for f in tree._fields))
        if isinstance(tree, (tuple, list)):
            out = [walk(v, join(i)) for i, v in enumerate(tree)]
            return type(tree)(out) if isinstance(tree, tuple) else out
        return tree

    return walk(layer_splits(params, shardings), "")


def _by_path(shardings: Any) -> dict:
    return {tree_lib.path_name(p): sh for p, sh in tree_lib.flatten_with_path(shardings)}


def layer_splits(params: Any, shardings: Any) -> Any:
    """``params`` with each analog layer and expert bank split over
    ``model`` carrying its :class:`Split` under ``"tp"`` (the first half of
    :func:`train_view`; no tensor is touched)."""
    from repro_torch.core import engine

    by_path = _by_path(shardings)

    def node_fn(path: str, node: dict) -> dict:
        w = "w" if "w" in node else "w1"
        split = leaf_split(node[w], by_path[f"{path}/{w}"])
        return dict(node) if split is None else {**node, "tp": split}

    return engine._walk(params, node_fn)


def serve_view(params: Any, shardings: Any) -> Any:
    """The tree a sharded serving step's forward runs on, from a rank's
    slices (``param_shardings``' layout, ``inference`` or not): each leaf
    gathered over the FSDP axes, then :func:`train_view` (each layer's
    split, every other leaf split over ``model`` gathered whole)."""
    shs = tree_lib.leaves(shardings)
    fsdp = fsdp_axes(shs[0].mesh)
    if fsdp:
        params = tree_lib.tree_map(lambda t, sh: gather_leaf(t, sh, fsdp), params, shardings)
    return train_view(params, shardings)
