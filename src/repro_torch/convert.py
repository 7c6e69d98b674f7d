"""The weight bridge: the reference's param trees -> the port's params.

:func:`cnn_params_from_numpy` does the same for the paper's CNNs (plain
nested dicts, ``models.analognet``), keeping the order it is given.

:func:`params_from_numpy` takes JAX ``LMParams`` leaves as numpy arrays --
either the NamedTuple itself (``jax.tree.map(np.asarray, params)``) or a
flat dict of the artifact's ``::``-joined paths
(``blocks::0::attn::wq::w``, as ``checkpoint/store.py`` writes them) --
and returns the port's :class:`~repro_torch.models.lm.LMParams` on
``device``. The layouts are the same (stacked ``(n_groups, ...)`` blocks),
so the bridge only moves bytes: every tensor is bitwise its array.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.analognet import CNNConfig
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import LMParams, block_period

SEP = "::"


def nest(flat: Mapping) -> dict:
    """Rebuild nested dicts from ``::``-joined flat keys."""
    out: dict = {}
    for key, arr in flat.items():
        node = out
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def to_tensor(arr, device) -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor on ``device``, bitwise."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, as JAX hands it out
        t = torch.from_numpy(np.array(arr.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def tree_to_torch(tree: Any, device) -> Any:
    """Every array leaf of a dict/tuple/list tree as a tensor on ``device``."""
    if isinstance(tree, Mapping):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    return to_tensor(tree, device)


def _seq(node) -> tuple:
    """A sequence subtree: kept as is, or rebuilt from '0', '1', ... keys."""
    if node is None:
        return ()
    if isinstance(node, Mapping):
        return tuple(node[str(i)] for i in range(len(node)))
    return tuple(node)


def lm_params_from_nested(nested: Mapping, device) -> LMParams:
    """:class:`LMParams` from a nested mapping keyed by its field names
    (absent ``tail``/``extras``/``final_norm`` subtrees hold no leaves)."""
    t = lambda node: tree_to_torch(node, device)
    return LMParams(
        embed=t(nested["embed"]),
        blocks=tuple(t(b) for b in _seq(nested["blocks"])),
        tail=tuple(t(b) for b in _seq(nested.get("tail"))),
        final_norm=t(nested.get("final_norm", {})),
        lm_head=t(nested["lm_head"]),
        extras=t(nested.get("extras", {})),
        gain_s=to_tensor(nested["gain_s"], device),
    )


def params_from_numpy(
    tree: Any, cfg: Optional[ModelConfig] = None, device="cuda"
) -> LMParams:
    """The reference's LM params (numpy leaves) as the port's, on ``device``.

    ``cfg``, when given, is checked against the tree (the period's block
    kinds, group count and each mixer's projection widths -- attention's
    wq/wk, the SSM's in/out_proj, the RG-LRU block's five linears --; a MoE
    block's expert banks and its shared expert; the lm_head's ``vocab *
    n_codebooks`` columns; the vision family's ``extras/patch_proj``) so a
    tree of another architecture is refused. An expert bank
    (``w1``/``w3``/``w2`` of (n_groups, E, K, N), ``r_adc`` (n_groups, 3),
    ``w_clip_buf`` (n_groups, 3, 2), the router, the optional ``shared``
    expert; a compiled program's ``out_scale_buf``, ``b_adc_buf`` and
    ``read_buf`` too) moves leaf for leaf like any other node.
    """
    dev = resolve_device(device)
    if hasattr(tree, "_fields"):
        nested = {f: getattr(tree, f) for f in tree._fields}
    elif isinstance(tree, Mapping):
        nested = nest(tree)
    else:
        raise TypeError(f"params_from_numpy: unsupported tree {type(tree).__name__}")
    params = lm_params_from_nested(nested, dev)
    if cfg is not None:
        period = block_period(cfg)
        n_groups = cfg.n_layers // len(period)
        head = tuple(params.lm_head["w"].shape)
        want_head = (cfg.d_model, cfg.vocab * max(cfg.n_codebooks, 1))
        if len(params.blocks) != len(period) or head != want_head:
            raise ValueError(
                f"params do not match {cfg.name!r}: {len(params.blocks)} blocks a "
                f"group (want {len(period)}), lm_head {head} (want {want_head})"
            )
        extras = {k: tuple(v["w"].shape) for k, v in params.extras.items()}
        want_extras = ({"patch_proj": (cfg.d_model, cfg.d_model)}
                       if cfg.frontend == "vision_patches" else {})
        if extras != want_extras:
            raise ValueError(f"params do not match {cfg.name!r}: extras {extras} (want "
                             f"{want_extras})")
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        for kind, block in zip(period, params.blocks):
            mixer = {"ssm": "ssm", "rec": "rec"}.get(kind, "attn")
            if mixer not in block or (kind == "moe") != ("moe" in block):
                raise ValueError(f"params do not match {cfg.name!r}: a {kind!r} block "
                                 f"holds {sorted(block)}")
            for name, (k_in, n_out) in _projections(kind, cfg).items():
                got = tuple(block[mixer][name]["w"].shape) if name in block[mixer] else None
                if got != (n_groups, k_in, n_out):
                    raise ValueError(
                        f"params do not match {cfg.name!r}: blocks {mixer}/{name} {got} "
                        f"(want {(n_groups, k_in, n_out)})"
                    )
            if kind != "moe":
                continue
            moe = block["moe"]
            banks = {fam: tuple(moe[fam].shape) for fam in ("w1", "w3", "w2")}
            want_banks = {"w1": (n_groups, e, d, f), "w3": (n_groups, e, d, f),
                          "w2": (n_groups, e, f, d)}
            if banks != want_banks or ("shared" in moe) != cfg.shared_expert:
                raise ValueError(
                    f"params do not match {cfg.name!r}: expert banks {banks} (want "
                    f"{want_banks}), shared expert {'shared' in moe} (want "
                    f"{cfg.shared_expert})"
                )
    return params


def _projections(kind: str, cfg: ModelConfig) -> dict:
    """The (K, N) of a block kind's mixer projections under ``cfg``."""
    m = cfg.d_model
    if kind == "ssm":
        d_in = cfg.d_inner
        return {"in_proj": (m, 2 * d_in + 2 * cfg.ssm_state + cfg.ssm_heads),
                "out_proj": (d_in, m)}
    if kind == "rec":
        w = cfg.lru_width or m
        return {"gate_proj": (m, w), "x_proj": (m, w), "out_proj": (w, m),
                "a_gate": (w, w), "i_gate": (w, w)}
    return {"wq": (m, cfg.n_heads * cfg.hd), "wk": (m, cfg.n_kv_heads * cfg.hd)}


def cnn_params_from_numpy(tree: Mapping, cfg: CNNConfig, device="cuda") -> dict:
    """The reference's CNN params (numpy leaves) as the port's, on
    ``device``, bitwise: a nested dict (``cnn_init``'s, or a compiled
    program's) or a flat dict of ``::``-joined paths.

    The order of the layers is kept as given: ``compile_program`` programs
    layer n of its walk from ``fold_in(key, n)``, so the order is part of
    the chip. ``cnn_init`` inserts ``gain_s``, the convs in config order,
    then ``fc``; a tree that went through ``jax.tree.map`` comes back with
    its keys sorted, and programs a different chip. ``cfg`` is checked
    against the tree (layers and weight shapes: the 4D kernel, or the
    programmed 2D block).
    """
    dev = resolve_device(device)
    if not isinstance(tree, Mapping):
        raise TypeError(f"cnn_params_from_numpy: unsupported tree {type(tree).__name__}")
    nested = nest(tree) if any(SEP in k for k in tree) else tree
    params = tree_to_torch(nested, dev)
    # each layer's weight: its kernel, or its programmed 2D block
    want = {s.name: ((s.kh, s.kw, s.c_in, 1 if s.depthwise else s.c_out),
                     (s.kh * s.kw * s.c_in, s.c_out)) for s in cfg.convs}
    want["fc"] = ((cfg.fc_width, cfg.n_classes),)
    layers = [k for k in params if k != "gain_s"]
    bad = set(layers) ^ set(want)
    bad |= {k for k in set(layers) & set(want)
            if tuple(params[k]["w"].shape) not in want[k]}
    if bad or "gain_s" not in params:
        raise ValueError(f"params do not match {cfg.name!r}: layers {sorted(bad)} differ "
                         "(or gain_s is missing)")
    return params
