"""The dry run's input-shape cells and the specs of a step's inputs, port
of ``repro.configs.shapes``.

Every (arch x shape) pair is one dry-run cell:
  train_4k     seq=4096   batch=256  -> train_step
  prefill_32k  seq=32768  batch=32   -> prefill_step
  decode_32k   seq=32768  batch=128  -> serve_step (1 new token, 32k cache)
  long_500k    seq=524288 batch=1    -> serve_step (sub-quadratic archs only)

A spec (:class:`TensorSpec`) is a shape and a dtype, the counterpart of
``jax.ShapeDtypeStruct``: it makes a tensor only when the dry run asks
(:meth:`TensorSpec.make`), under the caller's ``FakeTensorMode``, so a
full config's inputs are never allocated.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import SUBQUADRATIC
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, nothing allocated."""

    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * self.dtype.itemsize

    def make(self, device) -> torch.Tensor:
        """An uninitialised tensor of this spec on ``device`` (a fake one
        under the caller's ``FakeTensorMode``)."""
        return torch.empty(self.shape, dtype=self.dtype, device=device)


def applicable(arch_id: str, shape_name: str) -> bool:
    """long_500k needs sub-quadratic sequence mixing (the reference's rule)."""
    if shape_name == "long_500k":
        return arch_id in SUBQUADRATIC
    return True


def _token_batch_specs(cfg: ModelConfig, batch: int, seq: int, with_labels: bool) -> dict:
    i32 = torch.int32
    specs: dict = {}
    if cfg.frontend == "audio_frames":
        specs["frames"] = TensorSpec((batch, seq, cfg.d_model), cfg.dtype)
        if with_labels:
            specs["labels"] = TensorSpec((batch, seq, cfg.n_codebooks), i32)
        return specs
    if cfg.frontend == "vision_patches":
        s_text = seq - cfg.num_patches  # the transformer sees exactly `seq` positions
        specs["tokens"] = TensorSpec((batch, s_text), i32)
        specs["patches"] = TensorSpec((batch, cfg.num_patches, cfg.d_model), cfg.dtype)
        if with_labels:
            specs["labels"] = TensorSpec((batch, s_text), i32)
        return specs
    specs["tokens"] = TensorSpec((batch, seq), i32)
    if with_labels:
        specs["labels"] = TensorSpec((batch, seq), i32)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, s_max: int, stacked: bool = True,
                kv_heads=None):
    """The specs of ``models.lm.init_lm_cache(cfg, batch, s_max, cfg.dtype,
    stacked=stacked)``, in its structure (its leaves are shaped on fake
    tensors: nothing is allocated). ``kv_heads``: a rank's (a sharded
    step's cache, ``launch.steps.sharded_cache``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.lm import init_lm_cache

    with FakeTensorMode():
        cache = init_lm_cache(cfg, batch, s_max, cfg.dtype, stacked=stacked, device="cpu",
                              kv_heads=kv_heads)
    return tree_lib.tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), cache)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Specs of every input of the cell's step: ``batch`` (the data batch)
    and, but for train, ``cache`` (the KV/state cache)."""
    cell = SHAPES[shape_name]
    if cell.kind == "train":
        return {"batch": _token_batch_specs(cfg, cell.global_batch, cell.seq_len,
                                            with_labels=True)}
    if cell.kind == "prefill":
        return {
            "batch": _token_batch_specs(cfg, cell.global_batch, cell.seq_len,
                                        with_labels=False),
            "cache": cache_specs(cfg, cell.global_batch, cell.seq_len),
        }
    # decode: one new token against a cache of seq_len, in the unstacked
    # (list) layout of per-layer in-place writes
    specs: dict = {"cache": cache_specs(cfg, cell.global_batch, cell.seq_len, stacked=False)}
    if cfg.frontend == "audio_frames":
        specs["batch"] = {"frames": TensorSpec((cell.global_batch, 1, cfg.d_model), cfg.dtype)}
    else:
        specs["batch"] = {"tokens": TensorSpec((cell.global_batch, 1), torch.int32)}
    return specs
