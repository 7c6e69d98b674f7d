"""Crossbar mapping, port of ``repro.core.crossbar``: im2col, depthwise
densification and the layer-serial tiler (paper Sec. 5, Fig. 6, Appendix D).

  * convolutions run as 2D GEMMs (Fig. 2c): a (kh, kw, Cin, Cout) kernel is
    a (kh*kw*Cin) x Cout crossbar block, and the activations are
    IM2COL-expanded into patch vectors (:func:`im2col`);
  * a depthwise kernel is *densified* to its block-diagonal (kh*kw*C) x C
    form, utilization 1/C (:func:`depthwise_densify`);
  * :func:`map_layers` packs every layer's block onto the physical array
    (1024 x 512 in AON-CiM), folding taller layers over row tiles, and
    reports utilization (:class:`Mapping`).

The placement code is pure Python, the reference's line for line, so a
mapping is the reference's placement for placement; the compute helpers
work on tensors and give the reference's values bit for bit (they only
move and zero values).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# im2col / depthwise densification (compute-side helpers)
# ---------------------------------------------------------------------------


def _pads(size: int, k: int, stride: int, padding: str) -> tuple[int, int, int]:
    """(pad before, pad after, outputs) of one spatial dim, as XLA pads:
    "SAME" gives ceil(size / stride) outputs and puts the odd pixel of the
    total padding AFTER (at stride 2 on width 10 with k = 3 that is (0, 1),
    where a symmetric padding of 1 would shift every patch)."""
    if padding == "SAME":
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return total // 2, total - total // 2, out
    if padding == "VALID":
        return 0, 0, (size - k) // stride + 1
    raise ValueError(f"im2col: padding {padding!r} (SAME or VALID)")


def im2col(x: Tensor, kh: int, kw: int, stride: int, padding: str = "SAME") -> Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, kh*kw*C) patch extraction.

    Mirrors the AON-CiM hardware IM2COL unit that feeds the DACs: features in
    (kh, kw, C) order, matching the (kh*kw*Cin, Cout) weight layout of
    :func:`conv_weight_as_matrix`, and XLA's padding (:func:`_pads`).
    """
    b, h, w, c = x.shape
    hb, ha, ho = _pads(h, kh, stride, padding)
    wb, wa, wo = _pads(w, kw, stride, padding)
    xp = torch.nn.functional.pad(x, (0, 0, wb, wa, hb, ha))
    cols = [
        xp[:, i : i + stride * (ho - 1) + 1 : stride, j : j + stride * (wo - 1) + 1 : stride, :]
        for i in range(kh)
        for j in range(kw)
    ]
    return torch.stack(cols, dim=3).reshape(b, ho, wo, kh * kw * c)


def conv_weight_as_matrix(w: Tensor) -> Tensor:
    """(kh, kw, Cin, Cout) -> (kh*kw*Cin, Cout) crossbar weight block."""
    kh, kw, cin, cout = w.shape
    return w.reshape(kh * kw * cin, cout)


def depthwise_densify(w: Tensor) -> Tensor:
    """(kh, kw, C, 1) depthwise kernel -> dense (kh*kw*C, C) block-diagonal.

    Row (i, j, c) has a single non-zero in column c: the "non-zero diagonal"
    expansion of Fig. 3 (left); utilization 1/C.
    """
    kh, kw, c, m = w.shape
    assert m == 1, "channel-multiplier depthwise not used by the paper models"
    eye = torch.eye(c, dtype=w.dtype, device=w.device)
    return (w[..., 0][..., None] * eye).reshape(kh * kw * c, c)


# ---------------------------------------------------------------------------
# Layer-serial tiler
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """Static description of one mapped layer."""

    name: str
    rows: int  # fan-in after im2col (kh*kw*Cin [+1 bias])
    cols: int  # fan-out (Cout)
    n_patches: int  # MVMs per inference (spatial positions, or tokens)
    nnz_rows: int | None = None  # effective rows with non-zeros (depthwise)

    @property
    def weights(self) -> int:
        return self.rows * self.cols

    @property
    def nnz(self) -> int:
        """Non-zero weights actually contributing (== weights unless DW)."""
        if self.nnz_rows is None:
            return self.weights
        return self.nnz_rows * self.cols

    @property
    def macs(self) -> int:
        return self.nnz * self.n_patches


@dataclasses.dataclass(frozen=True)
class Placement:
    layer: LayerShape
    row0: int
    col0: int
    rows: int
    cols: int
    row_tile_of_layer: int  # which K-tile of the layer this block holds
    array_index: int = 0  # which physical array holds this block


@dataclasses.dataclass
class Mapping:
    array_rows: int
    array_cols: int
    placements: list[Placement]
    n_arrays: int

    @property
    def cells_total(self) -> int:
        return self.n_arrays * self.array_rows * self.array_cols

    @property
    def cells_used(self) -> int:
        return sum(p.rows * p.cols for p in self.placements)

    @property
    def cells_nonzero(self) -> int:
        total = 0
        for p in self.placements:
            frac = p.layer.nnz / max(p.layer.weights, 1)
            total += int(round(p.rows * p.cols * frac))
        return total

    @property
    def utilization(self) -> float:
        """Area utilization counting only non-zero (contributing) cells."""
        return self.cells_nonzero / self.cells_total

    @property
    def occupancy(self) -> float:
        """Fraction of cells claimed (incl. zero-padded depthwise diagonals)."""
        return self.cells_used / self.cells_total


def split_layer(layer: LayerShape, array_rows: int, array_cols: int) -> list[tuple[int, int, int]]:
    """Split a layer into (row_tile_idx, rows, cols) physical blocks: row
    tiles of a layer taller than the array (digital partial sums), column
    strips of one wider than it."""
    blocks = []
    n_row_tiles = math.ceil(layer.rows / array_rows)
    n_col_strips = math.ceil(layer.cols / array_cols)
    for rt in range(n_row_tiles):
        r = min(array_rows, layer.rows - rt * array_rows)
        for cs in range(n_col_strips):
            c = min(array_cols, layer.cols - cs * array_cols)
            blocks.append((rt, r, c))
    return blocks


def map_layers(layers: Sequence[LayerShape], array_rows: int = 1024,
               array_cols: int = 512) -> Mapping:
    """Pack layer blocks onto as few physical arrays as needed.

    Guillotine free-rectangle packing (best-short-side-fit, blocks sorted by
    area descending): each placement splits the chosen free rectangle into
    right/bottom remainders; a block that fits no array opens a new one.
    """
    blocks: list[tuple[LayerShape, int, int, int]] = []
    for layer in layers:
        for rt, r, c in split_layer(layer, array_rows, array_cols):
            blocks.append((layer, rt, r, c))
    blocks.sort(key=lambda b: (-b[2] * b[3], -b[2]))

    placements: list[Placement] = []
    # per-array list of free rectangles (row0, col0, rows, cols)
    arrays: list[list[tuple[int, int, int, int]]] = []

    def place_in(free: list, r: int, c: int):
        best = None
        for i, (_fr, _fc, frr, fcc) in enumerate(free):
            if r <= frr and c <= fcc:
                short = min(frr - r, fcc - c)
                if best is None or short < best[0]:
                    best = (short, i)
        if best is None:
            return None
        fr, fc, frr, fcc = free.pop(best[1])
        # split: remainder below (full width) + remainder right (block height)
        if frr - r > 0:
            free.append((fr + r, fc, frr - r, fcc))
        if fcc - c > 0:
            free.append((fr, fc + c, r, fcc - c))
        return fr, fc

    for layer, rt, r, c in blocks:
        pos = None
        arr_idx = 0
        for arr_idx, free in enumerate(arrays):
            pos = place_in(free, r, c)
            if pos is not None:
                break
        if pos is None:
            arrays.append([(0, 0, array_rows, array_cols)])
            arr_idx = len(arrays) - 1
            pos = place_in(arrays[-1], r, c)
            assert pos is not None, (layer.name, r, c)
        placements.append(Placement(layer, pos[0], pos[1], r, c, rt, arr_idx))

    return Mapping(array_rows, array_cols, placements, max(len(arrays), 1))


def mapping_to_dict(mapping: Mapping) -> dict:
    """JSON-serializable form of a Mapping (program-artifact metadata)."""
    return {
        "array_rows": mapping.array_rows,
        "array_cols": mapping.array_cols,
        "n_arrays": mapping.n_arrays,
        "placements": [
            {
                "layer": dataclasses.asdict(p.layer),
                "row0": p.row0,
                "col0": p.col0,
                "rows": p.rows,
                "cols": p.cols,
                "row_tile_of_layer": p.row_tile_of_layer,
                "array_index": p.array_index,
            }
            for p in mapping.placements
        ],
    }


def mapping_from_dict(d: dict) -> Mapping:
    """Inverse of :func:`mapping_to_dict` (placements round-trip exactly)."""
    placements = [
        Placement(
            layer=LayerShape(**p["layer"]),
            row0=p["row0"],
            col0=p["col0"],
            rows=p["rows"],
            cols=p["cols"],
            row_tile_of_layer=p["row_tile_of_layer"],
            array_index=p["array_index"],
        )
        for p in d["placements"]
    ]
    return Mapping(d["array_rows"], d["array_cols"], placements, d["n_arrays"])


def occupancy_grid(mapping: Mapping, array_index: int = 0) -> np.ndarray:
    """Dense 0/1 grid of claimed cells of physical array ``array_index``
    (Fig. 6)."""
    if not 0 <= array_index < mapping.n_arrays:
        raise ValueError(
            f"array_index {array_index} out of range for "
            f"{mapping.n_arrays}-array mapping"
        )
    grid = np.zeros((mapping.array_rows, mapping.array_cols), np.int32)
    for p in mapping.placements:
        if p.array_index == array_index:
            grid[p.row0 : p.row0 + p.rows, p.col0 : p.col0 + p.cols] += 1
    return grid
