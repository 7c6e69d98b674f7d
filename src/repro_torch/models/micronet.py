"""MicroNet-KWS-S, the paper's depthwise counterexample (Banbury et al.
2021), port of ``repro.models.micronet``.

A depthwise-separable backbone of 112-channel blocks: on a crossbar a
densified depthwise layer uses 1/112 ~ 0.9% of its block. Used by
Appendix D / Table 3 (utilization against crossbar size, through the
sequential group-GEMM split of :func:`depthwise_group_shapes`) and runs
through the same ``cnn_*`` functions as the AnalogNets.
"""

from __future__ import annotations

import math

from repro_torch.core.crossbar import LayerShape
from repro_torch.models.analognet import CNNConfig, ConvSpec, _spatial_sizes


def micronet_kws_s_config() -> CNNConfig:
    c = 112
    convs = [ConvSpec("stem", 3, 3, 1, c, 2)]
    for i in range(3):
        convs.append(ConvSpec(f"dw{i+1}", 3, 3, c, c, 1, depthwise=True))
        convs.append(ConvSpec(f"pw{i+1}", 1, 1, c, c, 1))
    return CNNConfig(
        name="micronet_kws_s",
        input_hw=(49, 10),
        in_channels=1,
        convs=tuple(convs),
        n_classes=12,
        fc_width=c,
    )


def depthwise_group_shapes(name: str, kk: int, channels: int, n_patches: int,
                           array_rows: int, array_cols: int) -> list[LayerShape]:
    """Split a densified DW layer into sequential channel-group GEMMs
    (Appendix D): groups of n = min(C, array_rows // kk, array_cols)
    channels as (kk*n x n) diagonal blocks, utilization 1/n each, latency
    growing with the number of groups (Table 3's trade-off)."""
    n = max(1, min(channels, array_rows // kk, array_cols))
    groups = math.ceil(channels / n)
    shapes = []
    for g in range(groups):
        c_g = min(n, channels - g * n)
        shapes.append(LayerShape(f"{name}.g{g}", rows=kk * c_g, cols=c_g,
                                 n_patches=n_patches, nnz_rows=kk))
    return shapes


def micronet_layer_shapes(cfg: CNNConfig, array_rows: int = 1024, array_cols: int = 512,
                          split_depthwise: bool = True) -> list[LayerShape]:
    """LayerShapes with the DW splitting scheme applied (Table 3)."""
    shapes: list[LayerShape] = []
    for spec, (h, w) in zip(cfg.convs, _spatial_sizes(cfg)):
        kk = spec.kh * spec.kw
        if spec.depthwise:
            if split_depthwise:
                shapes += depthwise_group_shapes(spec.name, kk, spec.c_in, h * w,
                                                 array_rows, array_cols)
            else:
                shapes.append(LayerShape(spec.name, kk * spec.c_in, spec.c_in, h * w,
                                         nnz_rows=kk))
        else:
            shapes.append(LayerShape(spec.name, kk * spec.c_in, spec.c_out, h * w))
    shapes.append(LayerShape("fc", cfg.fc_width, cfg.n_classes, n_patches=1))
    return shapes
