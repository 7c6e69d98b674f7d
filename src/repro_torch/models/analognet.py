"""AnalogNet-KWS and AnalogNet-VWW (paper Sec. 4.1, Appendix B), port of
``repro.models.analognet``.

The layer tables are the reference's reconstruction of the paper's Fig. 10:

  AnalogNet-KWS -- 4x dense conv3x3 at 106 channels on a 49x10 MFCC map:
    305.7k weights (58.3% of the 1024x512 array), 76.8 MOP/inference,
    tall im2col blocks (954 rows <= 1024).
  AnalogNet-VWW -- a fused-MBConv backbone (dense 3x3 expand + 1x1 project)
    at 100x100x3 without the two early narrow bottleneck layers: 347k
    weights (66.2%), 75 MOP/inference.

Convolutions run as IM2COL + :func:`~repro_torch.core.analog.analog_matmul`
-- the AON-CiM dataflow IM2COL unit -> DAC -> crossbar -> ADC -- so on a
programmed chip every conv and the FC is one programmed MVM through the
execute phase (on a CUDA tensor, the Hopper kernel ``kernels.analog_mvm``).
BN (folded to scale/bias), ReLU and the global average pool are digital.
Weights draw through the RNG bridge: :func:`cnn_init` from one key gives the
reference's weights bit for bit. :func:`cnn_loss` is the training loss (the
forward is differentiable to the input and to every 4-D kernel through
im2col and the crossbar transforms).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.core.analog import AnalogConfig, AnalogCtx, analog_matmul
from repro_torch.core.crossbar import (
    LayerShape,
    conv_weight_as_matrix,
    depthwise_densify,
    im2col,
)
from repro_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    kh: int
    kw: int
    c_in: int
    c_out: int
    stride: int = 1
    depthwise: bool = False


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: tuple
    in_channels: int
    convs: tuple  # of ConvSpec
    n_classes: int
    fc_width: int  # channels entering the final FC


def analognet_kws_config() -> CNNConfig:
    c = 106
    return CNNConfig(
        name="analognet_kws",
        input_hw=(49, 10),
        in_channels=1,
        convs=(
            ConvSpec("conv1", 3, 3, 1, c, 1),
            ConvSpec("conv2", 3, 3, c, c, 2),
            ConvSpec("conv3", 3, 3, c, c, 1),
            ConvSpec("conv4", 3, 3, c, c, 1),
        ),
        n_classes=12,  # full 12-keyword Speech Commands task
        fc_width=c,
    )


def analognet_vww_config(with_bottlenecks: bool = False) -> CNNConfig:
    convs = [ConvSpec("stem", 3, 3, 3, 24, 2)]
    if with_bottlenecks:
        # Table 1 ablation (last row): the two early narrow layers the paper
        # removes -- noise-robustness bottlenecks (Fig. 3 right)
        convs += [
            ConvSpec("bneck1", 1, 1, 24, 8, 1),
            ConvSpec("bneck2", 3, 3, 8, 24, 1),
        ]
    convs += [
        ConvSpec("b1_expand", 3, 3, 24, 96, 2),
        ConvSpec("b1_proj", 1, 1, 96, 32, 1),
        ConvSpec("b2_expand", 3, 3, 32, 128, 2),
        ConvSpec("b2_proj", 1, 1, 128, 48, 1),
        ConvSpec("b3_expand", 3, 3, 48, 192, 2),
        ConvSpec("b3_proj", 1, 1, 192, 64, 1),
        ConvSpec("b4_expand", 3, 3, 64, 256, 1),
        ConvSpec("b4_proj", 1, 1, 256, 96, 1),
        ConvSpec("head", 1, 1, 96, 128, 1),
    ]
    return CNNConfig(
        name="analognet_vww" + ("_bneck" if with_bottlenecks else ""),
        input_hw=(100, 100),
        in_channels=3,
        convs=tuple(convs),
        n_classes=2,
        fc_width=128,
    )


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------


def cnn_init(key: Tensor, cfg: CNNConfig, device="cuda") -> dict:
    """The reference's CNN params from the threefry ``key``, on ``device``:
    ``gain_s``, then each conv in config order, then ``fc`` -- the insertion
    order ``compile_program`` walks (layer n programs from ``fold_in(key,
    n)``)."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    params: dict = {"gain_s": torch.ones((), **f32)}
    keys = prng.split(key.to(dev), len(cfg.convs) + 1)
    for k, spec in zip(keys, cfg.convs):
        c_mult = 1 if spec.depthwise else spec.c_in
        fan_in = spec.kh * spec.kw * c_mult
        shape = (
            (spec.kh, spec.kw, spec.c_in, 1)
            if spec.depthwise
            else (spec.kh, spec.kw, spec.c_in, spec.c_out)
        )
        params[spec.name] = {
            "w": prng.normal(k, shape) * (2.0 / fan_in) ** 0.5,
            "r_adc": torch.ones((), **f32),
            "w_clip_buf": torch.tensor([-1.0, 1.0], **f32),
            "bn_scale": torch.ones((spec.c_out,), **f32),
            "bn_bias": torch.zeros((spec.c_out,), **f32),
        }
    params["fc"] = {
        "w": prng.normal(keys[-1], (cfg.fc_width, cfg.n_classes)) * cfg.fc_width**-0.5,
        "b": torch.zeros((cfg.n_classes,), **f32),
        "r_adc": torch.ones((), **f32),
        "w_clip_buf": torch.tensor([-1.0, 1.0], **f32),
    }
    return params


def conv_apply(p: dict, x: Tensor, spec: ConvSpec, ctx: AnalogCtx, relu: bool = True) -> Tensor:
    """IM2COL + analog matmul + digital BN/ReLU (the hardware dataflow)."""
    if p["w"].dim() == 2:
        # a compiled CiMProgram: the program phase already flattened (or
        # densified) the kernel into its crossbar block and programmed it
        w2d = p["w"]
    elif spec.depthwise:
        # the analog simulation densifies a depthwise kernel, including the
        # noise of the zero cells on shared bitlines
        w2d = depthwise_densify(p["w"])
    else:
        w2d = conv_weight_as_matrix(p["w"])
    patches = im2col(x, spec.kh, spec.kw, spec.stride, "SAME")
    y = analog_matmul(
        patches,
        w2d.to(x.dtype),
        r_adc=p["r_adc"],
        w_min=p["w_clip_buf"][0],
        w_max=p["w_clip_buf"][1],
        ctx=ctx,
        out_scale=p.get("out_scale_buf"),
    )
    # BN folded to scale/bias, in the digital datapath (Sec. 5.2)
    y = y * p["bn_scale"].to(y.dtype) + p["bn_bias"].to(y.dtype)
    return torch.relu(y) if relu else y


def cnn_apply(params: dict, x: Tensor, analog_cfg: AnalogConfig, cfg: CNNConfig, rng=None,
              mvm=None) -> Tensor:
    """x: (B, H, W, C) -> logits (B, n_classes). ``rng`` is the call's
    threefry key (``pcm_infer`` draws from it); ``mvm`` replaces the execute
    phase's MVM for the call (``AnalogCtx.mvm``: a check drives a forward on
    the card through the plain version with it)."""
    ctx = AnalogCtx(cfg=analog_cfg, gain_s=params["gain_s"], key=rng, mvm=mvm)
    for spec in cfg.convs:
        x = conv_apply(params[spec.name], x, spec, ctx)
    x = x.mean(dim=(1, 2))  # global average pool (digital)
    fc = params["fc"]
    y = analog_matmul(
        x,
        fc["w"].to(x.dtype),
        r_adc=fc["r_adc"],
        w_min=fc["w_clip_buf"][0],
        w_max=fc["w_clip_buf"][1],
        ctx=ctx,
        out_scale=fc.get("out_scale_buf"),
    )
    return y + fc["b"].to(y.dtype)


def cnn_loss(params: dict, batch: dict, analog_cfg: AnalogConfig, cfg: CNNConfig, rng=None):
    """Mean cross-entropy of ``cnn_apply`` on ``batch`` ({"x", "y"}) ->
    (loss, {"loss", "acc"})."""
    logits = cnn_apply(params, batch["x"], analog_cfg, cfg, rng).float()
    logp = torch.log_softmax(logits, dim=-1)
    y = batch["y"].long()
    nll = -logp.gather(-1, y[:, None]).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return nll, {"loss": nll, "acc": acc}


def crossbar_transforms(cfg: CNNConfig) -> dict:
    """Weight-to-crossbar-block transforms for ``engine.compile_program``:
    each conv's path -> the function that flattens its 4D kernel into its
    2D block (depthwise kernels densified), so programming noise lands on
    the crossbar cells, zero cells of the depthwise diagonals included."""
    return {
        spec.name: depthwise_densify if spec.depthwise else conv_weight_as_matrix
        for spec in cfg.convs
    }


# ---------------------------------------------------------------------------
# Crossbar layer shapes (for the AON-CiM model)
# ---------------------------------------------------------------------------


def _spatial_sizes(cfg: CNNConfig) -> list[tuple]:
    h, w = cfg.input_hw
    sizes = []
    for spec in cfg.convs:
        h = -(-h // spec.stride)
        w = -(-w // spec.stride)
        sizes.append((h, w))
    return sizes


def layer_shapes(cfg: CNNConfig) -> list[LayerShape]:
    """Crossbar-mapped LayerShapes for every layer (Fig. 6 / Fig. 8 input)."""
    shapes = []
    for spec, (h, w) in zip(cfg.convs, _spatial_sizes(cfg)):
        rows = spec.kh * spec.kw * spec.c_in
        if spec.depthwise:
            shapes.append(LayerShape(spec.name, rows, spec.c_in, n_patches=h * w,
                                     nnz_rows=spec.kh * spec.kw))
        else:
            shapes.append(LayerShape(spec.name, rows, spec.c_out, n_patches=h * w))
    shapes.append(LayerShape("fc", cfg.fc_width, cfg.n_classes, n_patches=1))
    return shapes


def mvm_shapes(cfg: CNNConfig, batch: int = 1) -> list[tuple[str, int, int, int]]:
    """(layer, M, K, N) of every programmed MVM of one :func:`cnn_apply` over
    ``batch`` images, in order: M = batch x the layer's output pixels (its
    im2col patches; 1 per image for the FC), K x N its crossbar block."""
    return [(s.name, batch * s.n_patches, s.rows, s.cols) for s in layer_shapes(cfg)]
