"""One training step on two devices, held together at the same forward values.

A stage-2 (``analog_train``) step is chaotic in its rounding. Every analog
MVM quantizes its input (the DAC) and its output (the ADC) and gates the
gradient at both clip boundaries, and at init many inputs and outputs sit
beyond the clip range. A rounding difference of one ulp anywhere flips a
few ADC codes, each flip moves the next layer's inputs by a whole step,
and the flips spread layer by layer; every clip gate that flips adds or
drops a whole gradient term, and every code that flips moves a range
gradient (a sum of quantization errors with cancellation) by a whole
step. At tinyllama-1.1b's full width on 2 layers (64 tokens, H100 80GB
HBM3 at 700 W, ``chip_smoke.py --lm-step-readings``) a free step on the
card and on the CPU, from the same draws, read 0.096 (fp32) and 0.14
(bf16) relative L2 apart on a weight gradient and up to 1.09 and 0.54 on
a range gradient; each MVM's output drifted from 3e-5 apart in the first
layer to 5e-3 in the second.

So the two devices' steps are held at the same forward values:
:func:`tape` records, in call order, the inputs and outputs of every
execute-phase MVM (``engine.execute_mvm``), digital matmul
(``engine.execute_digital``) and prefill attention
(``ops.flash_attention_ste``), the outputs of every weight-noise draw
(``noise.inject``) of the step run inside it, and a SHA-256 digest of
every quant-noise mask (``prng.bernoulli``). With ``lock=`` (another
device's tape) each of those calls takes the recorded inputs, computes
its own output from them, keeps it for the comparison, and passes on the
recorded output; every value it takes carries its own gradient
(:class:`_Locked`). The step's gradients are then this device's autograd
at the other device's forward values, each call's own output is its own
function of the other device's inputs, and what differs is each call's
rounding alone, nothing carried on: the same steps locked read at most
3.1e-3 (fp32) and 8.8e-3 (bf16) apart on a weight gradient over five
seeds (:data:`GRAD_RTOL`). A weight-noise draw whose index is not in
``draw`` is not computed at all: its recorded value is used, with the
gradient ``noise.inject`` gives it (to the clipped weight).
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import engine, noise
from repro_torch.kernels import ops
from repro_torch.kernels.ref import n_tiles

Tensor = torch.Tensor

#: the kinds of calls a tape holds, by the function each one replaces
KINDS = ("mvm", "digital", "attention", "noise")


class _Locked(torch.autograd.Function):
    """``value`` forward, bit for bit; the gradient passes to ``own``."""

    @staticmethod
    def forward(ctx, value, own):
        return value

    @staticmethod
    def backward(ctx, g):
        return None, g


#: the positional inputs of each kind that a locked call takes from the
#: record: an MVM's x_q, a digital matmul's x, the attention's q, k and v
#: (the weights are the step's own params, the same on both devices)
INPUTS = {"mvm": (0,), "digital": (0,), "attention": (0, 1, 2), "noise": ()}


def _host(x: Tensor) -> Tensor:
    return x.detach().cpu().clone()


def _lock(value: Tensor, own: Tensor) -> Tensor:
    """``value`` (on ``own``'s device, in its dtype), with ``own``'s gradient."""
    value = value.to(own.device, own.dtype)
    return _Locked.apply(value, own) if own.requires_grad else value


class Tape:
    """The calls of one step in order: ``calls`` ({"kind", "ins", "out",
    "meta"}, the tensors on the host; ``out`` None for a draw taken from
    ``lock``) and ``masks``
    (SHA-256 of each quant-noise mask). ``lock``: another device's tape of
    the same step: each call of ``lock_kinds`` takes its inputs (``INPUTS``)
    from the record and passes the recorded output on (the n-th call of a
    kind takes the n-th recorded call of that kind);
    ``draw``: the indices, among the weight-noise draws, to compute here
    (None: all). ``on_host=False`` keeps the recorded tensors on their
    device (two steps on one card, held together)."""

    def __init__(self, lock: Optional["Tape"] = None, draw: Optional[set] = None,
                 lock_kinds: tuple = KINDS, on_host: bool = True):
        self.calls: list = []
        self.masks: list = []
        self.lock = lock
        self.draw = draw
        self.lock_kinds = lock_kinds
        self.keep = _host if on_host else (lambda x: x.detach().clone())

    def of(self, kind: str) -> list:
        return [c for c in self.calls if c["kind"] == kind]


def _mvm_meta(x_q, w, r_adc, plan, **_) -> dict:
    """An MVM's ADC step and conversions per output (the tolerance model)."""
    levels = 2 ** (plan.spec.b_adc - 1) - 1
    return {"step": float(r_adc.detach().abs()) / levels,
            "n_tiles": n_tiles(plan.k, plan.tile_rows, plan.per_tile_adc)}


@contextlib.contextmanager
def tape(t: Tape):
    """Run the body with the step's MVMs, attention, weight-noise draws and
    masks recorded into ``t`` (and locked to ``t.lock``'s values)."""
    orig = {"mvm": engine.execute_mvm, "digital": engine.execute_digital,
            "attention": ops.flash_attention_ste, "noise": noise.inject,
            "mask": prng.bernoulli}
    seen = {kind: 0 for kind in KINDS}

    def wrapped(kind, fn, meta=None):
        def call(*a, **k):
            i, ref = seen[kind], None
            seen[kind] += 1
            if t.lock is not None and kind in t.lock_kinds:
                recorded = t.lock.of(kind)
                if i >= len(recorded):
                    raise ValueError(f"{kind} call {i}: the locked step made {len(recorded)}")
                ref = recorded[i]
                a = list(a)
                for j, x in zip(INPUTS[kind], ref["ins"]):
                    a[j] = _lock(x, a[j])
            if kind == "noise" and ref is not None and t.draw is not None and i not in t.draw:
                # inject(key, w, eta, w_min, w_max): its gradient goes to clip(w)
                own, out = None, noise.clip_ste(a[1], a[3], a[4])
            else:
                own = out = fn(*a, **k)
            t.calls.append({"kind": kind, "meta": meta(*a, **k) if meta else None,
                            "ins": [t.keep(a[j]) for j in INPUTS[kind]],
                            "out": None if own is None else t.keep(own)})
            return out if ref is None else _lock(ref["out"], out)
        return call

    def mask(*a, **k):
        m = orig["mask"](*a, **k)
        t.masks.append(hashlib.sha256(m.cpu().numpy().tobytes()).hexdigest())
        return m

    engine.execute_mvm = wrapped("mvm", orig["mvm"], _mvm_meta)
    engine.execute_digital = wrapped("digital", orig["digital"])
    ops.flash_attention_ste = wrapped("attention", orig["attention"])
    noise.inject = wrapped("noise", orig["noise"])
    prng.bernoulli = mask
    try:
        yield t
    finally:
        engine.execute_mvm, engine.execute_digital = orig["mvm"], orig["digital"]
        ops.flash_attention_ste, noise.inject = orig["attention"], orig["noise"]
        prng.bernoulli = orig["mask"]


def rel_l2(got: Tensor, want: Tensor) -> float:
    """``|got - want| / |want|`` (L2, in f32)."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))


RANGE_LEAVES = ("r_adc", "gain_s", "w_clip_buf")

#: the bound on each gradient leaf, rel L2 between a step on the card and
#: the CPU's step locked to it, by activation dtype and leaf kind
#: (:func:`leaf_kind`). Set from readings (``chip_smoke.py
#: --lm-step-readings 0,1,2,3,4``; tinyllama-1.1b at full width on 2
#: layers, 64 tokens, H100 80GB HBM3 at 700 W): the largest weight leaf
#: read 3.1e-3 (fp32) and 8.8e-3 (bf16), the largest range leaf 0.123
#: (fp32, seed 0's wq ``r_adc``: the two devices' fp32 partial sums round
#: a few ADC codes of the backward's recompute apart, and this leaf's
#: terms cancel; the other seeds 1.1e-3 at most) and 0.087 (bf16); a
#: zeroed or doubled leaf reads 1, so the bound sits 2x above the largest
#: reading and 4x below those faults (a range leaf scaled by 1.1 passes).
GRAD_RTOL = {"float32": {"weight": 1e-2, "range": 0.25},
             "bfloat16": {"weight": 2e-2, "range": 0.25}}


def leaf_kind(name: str) -> str:
    """'range' for a quantizer-range leaf (the last part of its path in
    ``RANGE_LEAVES``), else 'weight'."""
    return "range" if name.rsplit("/", 1)[-1] in RANGE_LEAVES else "weight"


def over_bound(grads: dict, want: dict, bound: dict) -> dict:
    """The leaves whose rel L2 from ``want`` exceeds ``bound[leaf_kind]``:
    {name: (rel, bound)}."""
    out = {}
    for name, w in want.items():
        rel, b = rel_l2(grads[name], w), bound[leaf_kind(name)]
        if not rel <= b:
            out[name] = (rel, b)
    return out


def planted_faults(grads: dict, want: dict, bound: dict) -> dict:
    """:func:`over_bound` of ``grads`` with one leaf at a time zeroed,
    doubled or scaled by 1.1: for each fault, the leaves it is NOT caught
    on (a gate that can fail a wrong leaf leaves these empty, the 1.1 scale
    apart where the bound is above 0.1)."""
    missed = {}
    for fault, scale in (("zeroed", 0.0), ("doubled", 2.0), ("scaled by 1.1", 1.1)):
        missed[fault] = [name for name in want
                         if name not in over_bound({**grads, name: grads[name] * scale},
                                                   {name: want[name]}, bound)
                         and want[name].norm() > 0]
    return missed
