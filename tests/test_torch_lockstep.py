"""``training.lockstep``: one training step held at another run's forward
values, on the CPU at tinyllama-1.1b's smoke config.

* a step locked to its own record is bitwise the recorded step: loss,
  every gradient leaf, every call's own output, every mask digest -- with
  the weight-noise draws computed, or taken from the record;
* a locked step passes the recorded values on: the lm_head's recorded
  output (the logits) changed moves the locked step's loss, while that
  call's own output, computed from the recorded inputs, stays the
  unchanged one;
* the gradient gate (``over_bound``) fails a zeroed, doubled or scaled
  leaf, and ``planted_faults`` says which faults a bound lets through.
"""

import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.configs import get_smoke
from repro_torch.core.analog import AnalogConfig
from repro_torch.data.pipeline import PipelineConfig, batch_at
from repro_torch.models import lm
from repro_torch.training import lockstep
from repro_torch.training.loop import value_and_grad

CFG = get_smoke("tinyllama-1.1b")


def _step(params, cfg, stage, tape):
    b = batch_at(PipelineConfig(kind="lm", global_batch=2, seq_len=16, vocab=cfg.vocab), 0)
    batch = {k: torch.as_tensor(v) for k, v in b.items()}
    acfg = AnalogConfig() if stage == 1 else AnalogConfig().train(eta=0.1, b_adc=8,
                                                                   quant_noise_p=0.5)
    key = prng.fold_in(prng.PRNGKey(0), 3) if stage == 2 else None
    with lockstep.tape(tape):
        (loss, _), grads = value_and_grad(
            lambda p: lm.lm_loss(p, batch, acfg, cfg, rng=key), params)
    return float(loss), {tree_lib.path_name(p): g for p, g in tree_lib.flatten_with_path(grads)}


@pytest.fixture(scope="module")
def params():
    return lm.lm_init(prng.PRNGKey(0), CFG, device="cpu")


@pytest.mark.parametrize("draw", [None, set()], ids=["drawn", "taken"])
@pytest.mark.parametrize("stage", [1, 2])
def test_locked_to_itself_is_bitwise(params, stage, draw):
    rec = lockstep.Tape()
    loss, grads = _step(params, CFG, stage, rec)
    kinds = {c["kind"] for c in rec.calls}
    assert kinds == ({"digital", "attention"} if stage == 1 else {"mvm", "attention", "noise"})
    assert len(rec.masks) == (0 if stage == 1 else 2 * (7 * CFG.n_layers + 1))
    locked = lockstep.Tape(lock=rec, draw=draw)
    loss2, grads2 = _step(params, CFG, stage, locked)
    assert loss2 == loss and locked.masks == rec.masks
    assert all(torch.equal(grads2[n], g) for n, g in grads.items())
    for a, b in zip(rec.calls, locked.calls):
        assert a["kind"] == b["kind"]
        if b["out"] is None:  # a draw taken from the record
            assert a["kind"] == "noise" and draw == set()
        else:
            assert torch.equal(a["out"], b["out"])


def test_locked_step_passes_the_recorded_values_on(params):
    rec = lockstep.Tape()
    loss, _ = _step(params, CFG, 2, rec)
    head = rec.of("mvm")[-1]  # the lm_head: its output is the logits
    original = head["out"].clone()
    head["out"] = original * 2
    locked = lockstep.Tape(lock=rec, draw=set())
    loss2, _ = _step(params, CFG, 2, locked)
    assert loss2 != loss
    assert torch.equal(locked.of("mvm")[-1]["out"], original)
    assert all(torch.equal(a["ins"][0], b["ins"][0])
               for a, b in zip(rec.of("mvm"), locked.of("mvm")))


def test_a_locked_step_must_make_the_recorded_calls(params):
    rec = lockstep.Tape()
    _step(params, CFG, 1, rec)  # digital: no analog MVM, no draw
    with pytest.raises(ValueError, match="noise call 0: the locked step made 0"):
        _step(params, CFG, 2, lockstep.Tape(lock=rec))


def test_gradient_gate_and_planted_faults():
    g = torch.Generator().manual_seed(0)
    want = {"blocks/0/attn/wq/w": torch.randn(64, 32, generator=g),
            "blocks/0/attn/wq/r_adc": torch.randn(2, generator=g), "gain_s": torch.zeros(())}
    grads = {n: w + 1e-3 * w.abs().max() * torch.randn(w.shape, generator=g)
             for n, w in want.items()}
    tight = {"weight": 1e-2, "range": 1e-2}
    assert lockstep.leaf_kind("blocks/0/attn/wq/r_adc") == "range"
    assert lockstep.leaf_kind("gain_s") == "range"
    assert lockstep.leaf_kind("blocks/0/attn/wq/w") == "weight"
    assert lockstep.over_bound(grads, want, tight) == {}
    for scale in (0.0, 2.0, 1.1):
        bad = {**grads, "blocks/0/attn/wq/r_adc": grads["blocks/0/attn/wq/r_adc"] * scale}
        assert list(lockstep.over_bound(bad, want, tight)) == ["blocks/0/attn/wq/r_adc"]
    nan = {**grads, "blocks/0/attn/wq/w": grads["blocks/0/attn/wq/w"] * float("nan")}
    assert list(lockstep.over_bound(nan, want, tight)) == ["blocks/0/attn/wq/w"]
    # gain_s's gradient is zero: no fault can be planted on it
    assert lockstep.planted_faults(grads, want, tight) == {
        "zeroed": [], "doubled": [], "scaled by 1.1": []}
    assert lockstep.planted_faults(grads, want, {"weight": 1e-2, "range": 0.5}) == {
        "zeroed": [], "doubled": [], "scaled by 1.1": ["blocks/0/attn/wq/r_adc"]}
