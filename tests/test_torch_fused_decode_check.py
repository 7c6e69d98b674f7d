"""The per-phase check of the fused decode kernel (``kernels.decode_fused_check``)
on the CPU.

The kernel itself runs only on a card; here ``FusedDecoder._launch`` is
replaced by an emulation that writes the kernel's workspace phase by phase
as ``csrc/decode_fused.cu`` lays it out (residual stream, DAC-quantized
inputs in xq slots, quantized tile partials as (tile, B, N) regions, K/V
rows in the stacked cache), from the port's plain ops. The check must pass
on it at every layer, and must name the layer and the check of a fault
placed at layer 2 or later -- the depth where the end-to-end comparison
alone cannot tell a fault from the drift of ADC code flips.

A projection that runs the tensor-core item is held bitwise to B1's decode
design (``decode_fused_check.b1_decode``, a card only); here that is the
same plain tile partials the emulation writes (``_b1_emulated``), so a
fault of one output ulp in such an item -- which the tolerance model of
the CUDA-core items would pass -- must be named at its layer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_smoke
from repro_torch.core import engine
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.quant import fake_quant
from repro_torch.kernels import decode_fused as df
from repro_torch.kernels import decode_fused_check as chk
from repro_torch.models import lm
from repro_torch.models.attention import KVCache, decode_attention
from repro_torch.models.common import rmsnorm_apply, rope

N_LAYERS = 3


def _tile_partials(x_q, w, r_adc, pplan, tiles, dtype):
    """(tiles, M, N) quantized tile partials, as the kernel's items write
    them: the ADC per crossbar tile, rounded to the dtype over several."""
    x = x_q.float()
    span = pplan.tile_rows if tiles > 1 else pplan.k
    parts = []
    for i in range(tiles):
        y = fake_quant(x[:, i * span:(i + 1) * span] @ w[i * span:(i + 1) * span].float(),
                       r_adc, pplan.spec.b_adc)
        parts.append(y.to(dtype).float() if tiles > 1 else y)
    return torch.stack(parts)


def _sum_tiles(part, out_scale, dtype):
    y = part[0]
    for i in range(1, len(part)):
        y = y + part[i]
    return (y * out_scale).to(dtype)


def _b1_emulated(x_q, w, r_adc, out_scale, pplan):
    """Stand-in of B1's decode design on the CPU: the emulated kernel's own
    partials, summed as ``combine`` sums them."""
    span = pplan.tile_rows if pplan.per_tile_adc and pplan.k > pplan.tile_rows else pplan.k
    tiles = -(-pplan.k // span)
    return _sum_tiles(_tile_partials(x_q, w, r_adc, pplan, tiles, x_q.dtype), out_scale,
                      x_q.dtype)


def _one_ulp(part, out_scale, dtype) -> float:
    """The change of part[0, 0, 0] that moves output [0, 0] to the next
    value of ``dtype`` away from zero: a fault of one output ulp."""
    out = _sum_tiles(part[:, :1, :1], out_scale, dtype)
    up = (out.view(torch.int16) + 1).view(dtype).float()
    y = float(part[:, 0, 0].sum())
    return (float(up) - y * float(out_scale)) / float(out_scale)


class Emulated:
    """``FusedDecoder._launch`` on the CPU: the kernel's phases, in its
    order and workspace layout; ``fault`` = (layer, projection, delta)
    adds ``delta`` to one output of that MVM's first tile partial
    (``"ulp"``: the delta that moves that output by one ulp)."""

    def __init__(self, dec, fault=None):
        cfg, b = dec.cfg, dec.n_slots
        self.dec, self.fault = dec, fault
        self.ph = chk._Phases(dec, None, None)
        stride = max(self.ph.tiles(p) * b * self.ph.plan(p).n for p in range(8))
        dec.x = torch.empty((b, cfg.d_model), dtype=cfg.dtype)
        dec.x1 = torch.empty_like(dec.x)
        dec.xq = torch.zeros((3, b * max(cfg.d_model, cfg.d_ff)), dtype=cfg.dtype)
        dec.part = torch.zeros((3, stride), dtype=torch.float32)
        dec.grid = 1

    def dac(self, h, l, p, slot):
        ph = self.ph
        s, spec = ph.scalars(l, p), ph.plan(p).spec
        q = chk.dac_quantize(h, s[0], ph.gain_s, s[1], spec).to(self.dec.cfg.dtype)
        self.dec.xq[slot, : q.numel()] = q.reshape(-1)

    def mvm(self, l, projs):
        dec, ph = self.dec, self.ph
        for slot, p in enumerate(projs):
            pp, s = ph.plan(p), ph.scalars(l, p)
            w = dec.w_head if p == chk.HEAD else dec.stacks[p][l]
            part = _tile_partials(ph.xq(dec, slot, p), w, s[0], pp, ph.tiles(p), dec.cfg.dtype)
            if self.fault is not None and self.fault[:2] == (l, p):
                delta = self.fault[2]
                if delta == "ulp":
                    delta = _one_ulp(part, s[2], dec.cfg.dtype)
                part[0, 0, 0] += delta
            dec.part[slot, : part.numel()] = part.reshape(-1)

    def combine(self, slot, l, p):
        return self.ph.combine(self.dec, slot, l, p)

    def __call__(self, h0, cache, grid, phases=0):
        dec, cfg = self.dec, self.dec.cfg
        b, dtype = dec.n_slots, cfg.dtype
        k_c, v_c, lens = cache
        pos = lens.long()[:, None]
        rows, idx = torch.arange(b), lens.clamp(max=dec.s_max - 1).long()
        steps = []
        for l in range(dec.plan.n_groups):
            steps += [
                lambda l=l: (dec.x.copy_(h0 if l == 0 else (
                    dec.x1.float() + self.combine(0, l - 1, chk.W2).float()).to(dtype)),
                    [self.dac(rmsnorm_apply({"scale": dec.n1[l]}, dec.x, cfg.norm_eps), l, p, j)
                     for j, p in enumerate((chk.WQ, chk.WK, chk.WV))]),
                lambda l=l: self.mvm(l, (chk.WQ, chk.WK, chk.WV)),
                lambda l=l: self.attention(l, k_c, v_c, lens, pos, rows, idx),
                lambda l=l: self.mvm(l, (chk.WO,)),
                lambda l=l: (dec.x1.copy_((dec.x.float() + self.combine(0, l, chk.WO).float()).to(dtype)),
                             [self.dac(rmsnorm_apply({"scale": dec.n2[l]}, dec.x1, cfg.norm_eps), l, p, j)
                              for j, p in enumerate((chk.W1, chk.W3))]),
                lambda l=l: self.mvm(l, (chk.W1, chk.W3)),
                lambda l=l: self.dac(torch.nn.functional.silu(self.combine(0, l, chk.W1))
                                     * self.combine(1, l, chk.W3), l, chk.W2, 0),
                lambda l=l: self.mvm(l, (chk.W2,)),
            ]
        n = dec.plan.n_groups
        steps += [
            lambda: (dec.x.copy_((dec.x1.float() + self.combine(0, n - 1, chk.W2).float()).to(dtype)),
                     self.dac(rmsnorm_apply({"scale": dec.fin}, dec.x, cfg.norm_eps), n, chk.HEAD, 0)),
            lambda: self.mvm(n, (chk.HEAD,)),
        ]
        assert len(steps) == df.PHASES_PER_LAYER * n + 2
        for i, fn in enumerate(steps):
            fn()
            if i + 1 == phases:
                break
        logits = self.combine(0, n, chk.HEAD)
        return logits, lens + 1

    def attention(self, l, k_c, v_c, lens, pos, rows, idx):
        dec, cfg = self.dec, self.dec.cfg
        b, nh, nkv, hd = dec.n_slots, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = rope(self.combine(0, l, chk.WQ).view(b, 1, nh, hd), pos, cfg.rope_theta)
        k = rope(self.combine(1, l, chk.WK).view(b, 1, nkv, hd), pos, cfg.rope_theta)
        k_c[l].index_put_((rows, idx), k[:, 0])
        v_c[l].index_put_((rows, idx), self.combine(2, l, chk.WV).view(b, nkv, hd))
        att = decode_attention(q, KVCache(k_c[l], v_c[l], lens + 1))
        self.dac(att.reshape(b, nh * hd), l, chk.WO, 0)


def _decoder(dtype, seed=0, tile_rows=32):
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=dtype, n_layers=N_LAYERS)
    params = lm.lm_init(prng.PRNGKey(seed), cfg, device="cpu")
    program = engine.compile_program(
        params, AnalogConfig(tile_rows=tile_rows).infer(b_adc=6),
        prng.PRNGKey(seed + 1), device="cpu",
    )
    params = engine.cast_weights(program.params, dtype)
    plan = engine.build_fused_plan(program)
    n_slots, s_max = 3, 16
    cache = df.init_fused_cache(cfg, plan.n_groups, n_slots, s_max, dtype, device="cpu")
    rng = np.random.default_rng(seed)
    for slot, n in enumerate((4, 9, 16)):
        c = lm.init_lm_cache(cfg, 1, s_max, dtype, stacked=False, device="cpu")
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=n))[None].long()
        _, c = lm.lm_forward(params, {"tokens": tok}, program.cfg, cfg, cache=c,
                             last_token_only=True)
        df.write_fused_slot(cache, c, slot)
    dec = df.FusedDecoder(params, plan, cfg, program.cfg, n_slots, s_max)
    cur = torch.as_tensor(rng.integers(0, cfg.vocab, size=(n_slots, 1))).long()
    return dec, cache, cur


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_phase_check_passes_on_the_kernels_phases(dtype, monkeypatch):
    dec, cache, cur = _decoder(dtype)
    monkeypatch.setattr(dec, "_launch", Emulated(dec), raising=False)
    before = cache.k.clone()
    res = chk.check_phases(dec, cur, cache)
    assert res["ok"], res["failures"]
    assert torch.equal(cache.k, before)  # every phase ran on a copy
    c = res["checks"]
    assert c["residual"]["n"] == 2 * N_LAYERS + 1
    assert c["dac"]["n"] == c["dac_plain"]["n"] == 7 * N_LAYERS + 1
    for name in chk.NAMES:
        assert c[f"mvm_{name}"]["n"] == (1 if name == "lm_head" else N_LAYERS)
    assert c["k_row"]["n"] == c["k_row_plain"]["n"] == c["v_row"]["n"] == N_LAYERS
    assert c["logits"]["ok"] and c["lengths"]["ok"]


@pytest.mark.parametrize("layer, proj, check", [
    (2, chk.WK, "mvm_wk"),
    (2, chk.W2, "mvm_w2"),
    (N_LAYERS, chk.HEAD, "mvm_lm_head"),
])
def test_phase_check_names_a_fault_past_layer_one(layer, proj, check, monkeypatch):
    dec, cache, cur = _decoder(torch.float32)
    # one output of that MVM off by n_tiles + 2 ADC steps
    ph = chk._Phases(dec, None, None)
    step = (abs(float(ph.scalars(layer, proj)[0])) + 1e-9) / (
        2 ** (ph.plan(proj).spec.b_adc - 1) - 1)
    fault = (layer, proj, (ph.tiles(proj) + 2) * step)
    monkeypatch.setattr(dec, "_launch", Emulated(dec, fault), raising=False)
    res = chk.check_phases(dec, cur, cache)
    assert not res["ok"]
    assert (layer, check) in res["failures"]
    assert all(l >= layer for l, _ in res["failures"])


def test_a_fault_the_kernel_shares_with_the_row_kernels_is_caught_by_the_plain_ops(
        monkeypatch):
    """B2 and the per-layer decode's row kernels share their device code, so
    a fault there passes the bitwise readings; the plain-op readings catch
    it. Here both compute a norm 5% too large."""
    def faulty(x, scale, eps, norm=rmsnorm_apply):
        return (norm({"scale": scale}, x, eps).float() * 1.05).to(x.dtype)

    dec, cache, cur = _decoder(torch.float32)
    monkeypatch.setitem(globals(), "rmsnorm_apply",
                        lambda p, x, eps: faulty(x, p["scale"], eps))
    monkeypatch.setattr(dec, "_launch", Emulated(dec), raising=False)
    monkeypatch.setattr(chk.decode_rows, "norm", faulty)
    res = chk.check_phases(dec, cur, cache)
    assert not res["ok"]
    assert res["checks"]["dac"]["ok"] and res["checks"]["dac"]["differing"] == 0
    assert not res["checks"]["dac_plain"]["ok"]
    assert (0, "dac_plain") in res["failures"]


def test_tensor_core_items_are_held_bitwise(monkeypatch):
    """bf16 at one crossbar tile: every projection runs the tensor-core item,
    and each MVM reading is the exact comparison, not the model."""
    dec, cache, cur = _decoder(torch.bfloat16, tile_rows=1024)
    assert dec.items == ("tensor_core",) * 8
    monkeypatch.setattr(dec, "_launch", Emulated(dec), raising=False)
    monkeypatch.setattr(chk, "b1_decode", _b1_emulated)
    res = chk.check_phases(dec, cur, cache)
    assert res["ok"], res["failures"]
    for name in chk.NAMES:
        c = res["checks"][f"mvm_{name}"]
        assert "max_steps" not in c and c["differing"] == 0


@pytest.mark.parametrize("layer, proj, check", [
    (2, chk.WK, "mvm_wk"),
    (2, chk.W1, "mvm_w1"),
    (N_LAYERS, chk.HEAD, "mvm_lm_head"),
])
def test_one_ulp_fault_in_a_tensor_core_item_is_named_at_its_layer(layer, proj, check,
                                                                   monkeypatch):
    dec, cache, cur = _decoder(torch.bfloat16, tile_rows=1024)
    monkeypatch.setattr(dec, "_launch", Emulated(dec, (layer, proj, "ulp")), raising=False)
    monkeypatch.setattr(chk, "b1_decode", _b1_emulated)
    res = chk.check_phases(dec, cur, cache)
    assert not res["ok"]
    assert (layer, check) in res["failures"]
    assert all(l >= layer for l, _ in res["failures"])
    assert res["checks"][check]["differing"] >= 1
