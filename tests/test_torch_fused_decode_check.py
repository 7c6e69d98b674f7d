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
"""

import dataclasses

import numpy as np
import pytest
import torch

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


class Emulated:
    """``FusedDecoder._launch`` on the CPU: the kernel's phases, in its
    order and workspace layout; ``fault`` = (layer, projection, delta)
    adds ``delta`` to one output of that MVM's first tile partial."""

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
            x = ph.xq(dec, slot, p).float()
            t = ph.tiles(p)
            span = pp.tile_rows if t > 1 else pp.k
            parts = []
            for i in range(t):
                y = fake_quant(x[:, i * span:(i + 1) * span] @ w[i * span:(i + 1) * span].float(),
                               s[0], pp.spec.b_adc)
                parts.append(y.to(dec.cfg.dtype).float() if t > 1 else y)
            part = torch.stack(parts)
            if self.fault is not None and self.fault[:2] == (l, p):
                part[0, 0, 0] += self.fault[2]
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


def _decoder(dtype, seed=0):
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=dtype, n_layers=N_LAYERS)
    gen = torch.Generator().manual_seed(seed)
    params = lm.lm_init(gen, cfg, device="cpu")
    program = engine.compile_program(
        params, AnalogConfig(tile_rows=32).infer(b_adc=6),
        torch.Generator().manual_seed(seed + 1), device="cpu",
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
    assert c["dac"]["n"] == 7 * N_LAYERS + 1
    for name in chk.NAMES:
        assert c[f"mvm_{name}"]["n"] == (1 if name == "lm_head" else N_LAYERS)
    assert c["k_row"]["n"] == c["v_row"]["n"] == N_LAYERS
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
