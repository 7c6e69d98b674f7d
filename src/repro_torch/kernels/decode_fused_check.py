"""The fused decode kernel held to its plain version phase by phase, on the
kernel's own inputs.

End to end, the kernel and ``decode_fused_ref`` drift apart: one ADC or
DAC code flip in an early MVM moves every later activation a little, and
the next layers' codes flip in turn. So an end-to-end bound either hides a
fault or is not met. :func:`check_phases` instead ends the kernel after
each MVM phase of each layer (``FusedDecoder._launch(..., phases=n)``),
reads its workspace -- the residual stream, the DAC-quantized inputs of the
phase's projections, their quantized tile partials -- and the K/V rows it
wrote, and recomputes each phase from what the kernel itself had as input,
with the per-layer decode's own ops -- on a card its row kernels
(``kernels.decode_rows``: norm, RoPE, attention, gate, B2's per-element
code) and its DAC -- and, since those kernels share B2's device code
(``csrc/decode_rows_core.cuh``), also with the plain torch ops
(``rmsnorm_apply``, ``rope``, ``decode_attention``, ``silu * g``):

* ``residual`` (the adds after wo and w2, the embedded tokens at layer 0)
  and ``v_row`` (the written V row): bitwise, the same IEEE operations;
* ``k_row`` (the written K row, RoPE of the wk output): bitwise;
  ``k_row_plain``: within two ulps of the activation dtype at the
  magnitude of the rotated pair of ``models.common.rope`` (the device's
  cos/sin against torch's);
* ``dac`` (the norm before wq/wk/wv, w1/w3 and the lm_head, the attention
  output before wo, the gate before w2): every DAC code bitwise;
  ``dac_plain``: against the DAC of the plain ops' values,
  ``tests/test_kernels.py``'s model at one tile -- every value within 1.01
  DAC steps plus one ulp, fewer than 1% more than half a step off;
* ``mvm_<projection>``, for a projection that runs the tensor-core item
  (``FusedDecoder.items``): bitwise B1's decode design
  (``analog_mvm._launch("decode", ...)``, :func:`b1_decode`) on the
  kernel's own DAC codes and the same r_adc, out_scale, bits and tiles --
  the two run the same instructions per element
  (``csrc/analog_mvm_tc_core.cuh``);
* ``mvm_<projection>``, for a CUDA-core item: the model above for the MVM
  given the kernel's DAC codes -- within 1.01 x n_tiles ADC steps (times
  |out_scale|) plus one ulp, fewer than 1% more than half a step off; as
  phase 3 of ``chip_smoke.py`` holds the per-layer kernel;
* ``logits``: bitwise the lm_head phase's output.

It needs a card (the kernel has no CPU mode).
"""

from __future__ import annotations

import types

import torch

from repro_torch.core import engine
from repro_torch.core.quant import dac_quantize, dac_range
from repro_torch.kernels import decode_rows
from repro_torch.kernels.decode_fused import PHASES_PER_LAYER, FusedDecoder
from repro_torch.models.attention import KVCache, decode_attention
from repro_torch.models.common import embedding_apply, rmsnorm_apply, rope

Tensor = torch.Tensor

WQ, WK, WV, WO, W1, W3, W2, HEAD = range(8)
NAMES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2", "lm_head")


def ulp(v: Tensor, dtype) -> Tensor:
    """One ulp of |v| in ``dtype`` (bf16 or f32), elementwise."""
    bits = 7 if dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(v.abs().float().clamp(min=1e-30))) - bits)


def adc_model(got: Tensor, want: Tensor, step, tiles: int, dtype) -> dict:
    """``tests/test_kernels.py``'s model: every value within 1.01 x tiles
    steps plus one ulp, fewer than 1% more than half a step plus one ulp
    off."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    u = ulp(w, dtype)
    share = float((d > 0.5 * step + u).float().mean())
    ok = bool((d <= 1.01 * tiles * step + u).all()) and share < 0.01
    return {"max_steps": float((d / step).max()), "share_over_half_step": share,
            "differing": int((d > 0).sum()), "values": d.numel(),
            "ok": ok and bool(g.isfinite().all())}


def b1_decode(x_q: Tensor, w: Tensor, r_adc: Tensor, out_scale: Tensor, pplan) -> Tensor:
    """B1's decode design (``csrc/analog_mvm_tc.cu``) on these operands,
    through the checks-only ``analog_mvm._launch``: what a tensor-core MVM
    item of the fused kernel must equal bit for bit."""
    from repro_torch.kernels import analog_mvm

    return analog_mvm._launch("decode", x_q, w, r_adc=r_adc, out_scale=out_scale,
                              b_adc=pplan.spec.b_adc, tile_rows=pplan.tile_rows,
                              per_tile_adc=pplan.per_tile_adc)


def exact(got: Tensor, want: Tensor) -> dict:
    n = int((got != want).sum())
    return {"differing": n, "values": got.numel(), "ok": n == 0}


class _Phases:
    """The kernel's workspace after a given phase, and the plain ops that
    recompute each phase from it."""

    def __init__(self, dec: FusedDecoder, h0: Tensor, cache: KVCache):
        self.dec, self.h0, self.cache = dec, h0, cache
        self.b, self.dtype = dec.n_slots, dec.cfg.dtype
        self.gain_s = dec.tab[dec.plan.n_groups, 1, 0]

    def run(self, phases: int):
        """Launch to the end of ``phases`` phases on a copy of the cache."""
        dec, c = self.dec, self.cache
        kc, vc = c.k.clone(), c.v.clone()
        logits, lens_out = dec._launch(self.h0, KVCache(kc, vc, c.length), dec.grid, phases)
        return types.SimpleNamespace(
            x=dec.x.clone(), x1=dec.x1.clone(), xq=dec.xq.clone(),
            part=dec.part.clone(), kc=kc, vc=vc, logits=logits, lens_out=lens_out,
        )

    def plan(self, p: int):
        return self.dec.plan.head_plan if p == HEAD else self.dec.plan.proj_plans[p]

    def scalars(self, l: int, p: int) -> Tensor:
        """[r_adc, w_max, out_scale] of projection p at layer l."""
        return self.dec.tab[self.dec.plan.n_groups, 0] if p == HEAD else self.dec.tab[l, p]

    def tiles(self, p: int) -> int:
        pp = self.plan(p)
        span = pp.tile_rows if pp.per_tile_adc and pp.k > pp.tile_rows else pp.k
        return -(-pp.k // span)

    def xq(self, snap, slot: int, p: int) -> Tensor:
        k = self.plan(p).k
        return snap.xq[slot, : self.b * k].view(self.b, k)

    def combine(self, snap, region: int, l: int, p: int) -> Tensor:
        """The kernel's output of projection p: its quantized tile partials
        summed in tile order, times out_scale, rounded to the dtype."""
        n, t = self.plan(p).n, self.tiles(p)
        pr = snap.part[region, : t * self.b * n].view(t, self.b, n)
        y = pr[0]
        for i in range(1, t):
            y = y + pr[i]
        return (y * self.scalars(l, p)[2]).to(self.dtype)

    def dac(self, snap, slot: int, h: Tensor, l: int, p: int, *, plain=False) -> dict:
        """The kernel's DAC codes of projection p against the DAC of h:
        bitwise for the per-layer decode's h, under the ADC model at one
        tile for the plain ops' h."""
        s, spec = self.scalars(l, p), self.plan(p).spec
        want = dac_quantize(h, s[0], self.gain_s, s[1], spec).to(self.dtype)
        got, want = self.xq(snap, slot, p), want.reshape(self.b, -1)
        if not plain:
            return exact(got, want)
        step = float((dac_range(s[0], self.gain_s, s[1]).abs() + 1e-9)
                     / (2 ** (spec.b_dac - 1) - 1))
        return adc_model(got, want, step, 1, self.dtype)

    def mvm(self, snap, slot: int, l: int, p: int) -> tuple[dict, Tensor]:
        """Projection p on the kernel's own DAC codes, against its partials:
        bitwise B1's decode design for a tensor-core item, the tolerance
        model for a CUDA-core one."""
        pp, s = self.plan(p), self.scalars(l, p)
        w = self.dec.w_head if p == HEAD else self.dec.stacks[p][l]
        got = self.combine(snap, slot, l, p)
        if self.dec.items[p] == "tensor_core":
            return exact(got, b1_decode(self.xq(snap, slot, p), w, s[0], s[2], pp)), got
        want = engine.tile_matmul_quant(self.xq(snap, slot, p), w, s[0], pp.spec,
                                        pp.tile_rows, pp.per_tile_adc, s[2]).to(self.dtype)
        step = (abs(float(s[0])) + 1e-9) / (2 ** (pp.spec.b_adc - 1) - 1) * abs(float(s[2]))
        return adc_model(got, want, step, self.tiles(p), self.dtype), got


def check_phases(dec: FusedDecoder, tok: Tensor, cache: KVCache) -> dict:
    """Run the checks of the module docstring on every layer of one decode
    step of ``dec`` from ``tok`` (B, 1) and ``cache`` (left unchanged).

    Returns ``{"ok", "failures": [(layer, check), ...], "checks": {check:
    worst reading over the layers}}``; a reading's ``layer`` is where its
    worst value sat, ``layer`` L is the final norm and the lm_head.
    """
    cfg = dec.cfg
    b, d, f, dtype = dec.n_slots, cfg.d_model, cfg.d_ff, cfg.dtype
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_layers = dec.plan.n_groups
    h0 = embedding_apply(dec.params.embed, tok.long(), dtype).reshape(b, d).contiguous()
    ph = _Phases(dec, h0, cache)
    lens = cache.length
    pos = lens.long()[:, None]
    rows = torch.arange(b, device=lens.device)
    idx = lens.clamp(max=dec.s_max - 1).long()
    readings: dict[str, list] = {}

    def add(name: str, layer: int, r: dict) -> None:
        readings.setdefault(name, []).append(dict(r, layer=layer))

    def dacs(snap, h, h_plain, l, projs):
        for slot, p in enumerate(projs):
            add("dac", l, ph.dac(snap, slot, h, l, p))
            add("dac_plain", l, ph.dac(snap, slot, h_plain, l, p, plain=True))

    def norm_dac(snap, x, scale, l, projs):
        dacs(snap, decode_rows.norm(x, scale, cfg.norm_eps),
             rmsnorm_apply({"scale": scale}, x, cfg.norm_eps), l, projs)

    def mvms(snap, l, projs):
        outs = []
        for slot, p in enumerate(projs):
            r, y = ph.mvm(snap, slot, l, p)
            add(f"mvm_{NAMES[p]}", l, r)
            outs.append(y)
        return outs

    x1 = y_w2 = None
    for l in range(n_layers):
        base = PHASES_PER_LAYER * l
        a = ph.run(base + 2)  # norm + DAC, then the wq/wk/wv MVM
        want = h0 if l == 0 else (x1.float() + y_w2.float()).to(dtype)
        add("residual", l, exact(a.x, want))
        norm_dac(a, a.x, dec.n1[l], l, (WQ, WK, WV))
        q, k, v = mvms(a, l, (WQ, WK, WV))
        s = ph.run(base + 4)  # attention, then the wo MVM
        q_rot, k_rot = decode_rows.rope(q.view(b, 1, nh, hd), k.view(b, 1, nkv, hd), lens,
                                        cfg.rope_theta)
        add("k_row", l, exact(s.kc[l][rows, idx], k_rot[:, 0]))
        k4 = k.view(b, 1, nkv, hd)
        mag = k4[:, 0].float().abs()
        mag = (mag[..., : hd // 2] + mag[..., hd // 2:]).repeat(1, 1, 2)
        dk = (s.kc[l][rows, idx].float() - rope(k4, pos, cfg.rope_theta)[:, 0].float()).abs()
        add("k_row_plain", l, {"differing": int((dk > 0).sum()), "values": dk.numel(),
                               "ok": bool((dk <= 2 * ulp(mag, dtype)).all())})
        add("v_row", l, exact(s.vc[l][rows, idx], v.view(b, nkv, hd)))
        att = decode_rows.attention(q_rot, s.kc[l], s.vc[l], lens + 1)
        att_plain = decode_attention(rope(q.view(b, 1, nh, hd), pos, cfg.rope_theta),
                                     KVCache(s.kc[l], s.vc[l], lens + 1))
        dacs(s, att.reshape(b, nh * hd), att_plain.reshape(b, nh * hd), l, (WO,))
        (y_wo,) = mvms(s, l, (WO,))
        c = ph.run(base + 6)  # norm + DAC, then the w1/w3 MVM
        add("residual", l, exact(c.x1, (a.x.float() + y_wo.float()).to(dtype)))
        norm_dac(c, c.x1, dec.n2[l], l, (W1, W3))
        u, g = mvms(c, l, (W1, W3))
        e = ph.run(base + 8)  # the gate, then the w2 MVM
        dacs(e, decode_rows.gate(u, g).reshape(b, f),
             (torch.nn.functional.silu(u) * g).reshape(b, f), l, (W2,))
        (y_w2,) = mvms(e, l, (W2,))
        x1 = c.x1
        del a, s, c, e
    fin = ph.run(PHASES_PER_LAYER * n_layers + 2)  # final norm + DAC, lm_head
    want = h0 if n_layers == 0 else (x1.float() + y_w2.float()).to(dtype)
    add("residual", n_layers, exact(fin.x, want))
    norm_dac(fin, fin.x, dec.fin, n_layers, (HEAD,))
    (y_head,) = mvms(fin, n_layers, (HEAD,))
    whole = ph.run(0)
    add("logits", n_layers, exact(whole.logits, y_head))
    add("lengths", n_layers, exact(whole.lens_out, lens + 1))

    failures = [(r["layer"], name) for name, rs in readings.items() for r in rs if not r["ok"]]
    checks = {}
    for name, rs in readings.items():
        c = {"n": len(rs), "ok": all(r["ok"] for r in rs),
             "differing": sum(r["differing"] for r in rs),
             "values": sum(r["values"] for r in rs)}
        if "max_steps" in rs[0]:
            worst = max(rs, key=lambda r: r["max_steps"])
            c.update(max_steps=worst["max_steps"], layer=worst["layer"],
                     share_over_half_step=max(r["share_over_half_step"] for r in rs))
        checks[name] = c
    return {"ok": not failures, "failures": failures, "checks": checks}
