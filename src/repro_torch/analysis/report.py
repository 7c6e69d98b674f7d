"""Tables of the dry run's JSONL results (``launch.dryrun``), port of
``repro.analysis.report``; every time is computed from shapes at an NVIDIA
H100 SXM's published peaks (``analysis.roofline``), not measured.

    PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun.jsonl
"""

from __future__ import annotations

import json
import sys
from collections import OrderedDict

from repro_torch.analysis.roofline import CARD

ARCH_ORDER = [
    "mamba2-2.7b", "recurrentgemma-9b", "llama3.2-3b", "tinyllama-1.1b",
    "olmo-1b", "qwen2-72b", "musicgen-large", "llama4-maverick-400b-a17b",
    "phi3.5-moe-42b-a6.6b", "paligemma-3b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: one card's memory (bytes): what "fits" is held against
CARD_BYTES = 80 * 10**9


def load(path: str) -> dict:
    """Latest record per (arch, shape, mesh, mode)."""
    recs: dict = OrderedDict()
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            key = (r.get("arch"), r.get("shape"), r.get("mesh", "-"),
                   r.get("mode", "digital"))
            recs[key] = r
    return recs


def fmt_t(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def fits(r: dict) -> bool:
    """The rank's peak (``memory.total_nonaliased_gib``) within one card."""
    return r["memory"]["total_nonaliased_gib"] * 2**30 <= CARD_BYTES


def dryrun_table(recs: dict, mesh: str, mode: str = "digital") -> list[str]:
    lines = [
        f"| arch | shape | status | GiB/rank | fits 80 GB | trace | TF/rank | bottleneck"
        f" | t_step ({CARD}, computed) | collectives |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, mesh, mode)) or recs.get(
                (arch, shape, "-", mode))
            if r is None:
                continue
            if r["status"] == "skip":
                lines.append(
                    f"| {arch} | {shape} | SKIP(full-attn) | - | - | - | - | - | - | - |")
                continue
            if r["status"] != "ok":
                lines.append(
                    f"| {arch} | {shape} | **FAIL** | - | - | - | - | - | - | "
                    f"{r.get('error', '')[:60]} |")
                continue
            m = r["memory"]["total_nonaliased_gib"]
            rf = r["roofline"]
            coll = ", ".join(f"{k}:{v}" for k, v in sorted(rf["collectives"].items()))
            lines.append(
                f"| {arch} | {shape} | ok | {m:.2f} | {'yes' if fits(r) else 'no'}"
                f" | {r['t_trace_s']:.0f}s | {rf['hlo_flops_per_dev']/1e12:.2f}"
                f" | {rf['bottleneck']} | {fmt_t(rf['t_step_s'])} | {coll[:70]} |")
    return lines


def roofline_table(recs: dict, mesh: str = "16x16", mode: str = "digital") -> list[str]:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck |"
        " useful FLOPs | roofline frac | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    hints = {
        ("memory", "train"): "fewer/smaller materialized intermediates (B3's plain VJP, remat policy, chunk size)",
        ("memory", "prefill"): "larger attention chunks / fused kernels",
        ("memory", "decode"): "KV-cache dtype; quantized cache",
        ("collective", "train"): "reduce-scatter instead of all-gather + rank-order sum; overlap with compute",
        ("collective", "prefill"): "resharding removal between attention and MLP",
        ("collective", "decode"): "weight replication; fewer per-layer gathers",
        ("compute", "train"): "less remat recompute; padding waste from head sharding",
        ("compute", "prefill"): "causal-block skip in chunked attention (2x)",
        ("compute", "decode"): "already tiny; latency-bound",
    }
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, mesh, mode))
            if r is None or r["status"] != "ok":
                continue
            rf = r["roofline"]
            kind = ("train" if shape.startswith("train") else
                    "prefill" if shape.startswith("prefill") else "decode")
            hint = hints.get((rf["bottleneck"], kind), "-")
            lines.append(
                f"| {arch} | {shape} | {fmt_t(rf['t_compute_s'])} |"
                f" {fmt_t(rf['t_memory_s'])} | {fmt_t(rf['t_collective_s'])} |"
                f" {rf['bottleneck']} | {rf['useful_flops_frac']:.2f} |"
                f" {rf['roofline_fraction']:.3f} | {hint} |")
    return lines


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.jsonl"
    recs = load(path)
    meshes = sorted({k[2] for k in recs if k[2] != "-"}, key=lambda m: (-len(m), m))
    for mesh in meshes:
        print(f"### {mesh} ({CARD}; times computed from shapes)\n")
        print("\n".join(dryrun_table(recs, mesh)))
        print()
    print(f"### Roofline (16x16; {CARD}; computed from shapes)\n")
    print("\n".join(roofline_table(recs)))


if __name__ == "__main__":
    main()
