#!/usr/bin/env python3
"""Accuracy of the bf16 prefill-attention kernel (B3) over seeds and
settings of its two recompute windows, on one NVIDIA card.

    python3 tools/b3_accuracy.py [--seeds 1 2 3] [--windows 32:0.000244140625 0:0.000244140625]
                                 [--src SRC]

For each window setting ``P:MAX`` the kernel is built from
``src/repro_torch/csrc/flash_attention.cu`` with ``-DFA_P_WINDOW=P
-DFA_MAX_WINDOW=MAX`` (the p window in fp32 units of the last place around
a bf16 rounding midpoint, and the chunk-max window; the first setting
given is the shipped one) and held against ``flash_attention_ref`` at
``chip_smoke.py`` phase 8's shapes (tinyllama-1.1b heads; the served
(rows, S) shapes and the 2048-token context), causal and full, on inputs
drawn from each seed. Per setting and seed it prints one JSON line: the
cases, the cases over the bound (at most one output ulp, near zero ulp(|o|)
+ 1e-5 max |o|, under 1% of outputs differing), the worst ulps, the outputs
over one ulp and the worst share differing.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (for
example an older commit unpacked beside this one) and reports its kernel
as it is built there, with no window flags. Nothing is written outside
the build directory of the checkout it imports from.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: chip_smoke.py phase 8's (rows, S): the served shapes and the context
SHAPES = [(1, 16), (1, 32), (4, 32), (1, 64), (2, 64), (1, 128), (1, 256), (1, 2048)]
HEADS = dict(h=32, kv=4, d=64)
CHUNKS = dict(q_chunk=512, kv_chunk=1024)


def measure(torch, fa, ref, seed: int) -> dict:
    gen = torch.Generator("cuda").manual_seed(seed)
    worst_ulps, over_one, over_bound, worst_diff, cases = 0.0, 0, 0, 0.0, 0
    for rows, s in SHAPES:
        q, k, v = (torch.randn((rows, s, n, HEADS["d"]), generator=gen, device="cuda")
                   .bfloat16() for n in (HEADS["h"], HEADS["kv"], HEADS["kv"]))
        for causal in (True, False):
            o_k = fa.flash_attention(q, k, v, causal=causal, **CHUNKS).float()
            o_p = ref(q, k, v, causal, **CHUNKS).float()
            d = (o_k - o_p).abs()
            ulp = torch.exp2(torch.floor(torch.log2(o_p.abs().clamp(min=1e-30))) - 7)
            scale = o_p.abs().max()
            differing = float((d > 0).float().mean())
            ok = bool((d <= ulp + 1e-5 * scale).all()) and differing < 0.01
            cases += 1
            over_bound += not ok
            worst_ulps = max(worst_ulps, float((d / ulp).max()))
            over_one += int((d > ulp).sum())
            worst_diff = max(worst_diff, differing)
    return {"seed": seed, "cases": cases, "cases_over_bound": over_bound,
            "worst_ulps": worst_ulps, "outputs_over_one_ulp": over_one,
            "worst_share_differing": worst_diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--windows", nargs="+", default=["32:0.000244140625"],
                    help="P:MAX settings of FA_P_WINDOW and FA_MAX_WINDOW")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory to import repro_torch from")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("b3_accuracy: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    other = args.src.resolve() != (ROOT / "src").resolve()
    base = build.NVCC_FLAGS
    for setting in ([None] if other else args.windows):
        if setting is not None:
            p, mx = setting.split(":")
            build.NVCC_FLAGS = base + (f"-DFA_P_WINDOW={int(p)}", f"-DFA_MAX_WINDOW={float(mx)!r}f")
        build._LOADED.pop("flash_attention", None)
        fa._FN = None
        for seed in args.seeds:
            r = measure(torch, fa, flash_attention_ref, seed)
            r["kernel"] = str(args.src) if other else f"p_window={p} max_window={mx}"
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
