#!/usr/bin/env python3
"""Accuracy of the bf16 prefill-attention kernel (B3) over seeds and
settings of its two recompute windows, on one NVIDIA card.

    python3 tools/b3_accuracy.py [--seeds 1 2 3] [--windows 32:0.000244140625 0:0.000244140625]
                                 [--heads tinyllama-1.1b|recurrentgemma-9b|paligemma-3b]
                                 [--chain] [--src SRC]

For each window setting ``P:MAX`` the kernel is built from
``src/repro_torch/csrc/flash_attention.cu`` with ``-DFA_P_WINDOW=P
-DFA_MAX_WINDOW=MAX`` (the p window in fp32 units of the last place around
a bf16 rounding midpoint, and the chunk-max window; the first setting
given is the shipped one; the settings build in parallel) and held against
``flash_attention_ref`` at ``--heads``' cases (``CASES``: tinyllama-1.1b's
are ``chip_smoke.py`` phase 8's served (rows, S) shapes and the 2048-token
context; recurrentgemma-9b's and paligemma-3b's are phase 17's head dim 256
cases), causal and full, on inputs drawn from each seed. Per setting and
seed it prints one JSON line: the cases, the cases over the bound (at most
one output ulp, near zero ulp(|o|) + 1e-5 max |o|, under 1% of outputs
differing), the outputs over that bound, the worst ulps, the outputs over
one ulp and the worst share differing.

``--chain`` also prints, per seed, the share of the plain version's fp32
scores (its einsum over the first (q chunk, kv chunk) block of each case)
that equal the sequential FMA chain over d -- the order the kernel
recomputes a flagged p in (products of bf16 values are exact in fp32, so
``s + q_d * k_d`` rounds once, as an FMA does).

``--src`` imports ``repro_torch`` from another checkout's ``src`` (for
example an older commit unpacked beside this one) and reports its kernel
as it is built there, with no window flags. Nothing is written outside
the build directory of the checkout it imports from.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: heads ({"h", "kv", "d"}) and (rows, S, window) cases of each ``--heads``:
#: tinyllama-1.1b's are chip_smoke.py phase 8's (the served shapes and the
#: context), the others phase 17's at head dim 256
CASES = {
    "tinyllama-1.1b": (dict(h=32, kv=4, d=64),
                       [(1, 16, None), (1, 32, None), (4, 32, None), (1, 64, None),
                        (2, 64, None), (1, 128, None), (1, 256, None), (1, 2048, None)]),
    "recurrentgemma-9b": (dict(h=16, kv=1, d=256), [(1, 4096, 2048), (1, 1024, None)]),
    "paligemma-3b": (dict(h=8, kv=1, d=256), [(1, 272, None), (1, 356, None), (1, 512, None)]),
}
CHUNKS = dict(q_chunk=512, kv_chunk=1024)


def chain_share(torch, q, k) -> float:
    """Share of the plain version's first-block fp32 scores (its einsum)
    equal to the sequential FMA chain over d."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    qg = q[:, :CHUNKS["q_chunk"]].reshape(b, -1, kv, h // kv, d).float()
    kc = k[:, :CHUNKS["kv_chunk"]].float()
    if kc.shape[1] < CHUNKS["kv_chunk"]:  # the plain version pads k to its chunk
        kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, CHUNKS["kv_chunk"] - kc.shape[1]))
    plain = torch.einsum("bqkgd,bskd->bkgqs", qg, kc)
    chain = torch.zeros_like(plain)
    for i in range(d):
        chain = chain + (qg[..., i].permute(0, 2, 3, 1)[..., None]
                         * kc[..., i].permute(0, 2, 1)[:, :, None, None, :])
    return float((chain == plain).float().mean())


def measure(torch, fa, ref, seed: int, heads: str, chain: bool) -> dict:
    hd, shapes = CASES[heads]
    gen = torch.Generator("cuda").manual_seed(seed)
    worst_ulps, over_one, over_bound, worst_diff, cases, outputs_over = 0.0, 0, 0, 0.0, 0, 0
    shares = []
    for rows, s, window in shapes:
        q, k, v = (torch.randn((rows, s, n, hd["d"]), generator=gen, device="cuda")
                   .bfloat16() for n in (hd["h"], hd["kv"], hd["kv"]))
        if chain:
            shares.append(chain_share(torch, q, k))
        for causal in (True, False):
            o_k = fa.flash_attention(q, k, v, causal=causal, window=window, **CHUNKS)
            o_p = ref(q, k, v, causal, window=window, **CHUNKS).float()
            d = (o_k.float() - o_p).abs()
            ulp = torch.exp2(torch.floor(torch.log2(o_p.abs().clamp(min=1e-30))) - 7)
            scale = o_p.abs().max()
            differing = float((d > 0).float().mean())
            n_over = int((d > ulp + 1e-5 * scale).sum())
            ok = n_over == 0 and differing < 0.01
            cases += 1
            over_bound += not ok
            outputs_over += n_over
            big = o_p.abs() >= 1e-5 * scale
            worst_ulps = max(worst_ulps, float((d / ulp)[big].max()))
            over_one += int((d > ulp).sum())
            worst_diff = max(worst_diff, differing)
    r = {"heads": heads, "seed": seed, "cases": cases, "cases_over_bound": over_bound,
         "outputs_over_bound": outputs_over, "worst_ulps": worst_ulps,
         "outputs_over_one_ulp": over_one, "worst_share_differing": worst_diff}
    if chain:
        r["plain_scores_equal_chain"] = shares
    return r


def prebuild(settings, base: tuple) -> None:
    """Build the kernel at every window setting, one nvcc process each."""
    procs = []
    for p, mx in settings:
        flags = base + (f"-DFA_P_WINDOW={int(p)}", f"-DFA_MAX_WINDOW={float(mx)!r}f")
        code = ("import sys; sys.path.insert(0, %r); from repro_torch.kernels import build; "
                "build.NVCC_FLAGS = %r; build.build(('flash_attention',))"
                % (str(ROOT / "src"), flags))
        procs.append(subprocess.Popen([sys.executable, "-c", code]))
    for proc in procs:
        if proc.wait() != 0:
            raise RuntimeError("b3_accuracy: a kernel build failed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--windows", nargs="+", default=["32:0.000244140625"],
                    help="P:MAX settings of FA_P_WINDOW and FA_MAX_WINDOW")
    ap.add_argument("--heads", choices=sorted(CASES), default="tinyllama-1.1b")
    ap.add_argument("--chain", action="store_true",
                    help="also report the plain scores' share equal to the FMA chain")
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
    settings = [tuple(s.split(":")) for s in args.windows]
    if not other:
        prebuild(settings, base)
    for setting in ([None] if other else settings):
        if setting is not None:
            p, mx = setting
            build.NVCC_FLAGS = base + (f"-DFA_P_WINDOW={int(p)}", f"-DFA_MAX_WINDOW={float(mx)!r}f")
        build._LOADED.pop("flash_attention", None)
        fa._FN = None
        for seed in args.seeds:
            r = measure(torch, fa, flash_attention_ref, seed, args.heads,
                        args.chain and setting == settings[0])
            r["kernel"] = str(args.src) if other else f"p_window={p} max_window={mx}"
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
