#!/usr/bin/env python3
"""Whether the kernels that share B1's tensor-core code compile to a
parent's instructions, kernel by kernel, on a machine with the CUDA
toolkit.

    python3 tools/b1_sass_diff.py PARENT_CSRC [--tree TREE_CSRC]

Builds ``analog_mvm_tc.cu`` (B1's decode and prefill designs),
``decode_fused.cu`` (B2) and ``analog_mvm.cu`` (B1's ``gemv``) from the
parent's ``csrc`` directory (staged with ``git archive``) and from this
tree's, each to a cubin for ``sm_90a`` with the port's optimisation flags,
and compares every kernel's SASS (``cuobjdump -sass``) instruction for
instruction. A kernel renamed by a template parameter the parent did not
have (the prefill design's ``KEEP``) is matched to its ``KEEP = false``
instance. Prints one line per parent kernel and exits 1 if any differs
or is missing. Cubins go to ``build/sass/``.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("analog_mvm_tc", "decode_fused", "analog_mvm")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin")


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def kernels(cubin: Path) -> dict:
    """Kernel name -> its SASS instructions (addresses and encodings dropped)."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name and ins:
            out[name].append(ins.group(1).strip())
    return out


def unit_free(name: str) -> str:
    """A mangled name without its translation unit's anonymous-namespace hash."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "anon", name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="the parent's src/repro_torch/csrc")
    ap.add_argument("--tree", type=Path, default=ROOT / "src" / "repro_torch" / "csrc")
    args = ap.parse_args(argv)
    out = ROOT / "build" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([tool("nvcc"), *FLAGS, "-o", str(out / f"{src}.{who}.cubin"),
                               str(d / f"{src}.cu")])
             for src in SOURCES for who, d in (("parent", args.parent), ("tree", args.tree))]
    if any(p.wait() for p in procs):
        print("b1_sass_diff: a build failed", file=sys.stderr)
        return 2
    same_all = True
    for src in SOURCES:
        parent, tree = kernels(out / f"{src}.parent.cubin"), kernels(out / f"{src}.tree.cubin")
        by_name = {unit_free(n): n for n in tree}
        for name, body in parent.items():
            match = by_name.get(unit_free(name))
            if match is None and "prefill" in name:  # the parent's untemplated prefill kernel
                match = next((n for n in tree if "prefill" in n and "ILb0E" in n), None)
            same = match is not None and tree[match] == body
            same_all &= same
            print(f"{src}: {name} -> {match}: {len(body)} instructions, identical {same}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
