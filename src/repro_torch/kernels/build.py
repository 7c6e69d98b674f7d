"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (the ``csrc/*.cuh`` headers are shared device
code), loaded through ``ctypes`` (no PyTorch headers, so
a build takes seconds, not minutes). Libraries land in ``build/repro_torch/``
at the repository root, named by a hash of the source, the headers and the
flags: a changed source or header rebuilds, an unchanged one loads. Nothing outside the
repository's sources goes in, nothing is downloaded, and a failed build
raises with the compiler's output. Sources build in parallel, one ``nvcc``
process each. ``ptxas -v``'s report (registers, shared memory, spills of
each kernel) is kept beside each library as ``<library>.log``.

Fleet workers launch from several threads (one CUDA stream each): every
first load of a library and every launch count goes through :data:`LOCK`
(:func:`load`, :func:`bump`), so each library is built and loaded once and
no count is lost.

**Fake tensors.** A dry run (``launch.dryrun``) traces a step on
``torch._subclasses.fake_tensor.FakeTensor`` operands, which hold a shape,
a dtype and a device but no data. Every launch point has a branch that
fires only on one (:func:`is_fake`): it allocates the output and the
workspace the launch would, launches nothing and counts no launch. A real
tensor never takes it. :func:`on_card` is the route choice the port makes
where a card runs other code than the CPU (a kernel, B2's row code): a
CUDA tensor, or a fake tensor inside :func:`card_trace` -- a CPU-only
build of torch makes fake ``cuda`` tensors, but its autograd engine
aborts on one (it has no CUDA device guard), so a host without a card
traces a step on fake CPU tensors that stand for the card's.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
#: guards library loads (and the wrappers' lazy bindings) and launch counts
LOCK = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "Hopper kernels are built from src/repro_torch/csrc at first use"
    )


def sources() -> tuple[str, ...]:
    """Every kernel source, by name (``csrc/<name>.cu``)."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (keyed by source, headers, flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every missing library of ``names`` (default: every source)
    in parallel, one ``nvcc`` each; raise on a failed build. Returns name
    -> library path."""
    names = sources() if names is None else tuple(names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        todo[n].with_suffix(".log").write_text(out)
        os.replace(tmp, todo[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def ptxas_report(path: Path) -> list[dict]:
    """Per kernel entry of a built library: ptxas's register, shared-memory
    and spill figures, from the ``.log`` kept beside it."""
    log = path.with_suffix(".log")
    entries = []
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry function" in line:
            entries.append({"entry": line.split("'")[1]})
        elif entries and ("spill stores" in line or "Used " in line):
            entries[-1]["spills" if "spill" in line else "used"] = line.split(":")[-1].strip()
    return entries


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (once, whichever thread asks first)."""
    with LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _LOADED[name] = lib
        return lib


def bump(owner, name: str, key=None) -> None:
    """Add one launch to ``owner.<name>`` (or to ``owner.<name>[key]``)
    under :data:`LOCK`: ``+=`` on shared state is not atomic across threads."""
    with LOCK:
        if key is None:
            setattr(owner, name, getattr(owner, name) + 1)
        else:
            getattr(owner, name)[key] += 1


_CARD_TRACE = {"on": False}


def is_fake(t) -> bool:
    """``t`` is a fake tensor (shape, dtype and device, no data)."""
    return isinstance(t, FakeTensor)


def on_card(t) -> bool:
    """``t`` takes the card's route: a CUDA tensor, or a fake tensor under
    :func:`card_trace`."""
    return t.device.type == "cuda" or (_CARD_TRACE["on"] and is_fake(t))


@contextlib.contextmanager
def card_trace(on: bool = True):
    """Fake tensors on any device follow the card's route for the block's
    duration (see the module docstring)."""
    before = _CARD_TRACE["on"]
    _CARD_TRACE["on"] = bool(on)
    try:
        yield
    finally:
        _CARD_TRACE["on"] = before
