"""Port hygiene: the PyTorch package stands alone.

* No file of ``src/repro_torch`` (nor ``chip_smoke.py``, nor an
  ``examples/*_torch.py``) imports ``jax``, ``jaxlib`` or the reference
  package ``repro`` -- an AST scan.
* Every port module imports in a fresh interpreter where ``jax`` and
  ``repro`` cannot be imported at all.
* On a host without a card, entry points called without ``device=`` raise
  instead of quietly running on the CPU.
* The port lints clean under the repo's own rules (RL001-RL006).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "examples").glob("*_torch.py")))


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_no_reference(path):
    assert path.exists()
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_every_port_module_imports_without_jax_or_reference():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= len(modules)


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch import convert, prng
    from repro_torch.checkpoint import store
    from repro_torch.bench.common import KWS_BENCH, train_model
    from repro_torch.configs import get_smoke
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = get_smoke("tinyllama-1.1b")
    key = prng.PRNGKey(0)
    params = lm.lm_init(key, cfg, device="cpu")
    calls = [
        lambda: lm.lm_init(key, cfg),
        lambda: lm.init_lm_cache(cfg, 1, 8, cfg.dtype),
        lambda: engine.compile_program(params, AnalogConfig().infer(), key),
        lambda: store.load_program(str(tmp_path)),
        lambda: convert.params_from_numpy({"gain_s": np.ones(())}),
        lambda: ServingEngine(cfg, AnalogConfig(), params,
                              ServingConfig(n_slots=1, s_max=8)),
        lambda: train.main(["--arch", "analognet-kws", "--stage1", "1", "--stage2", "1"]),
        lambda: train.cnn_setup("analognet-kws", 4),
        lambda: train.lm_setup("tinyllama-1.1b", True, 2, 16),
        lambda: train.main(["--arch", "tinyllama-1.1b", "--stage1", "1", "--stage2", "1"]),
        lambda: train_model(KWS_BENCH, stage1=1, stage2=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_port_lints_clean():
    from repro.analysis.lint import lint_paths

    findings, n_files = lint_paths([PORT])
    assert n_files >= 20
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)
