"""``repro_torch.launch.dryrun.run_cell`` over the single-pod production
mesh -- rank 0 of a fake group of 256 ranks (16x16; the 2-pod mesh's
cells are ``test_torch_dryrun_multipod.py``'s) -- for every smoke family
(dense, MoE, SSM, hybrid, vision, audio), cut to one block period, in all
three modes: each records ``status: "ok"`` with its memory, cost,
collectives and roofline, and leaves no process group behind. The cells
are cut to 32 positions of 32 rows (the full shapes' attention chunks at
the smoke configs' 16 x 32 would take minutes of tracing), each (family,
mode) pair at one of train, prefill and decode, so every mode meets every
kind.
~30 s alone (the per-call PCM chains of ``analog_infer`` run each emulated
operation once a shape, ``analysis.cost.memoized``).
"""

import dataclasses

import pytest
import torch.distributed as dist

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_smoke
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.models.lm import block_period

FAMILIES = ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b", "recurrentgemma-9b",
            "paligemma-3b", "musicgen-large"]
MODES = ["digital", "analog_train", "analog_infer"]
KINDS = ["train", "prefill", "decode"]


def check_cell(multi_pod: bool, arch: str, mode: str) -> None:
    kind = KINDS[(FAMILIES.index(arch) + MODES.index(mode)) % 3]
    cfg = get_smoke(arch)
    cfg = dataclasses.replace(cfg, n_layers=len(block_period(cfg)))  # one block period
    rec = dryrun.run_cell(arch, kind, multi_pod, mode, verbose=False, override_cfg=cfg,
                          cell=ShapeCell(kind, 32, 32, kind))
    assert rec["status"] == "ok", rec.get("traceback")
    assert not dist.is_initialized()
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["chips"] == (512 if multi_pod else 256)
    mem, roof = rec["memory"], rec["roofline"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] >= 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert rec["collectives"]["counts"].get("all-gather", 0) > 0
    assert roof["bottleneck"] in ("compute", "memory", "collective") and roof["t_step_s"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_family_cell_is_ok(arch, mode):
    check_cell(False, arch, mode)
