"""B1's expert-bank form on the CPU: its plain version, the engine's bank
MVM and the wrapper's arithmetic (``kernels/analog_mvm.py``,
``kernels/ref.py::analog_mvm_bank_plain``, ``core/engine.py::
execute_mvm_bank``, ``core/analog.py::analog_matmul_bank``).

* The bank's plain version is bitwise the 2-D plain version expert by
  expert (fp32 and bf16, one and several crossbar tiles, a float and an
  (E,) ``out_scale``, the training form's keep mask), and the engine's
  bank MVM bitwise ``execute_mvm`` on each expert's slice, counted once in
  ``analog_mvm_bank_ref.calls``.
* A programmed family through ``analog_matmul_bank`` (one DAC over the
  whole bank) is bitwise ``analog_matmul`` expert by expert; under grad
  the bank goes through the 2-D STE function expert by expert, with the
  same gradients.
* The wrapper: CPU tensors are refused (the card's kernel or nothing);
  the designs it takes at phi3.5-moe's shapes (a decode step of 8 slots
  and a bucketed 1 x 256 prefill), and the workspace layout (each
  expert's 2-D workspace, 16-byte aligned).

The kernel itself runs only on the card: ``tests/test_torch_mvm_bank_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro_torch.core import analog as tanalog
from repro_torch.core import engine as tengine
from repro_torch.kernels import analog_mvm as kernel
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as tmoe


def _bank(e, m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((e, m, k)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((e, k, n)) * k**-0.5).astype(np.float32)).to(dtype)
    scales = torch.from_numpy((0.8 + 0.4 * rng.random(e)).astype(np.float32))
    return x, w, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [48, 100])  # one crossbar tile of 64 rows, and two
@pytest.mark.parametrize("per_expert_scale", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bank_plain_is_the_2d_plain_expert_by_expert(dtype, k, per_expert_scale, masked):
    e, m, n = 3, 5, 24
    x, w, scales = _bank(e, m, k, n, dtype, seed=k)
    out_scale = scales if per_expert_scale else 0.9
    r_adc = torch.tensor(1.5)
    t = ref.n_tiles(k, 64, True)
    keep = (torch.from_numpy(np.random.default_rng(1).random((e, m, t, n))) < 0.5
            if masked else None)
    y = ref.analog_mvm_bank_plain(x, w, r_adc, out_scale, b_adc=6, tile_rows=64, keep=keep)
    assert y.shape == (e, m, n) and y.dtype == dtype
    for i in range(e):
        want = ref.analog_mvm_plain(x[i], w[i], None, r_adc,
                                    scales[i] if per_expert_scale else 0.9, b_adc=6,
                                    tile_rows=64, apply_dac=False,
                                    keep=None if keep is None else keep[i])
        assert torch.equal(y[i], want)


def test_engine_bank_mvm_is_execute_mvm_per_expert():
    x, w, scales = _bank(4, 6, 96, 40, torch.float32, seed=3)
    cfg = tanalog.AnalogConfig(tile_rows=32).infer(b_adc=8)
    plan = tengine.plan_for(cfg, 96, 40)
    r_adc = torch.tensor(2.0)
    calls = ref.analog_mvm_bank_ref.calls
    y = tengine.execute_mvm_bank(x, w, r_adc, plan, out_scale=scales)
    assert ref.analog_mvm_bank_ref.calls == calls + 1
    for i in range(4):
        assert torch.equal(y[i], tengine.execute_mvm(x[i], w[i], r_adc, plan,
                                                     out_scale=scales[i]))
    # a (E, G, C, K) bank keeps its lead dims
    y4 = ops.analog_mvm_bank(x.reshape(4, 2, 3, 96), w, r_adc=r_adc, out_scale=scales, bits=8,
                             tile_rows=32)
    assert torch.equal(y4.reshape(y.shape), y)


def test_programmed_family_is_analog_matmul_per_expert():
    x, w, scales = _bank(4, 7, 64, 32, torch.float32, seed=5)
    cfg = tanalog.AnalogConfig(tile_rows=32).infer(b_adc=6)
    ctx = tanalog.AnalogCtx(cfg=dataclasses.replace(cfg, mode=tengine.PCM_PROGRAMMED),
                            gain_s=torch.tensor(1.0))
    kw = dict(r_adc=torch.tensor(1.5), w_min=torch.tensor(-0.8), w_max=torch.tensor(0.8), ctx=ctx)
    y = tanalog.analog_matmul_bank(x, w, out_scale=scales, **kw)
    for i in range(4):
        assert torch.equal(y[i], tanalog.analog_matmul(x[i], w[i], out_scale=scales[i], **kw))
    # under grad: the 2-D STE function expert by expert, the same values
    # and gradients as the experts one at a time
    xg = x.clone().requires_grad_(True)
    yg = tanalog.analog_matmul_bank(xg, w, out_scale=scales, **kw)
    assert torch.equal(yg.detach(), y)
    back = ops.backward_calls
    yg.square().sum().backward()
    assert ops.backward_calls == back + 4
    x1 = x[1].clone().requires_grad_(True)
    tanalog.analog_matmul(x1, w[1], out_scale=scales[1], **kw).square().sum().backward()
    assert torch.equal(xg.grad[1], x1.grad)


def test_the_wrapper_takes_only_card_tensors():
    x, w, _ = _bank(2, 8, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.analog_mvm_bank(x, w, r_adc=torch.tensor(1.0))
    with pytest.raises(ValueError, match=r"x \(E, M, K\)"):
        kernel.analog_mvm_bank(x[0], w[0], r_adc=torch.tensor(1.0))


# phi3.5-moe at 8 decode slots: G = 8 groups of 1 token, C = 1 slot an
# expert; a bucketed 1 x 256 prefill: G = 32 groups of 8 tokens, C = 1
@pytest.mark.parametrize("tokens,m,design", [(8, 8, "decode"), (256, 32, "prefill")])
def test_phi_bank_shapes_and_designs(tokens, m, design):
    from repro_torch.configs import get

    cfg = get("phi3.5-moe-42b-a6.6b")
    g, sg, cap = tmoe.capacity(cfg, tokens)
    assert g * cap == m
    for k, n in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
        assert kernel.select_design(torch.bfloat16, m, k, n) == design
        assert design in kernel.BANK_DESIGNS
        plan = (kernel.split_plan if design == "decode" else kernel.prefill_plan)(m, k, n)
        stride, off = kernel.bank_workspace_words(plan)
        words, off2 = kernel.workspace_words(plan)
        assert stride % 4 == 0 and words <= stride < words + 4 and off == off2
    assert kernel.select_design(torch.float32, m, 64, 128) == "tiled"
    # bf16 with a keep mask at <= 16 rows is gemv's: the bank form refuses it
    assert kernel.select_design(torch.bfloat16, 8, 64, 128, keep=True) not in kernel.BANK_DESIGNS
