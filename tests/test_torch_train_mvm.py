"""``analog_matmul`` in ``analog_train`` mode -- the paper's stage-2
forward and its gradients -- in the port against the reference, on the CPU.

For b_adc 4/6/8, ``quant_noise_p`` 1.0 and 0.5, one crossbar tile and
several (``tile_rows`` 64 over K = 150: three tiles, the last ragged), and
``use_kernel`` False (the reference's jnp path, whose ADC draws the quant
noise) and True (the reference's Pallas kernel in interpret mode under its
custom VJP; no ADC quant noise, as there), both sides jitted as the train
step runs them:

* the forward: every DAC/ADC code equal -- the outputs differ only where an
  unquantized partial is summed in another order, by far less than a
  thousandth of an ADC step;
* the gradients of x and w within rtol 1e-5 (atol 1e-6 of the largest);
  those of ``r_adc``, ``gain_s`` and ``w_clip_buf`` -- sums over every
  element, with cancellation, added in another order -- within
  ``RANGE_RTOL`` (measured worst 8.8e-5);

and on the port alone:

* the STE function's gradients (``kernels.ops.analog_mvm_ste``) equal
  autograd of the plain training form (``kernels.ref.analog_mvm_plain``);
* without a mask the plain version is bitwise the serving function it was
  (a copy of it is kept here); an all-set mask is the same function, an
  empty one passes every partial unquantized;
* the counters: the forward counts a plain call, the backward recompute
  only ``ops.backward_calls``; a serving call (no gradient, no key) does
  not go through the function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.core import analog as janalog
from repro_torch.core import analog as tanalog
from repro_torch.core import engine as tengine
from repro_torch.core.quant import QuantSpec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

#: the range gradients' relative tolerance (see the module docstring)
RANGE_RTOL = 3e-4
M, K, N = 40, 150, 24


def _case(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * K**-0.5).astype(np.float32)
    scal = (np.float32(2.5), np.float32(1.3), np.array([-0.12, 0.15], np.float32))
    cot = np.cos(np.arange(M * N).reshape(M, N) * 0.1).astype(np.float32)
    return x, w, *scal, cot


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("tile_rows", [1024, 64])
@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("b_adc", [4, 6, 8])
def test_analog_train_matmul_matches_reference(b_adc, p, tile_rows, use_kernel):
    x, w, r_adc, gain, clip, cot = _case(b_adc)
    key = jax.random.PRNGKey(7)
    jcfg = janalog.AnalogConfig().train(b_adc=b_adc, quant_noise_p=p, tile_rows=tile_rows,
                                        use_kernel=use_kernel, interpret=True)

    def jloss(x, w, r, g, c):
        ctx = janalog.AnalogCtx(cfg=jcfg, gain_s=g, key=key)
        y = janalog.analog_matmul(x, w, r_adc=r, w_min=c[0], w_max=c[1], ctx=ctx)
        return jnp.sum(y * cot), y

    f = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))
    (_, jy), jg = f(*map(jnp.asarray, (x, w, r_adc, gain, clip)))

    tcfg = tanalog.AnalogConfig().train(b_adc=b_adc, quant_noise_p=p, tile_rows=tile_rows,
                                        use_kernel=use_kernel)
    ts = [torch.tensor(v).requires_grad_() for v in (x, w, r_adc, gain, clip)]
    ctx = tanalog.AnalogCtx(cfg=tcfg, gain_s=ts[3],
                            key=torch.tensor(np.asarray(key).astype(np.int64)))
    y = tanalog.analog_matmul(ts[0], ts[1], r_adc=ts[2], w_min=ts[4][0], w_max=ts[4][1],
                              ctx=ctx)
    grads = torch.autograd.grad((y * torch.tensor(cot)).sum(), ts)

    step = (float(r_adc) + 1e-9) / (2 ** (b_adc - 1) - 1)
    assert float(np.abs(y.detach().numpy() - np.asarray(jy)).max()) < 1e-3 * step
    for name, got, want in zip(("x", "w"), grads[:2], jg[:2]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)
    for name, got, want in zip(("r_adc", "gain_s", "w_clip_buf"), grads[2:], jg[2:]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RANGE_RTOL,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)


def _plain_inputs(seed, m=12, k=150, n=10, tile_rows=64, per_tile=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    w = torch.randn((k, n), generator=g) * k**-0.5
    t = tref.n_tiles(k, tile_rows, per_tile)
    keep = torch.rand((m, t, n), generator=g) < 0.5
    return x, w, keep


@pytest.mark.parametrize("per_tile", [True, False])
def test_ste_function_gradients_equal_autograd_of_the_plain_form(per_tile):
    x, w, keep = _plain_inputs(1, per_tile=per_tile)
    r_dac, r_adc, out_scale = torch.tensor(3.0), torch.tensor(1.7), torch.tensor(0.9)
    kw = dict(bits=6, tile_rows=64, per_tile_adc=per_tile)
    leaves = [t.clone().requires_grad_() for t in (x, w, r_dac, r_adc, out_scale)]
    y = tops.analog_mvm_ste(leaves[0], leaves[1], r_dac=leaves[2], r_adc=leaves[3],
                            out_scale=leaves[4], keep=keep, **kw)
    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(y, leaves, cot)
    leaves2 = [t.clone().requires_grad_() for t in (x, w, r_dac, r_adc, out_scale)]
    y2 = tref.analog_mvm_plain(leaves2[0], leaves2[1], leaves2[2], leaves2[3], leaves2[4],
                               b_dac=7, b_adc=6, tile_rows=64, per_tile_adc=per_tile,
                               keep=keep)
    want = torch.autograd.grad(y2, leaves2, cot)
    assert torch.equal(y.detach(), y2.detach())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _serving_tile_mvm(x_f32, w, r_adc, b_adc, tile_rows, per_tile_adc, out_scale, out_dtype):
    """The plain serving function as it stood before the training form."""
    n_levels = 2 ** (b_adc - 1) - 1

    def fq(v):
        r = r_adc.abs() + 1e-9
        step = r / torch.full_like(r, n_levels)
        return torch.round(torch.minimum(torch.maximum(v, -r), r) / step) * step

    k = w.shape[0]
    wf = w.float()
    if not per_tile_adc or k <= tile_rows:
        return (fq(x_f32 @ wf) * out_scale).to(out_dtype)
    y = None
    for lo in range(0, k, tile_rows):
        part = fq(x_f32[..., lo:lo + tile_rows] @ wf[lo:lo + tile_rows])
        part = part.to(out_dtype).float()
        y = part if y is None else y + part
    return (y * out_scale).to(out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_tile", [True, False])
def test_plain_form_without_a_mask_is_the_serving_function(per_tile, dtype):
    x, w, keep = _plain_inputs(3, per_tile=per_tile)
    x, w = x.to(dtype), w.to(dtype)
    r_adc, out_scale = torch.tensor(1.7), torch.tensor(0.9)
    kw = dict(b_dac=7, b_adc=6, tile_rows=64, per_tile_adc=per_tile, apply_dac=False)
    y = tref.analog_mvm_ref(x, w, None, r_adc, out_scale, **kw)
    want = _serving_tile_mvm(x.float(), w, r_adc, 6, 64, per_tile, out_scale, dtype)
    assert torch.equal(y, want)
    assert torch.equal(tref.analog_mvm_ref(x, w, None, r_adc, out_scale, **kw,
                                           keep=torch.ones_like(keep)), y)
    none = tref.analog_mvm_ref(x, w, None, r_adc, out_scale, **kw, keep=torch.zeros_like(keep))
    if not per_tile:
        assert torch.equal(none, ((x.float() @ w.float()) * out_scale).to(dtype))
    mixed = tref.analog_mvm_ref(x, w, None, r_adc, out_scale, **kw, keep=keep)
    assert not torch.equal(mixed, y) and not torch.equal(mixed, none)


def test_counters_and_routes():
    x, w, keep = _plain_inputs(4)
    plan = tengine.ExecutionPlan(k=150, n=10, tile_rows=64, tile_cols=512, per_tile_adc=True,
                                 spec=QuantSpec(b_adc=6, quant_noise_p=0.5), use_kernel=False,
                                 interpret=False)
    r_adc = torch.tensor(1.7)
    calls = (tref.analog_mvm_ref.calls, tengine.tile_matmul_quant.calls, tops.backward_calls)
    tengine.execute_mvm(x, w, r_adc, plan)  # serving: the plain execute, no function
    assert (tref.analog_mvm_ref.calls, tengine.tile_matmul_quant.calls,
            tops.backward_calls) == (calls[0], calls[1] + 1, calls[2])
    xg = x.clone().requires_grad_()
    key = torch.tensor([0, 42], dtype=torch.int64)
    y = tengine.execute_mvm(xg, w, r_adc, plan, qn_key=key)
    assert tref.analog_mvm_ref.calls == calls[0] + 1
    y.sum().backward()
    assert tops.backward_calls == calls[2] + 1
    assert tref.analog_mvm_ref.calls == calls[0] + 1 and xg.grad is not None
    # the mask is the reference's draw over y's (..., T, N), as (M, T, N)
    y2 = tengine.execute_mvm_plain(x, w, r_adc, plan, qn_key=key)
    assert torch.equal(y.detach(), y2)
