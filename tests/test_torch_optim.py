"""The port's optimizers and gradient compression against the reference,
on the CPU (``training/optim.py``, ``training/compression.py``):

* AdamW and Adafactor ``update`` on the same params and gradients over 3
  steps (a warm-up, the cosine and the range schedules, the global-norm
  clip engaged), params, moments and metrics within 1e-6 relative;
* the schedules within f32 rounding;
* the parameter groups, as ``tests/test_substrate.py`` pins them: a
  frozen ``*_buf`` unchanged (its gradient still in the global norm),
  ``gain_s``'s gradient clipped at 0.01, ``r_adc`` on its own smaller LR;
  Adafactor's factored state;
* the returned trees walk in ``jax.tree``'s order (dict keys sorted);
* compression round trips: int8 payload and scales bitwise, the error
  feedback preserving the sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.training import compression as jcomp
from repro.training import optim as joptim
from repro_torch import tree as tree_lib
from repro_torch.training import compression as tcomp
from repro_torch.training import optim as toptim


def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        "gain_s": np.float32(1.0) + f(),
        "conv": {"w": f(3, 3, 2, 160), "r_adc": np.float32(1.2),
                 "w_clip_buf": np.array([-0.3, 0.3], np.float32), "bn_bias": f(160)},
        "fc": {"w": f(200, 130), "b": f(130), "r_adc": np.float32(0.8),
               "w_clip_buf": np.array([-0.2, 0.2], np.float32)},
    }


def _to_torch(tree):
    return tree_lib.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_update_matches_reference_over_three_steps(kind):
    cfg_j = joptim.OptimizerConfig(kind=kind, lr=3e-3, total_steps=5, warmup=2,
                                   factored_min_dim=128)
    cfg_t = toptim.OptimizerConfig(kind=kind, lr=3e-3, total_steps=5, warmup=2,
                                   factored_min_dim=128)
    params = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = joptim.init(cfg_j, jp), toptim.init(cfg_t, tp)
    for step in range(3):
        grads = jax.tree.map(lambda a: a * 3.0, _tree(10 + step))  # global norm > 1
        jp, js, jm = joptim.update(cfg_j, jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts, tm = toptim.update(cfg_t, tp, _to_torch(grads), ts)
        for k in ("grad_norm", "lr"):
            _close(float(tm[k]), float(jm[k]))
        for name, jt, tt in (("params", jp, tp), ("m", js.m, ts.m), ("v", js.v, ts.v),
                             ("v_col", js.v_col, ts.v_col)):
            want = jax.tree_util.tree_flatten_with_path(jt)[0]
            got = tree_lib.flatten_with_path(tt)
            assert [jax.tree_util.keystr(p) for p, _ in want] == [
                "".join(f"['{k}']" for k in p) for p, _ in got], name
            for (_, a), (_, b) in zip(want, got):
                _close(b.numpy(), a)
        assert int(ts.step) == int(js.step)
    assert list(tp) == sorted(tp) and list(tp["conv"]) == sorted(tp["conv"])


def test_schedules():
    for step in range(0, 12):
        _close(float(toptim.cosine_schedule(3e-3, 10, 2)(step)),
               float(joptim.cosine_schedule(3e-3, 10, 2)(step)))
        _close(float(toptim.exp_schedule(1e-3, 1e-4, 10)(step)),
               float(joptim.exp_schedule(1e-3, 1e-4, 10)(step)))


def test_buffers_frozen_and_s_clipped():
    cfg = toptim.OptimizerConfig(lr=0.1, total_steps=10, warmup=0)
    params = {"w": torch.ones(2), "w_clip_buf": torch.tensor([-1.0, 1.0]),
              "gain_s": torch.tensor(1.0), "r_adc": torch.tensor(1.0)}
    grads = {"w": torch.ones(2), "w_clip_buf": torch.tensor([9.0, 9.0]),
             "gain_s": torch.tensor(100.0), "r_adc": torch.tensor(1.0)}
    state = toptim.init(cfg, params)
    new, state, m = toptim.update(cfg, params, grads, state)
    assert torch.equal(new["w_clip_buf"], params["w_clip_buf"])
    # the frozen buffer's gradient still enters the clip's global norm
    assert float(m["grad_norm"]) == pytest.approx(float(np.sqrt(2 + 162 + 1e4 + 1)), rel=1e-6)
    assert 0.0 < float(params["gain_s"] - new["gain_s"]) <= cfg.lr * 1.01
    assert abs(float(new["r_adc"] - params["r_adc"])) <= 1.1e-3
    assert [toptim.classify_param(p) for p in (("a", "w_clip_buf"), ("r_adc",), ("gain_s",),
                                               ("fc", "w"), ("fc", "out_scale_buf"))] == [
        "frozen", "range", "gain", "weight", "frozen"]


def test_adafactor_state_is_factored():
    cfg = toptim.OptimizerConfig(kind="adafactor", factored_min_dim=4)
    params = {"w": torch.zeros((128, 64)), "b": torch.zeros(3)}
    state = toptim.init(cfg, params)
    assert state.v["w"].shape == (128,) and state.v_col["w"].shape == (64,)
    assert state.v["b"].shape == (3,)
    new, _, _ = toptim.update(cfg, params, {"w": torch.ones((128, 64)), "b": torch.ones(3)},
                              state)
    assert bool(new["w"].isfinite().all())


def test_adamw_minimizes_quadratic():
    cfg = toptim.OptimizerConfig(lr=0.1, total_steps=100, warmup=0, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = toptim.init(cfg, params)
    for _ in range(60):
        params, state, _ = toptim.update(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.5


@pytest.mark.parametrize("n", [1000, 2048, 5])
def test_compression_round_trip_bitwise(n):
    rng = np.random.default_rng(n)
    g = {"a": rng.normal(size=(n,)).astype(np.float32),
         "b": {"c": rng.normal(size=(3, 7)).astype(np.float32)}}
    err = jax.tree.map(lambda a: (a * 0.01).astype(np.float32), g)
    jq, js, je = jcomp.compress(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, err))
    tq, tsc, te = tcomp.compress(_to_torch(g), _to_torch(err))
    for a, b in zip(jax.tree.leaves(jq), tree_lib.leaves(tq)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    for a, b in zip(jax.tree.leaves(js), tree_lib.leaves(tsc)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    for a, b in zip(jax.tree.leaves(je), tree_lib.leaves(te)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-7)
    back = tcomp.decompress(tq, tsc, _to_torch(g))
    want = jcomp.decompress(jq, js, jax.tree.map(jnp.asarray, g))
    for a, b in zip(jax.tree.leaves(want), tree_lib.leaves(back)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    # error feedback: the sum of what was sent plus the new error is the input
    for x, e0, d, e1 in zip(tree_lib.leaves(_to_torch(g)), tree_lib.leaves(_to_torch(err)),
                            tree_lib.leaves(back), tree_lib.leaves(te)):
        torch.testing.assert_close(d + e1, x + e0, rtol=0, atol=1e-6)
    assert tree_lib.leaves(tcomp.init_error_state(_to_torch(g)))[0].dtype == torch.float32
