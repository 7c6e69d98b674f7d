"""The sharded train step (``launch/steps.py::make_train_step(mesh=)``) over
gloo, against the port's unsharded step and JAX's.

The ranks run in processes of their own (``tests/_torch_dist_worker.py``):
1 rank at mesh (1, 1); 2 ranks at (1, 2), and at (2, 1) with the
operator checks; 2 ranks for the other families at (1, 2) and (2, 1); 4
ranks at (2, 2), then the reference's scenario and one column-parallel MVM
at (1, 4); 4 ranks at (4, 1) for the MoE. Each group has the 60 s timeout of
``test_torch_distributed.py`` on its process group and its processes;
``CHAINS`` runs them, the chains side by side. Meanwhile this process
runs the port's unsharded steps and JAX's unsharded jitted step. Each
worker asks for 8 intra-op threads before its group is made; the group
pins one (``launch.mesh.init_process_group``), and every unsharded result
here is computed at one thread too (``core/analog.py``'s note).

The cases: tinyllama-1.1b's smoke config (``dense``) and the MoE smoke of
``tests/test_sharded_program.py`` (``moe``), at ``tile_rows=32`` so that
row splits happen, in ``analog_train`` (eta 0.1, b_adc 6, both quant-noise
masks at p = 0.5; dense also over 2 microbatches) and ``digital``; the
other families' smoke configs in ``analog_train`` (``mamba2``, ``rgemma``,
``pali``: the causal conv's channel-sharded ``conv_w`` and ``conv_b``
gathered in ``train_view``, the SSD and RG-LRU leaves, paligemma's single
KV head); B = 8, S = 32, AdamW at lr 1e-2, 3 steps. ``MESH_CASES`` says
which mesh runs which.

* (1, 1) and the model axis (1, 2): params, optimizer state and metrics
  after every step bitwise the unsharded step's (at (1, 2) the other
  families too, over ``FAMILY_STEPS`` steps).
* Every mesh: each draw of step 1 (weight noise, DAC and ADC masks) a
  rank's slice of the unsharded step's draw with the same key, the ranks'
  slices covering it; every FSDP gather exact; the step-1 loss and the
  per-token loss of the step-1 forward bitwise; a step run twice bitwise.
* The data axis, (2, 1), (2, 2) and (4, 1) (at (2, 1) recurrentgemma
  too, one step, held to the step-1 bars; at (4, 1) the MoE, whose 2
  routing groups do not split over 4 ranks: every rank routes the
  gathered batch and keeps its rows' gradient, ``moe.moe_apply``). A weight gradient's contraction over
  the batch is cut into one partial a rank, summed in rank order
  (``collectives.sum_in_rank_order``), not in the unsharded order, so the
  gradients differ by rounding. After step 1 the grad norm is within
  1e-6 relative of the unsharded step's and every param and optimizer
  moment leaf within 1e-4 relative L2 (measured: the norm bitwise, the
  leaves within 2.0e-6). After 3 steps each param leaf's distance from
  the unsharded step's, over the distance the unsharded step moved it, is
  within ``DATA_AXIS_GAP`` (measured 6.7e-2 dense, 0.36 MoE, each on an
  ``r_adc`` leaf). The witness of the cause: the unsharded step run on
  from the sharded step-1 state (``witness``, rank 0) lands within 1e-3
  of that distance of the sharded result (measured 2.2e-6 dense, 2.5e-4
  MoE), so the gap is step 1's rounding grown by the unsharded step
  itself -- stage 2's 6-bit ADC codes and, in the MoE, its routing: the
  witness routes as the unsharded step at step 2 and flips top-2 choices
  at step 3 (49 of 1024).
* The reference's scenario (``tests/test_distributed.py``) at (2, 2):
  the loss falls over 6 steps, each rank holds only its slice of every TP
  weight, the last loss within 0.1 of JAX's unsharded jitted step and step
  1 within ``tests/test_torch_lm_train.py``'s bars of JAX's (loss 1e-4
  relative, grad norm 1e-4, params 1e-4 relative L2), but for one
  embedding element whose gradient nearly cancels (see the test).
* One column-parallel MVM at (1, 4), K = 1024, N = 2048, digital at M =
  2-8 and ``analog_train`` at 8 (where 8 threads break the column
  slices): every rank's output and gradients, gathered, bitwise the whole
  layer's on rank 0.
* The autograd operators, ``sum_in_rank_order`` and the optimizer's
  update on sharded leaves (AdamW, Adafactor; at (2, 1) and (1, 2))
  bitwise; the sliced ``bernoulli`` and ``uniform`` draws; every family
  takes a mesh, the shard_map MoE dispatch refuses one; the process
  group's default device.
"""

import contextlib
import dataclasses
import inspect
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro.configs import get_smoke as j_get_smoke
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.training import optim as joptim
from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core.analog import AnalogConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.common import ModelConfig
from repro_torch.training import optim as toptim

from test_torch_distributed import _group

#: the worker's cases (``_torch_dist_worker.TRAIN_CASES``: model, config,
#: accum_steps) and the cases each mesh runs (``MESH_CASES``)
TRAIN = AnalogConfig(tile_rows=32).train(eta=0.1, b_adc=6, quant_noise_p=0.5)
DIGITAL = AnalogConfig(tile_rows=32)
CASES = {"dense-analog": ("dense", TRAIN, 1), "moe-analog": ("moe", TRAIN, 1),
         "dense-digital": ("dense", DIGITAL, 1), "moe-digital": ("moe", DIGITAL, 1),
         "dense-analog-accum2": ("dense", TRAIN, 2),
         "mamba2-analog": ("mamba2", TRAIN, 1), "rgemma-analog": ("rgemma", TRAIN, 1),
         "pali-analog": ("pali", TRAIN, 1)}
#: the other families' smoke configs, and their cases (at (1, 2) in the
#: worker's ``train1xf-<names>`` jobs)
FAMILIES = {"mamba2": "mamba2-2.7b", "rgemma": "recurrentgemma-9b", "pali": "paligemma-3b"}
FAMILY_CASES = ("mamba2-analog", "rgemma-analog", "pali-analog")
#: their steps: 2 (the worker's FAMILY_STEPS) on a model axis, 1 on a data axis
FAMILY_STEPS = 2
MESH_CASES = {(1, 1): ("dense-analog", "moe-analog", "dense-digital"), (1, 2): tuple(CASES),
              (2, 1): ("dense-analog", "moe-analog", "rgemma-analog"),
              (2, 2): ("dense-analog",), (4, 1): ("moe-analog",)}
OPT = toptim.OptimizerConfig(lr=1e-2, total_steps=50, warmup=0)
B, S, STEPS = 8, 32, 3
#: the data axis after step 1: grad norm and each param and optimizer-state
#: leaf (relative L2) against the unsharded step's
STEP1_GRAD_NORM_RTOL, STEP1_RTOL = 1e-6, 1e-4
#: the data axis after 3 steps: each param leaf's distance from the
#: unsharded step's, over the distance the unsharded step moved it (see the
#: module docstring), and from the witness's over the same
DATA_AXIS_GAP = {"dense-analog": 0.1, "moe-analog": 0.5}
WITNESS_GAP = 1e-3
#: meshes -> (ranks, worker jobs)
MESHES = {(1, 1): (1, ("train1x1",)),
          (1, 2): (2, ("train1xn-dense", "train1xn-moe", "train1xf-mamba2-rgemma-pali")),
          (2, 1): (2, ("train2xn", "train2xf-rgemma")), (2, 2): (4, ("train2xn",)),
          (4, 1): (4, ("train4x1",))}
#: chains of (world, worker jobs) groups: a chain's groups run one after
#: another (each a process group of its own, with its own timeout), the
#: chains side by side. The (1, 2) mesh's dense and MoE cases are two
#: groups of one chain: as one group they took 56-60 s of its 60 under a
#: whole tier-1 run. The other families' cases are a 2-rank group after
#: ``train2xn,ops`` (a fifth chain timed the 2-rank groups out there).
CHAINS = (((1, "train1x1"), (4, "train4x1")), ((2, "train1xn-dense"), (2, "train1xn-moe")),
          ((2, "train2xn,ops"), (2, "train1xf-mamba2-rgemma-pali,train2xf-rgemma")),
          ((4, "train2xn"), (4, "jax,hazard")))


def _cfg(name):
    if name == "dense":
        return t_get_smoke("tinyllama-1.1b")
    if name in FAMILIES:
        return t_get_smoke(FAMILIES[name])
    return ModelConfig(name="t", family="moe", n_layers=2, n_experts=8, top_k=2).smoke()


def _batch(vocab):
    rng = np.random.default_rng(3)
    return {k: torch.as_tensor(rng.integers(0, vocab, size=(B, S))) for k in ("tokens", "labels")}


@contextlib.contextmanager
def _draws(log: dict):
    """Record every ``prng`` sampler draw: key -> (sampler, p, numel)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("bernoulli", "normal", "normal_erf_inv"):
            fn = getattr(prng, name)

            def draw(key, *args, _name=name, _fn=fn, **kw):
                out = _fn(key, *args, **kw)
                p = args[0] if _name == "bernoulli" else None
                log[tuple(int(v) for v in key)] = (_name, p, out.numel())
                return out

            mp.setattr(prng, name, draw)
        yield


@contextlib.contextmanager
def _routing():
    """Every ``moe._topk_routing`` call's top-k expert choices, appended to
    the yielded list."""
    calls, topk = [], tmoe._topk_routing

    def record(gates, k, cap):
        out = topk(gates, k, cap)
        calls.append(torch.stack(out[0]).numpy())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmoe, "_topk_routing", record)
        yield calls


def _unsharded(case):
    """The port's unsharded step: metrics a step, the params and state
    after the last, step 1's draws and the step-1 forward's per-token
    loss."""
    name, acfg, accum = CASES[case]
    cfg = _cfg(name)
    params = tlm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
    p0 = {k: v.numpy().copy() for k, v in store._flatten(params).items()}
    opt = toptim.init(OPT, params)
    batch = _batch(cfg.vocab)
    key0 = prng.fold_in(prng.PRNGKey(0), 0)
    with torch.no_grad():
        logits, _ = tlm.lm_forward(params, {"tokens": batch["tokens"]}, acfg, cfg,
                                   rng=prng.fold_in(key0, 0))
        logits = logits.float()
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, batch["labels"][..., None])[..., 0]
    step = tsteps.make_train_step(cfg, acfg, OPT, accum)
    out, draws = {"nll": nll.numpy(), "metrics": [], "params0": p0}, {}
    for i in range(FAMILY_STEPS if case in FAMILY_CASES else STEPS):
        with _draws(draws) if i == 0 else contextlib.nullcontext(), _routing() as route:
            params, opt, m = step(params, opt, batch, prng.fold_in(prng.PRNGKey(0), i))
        out[f"route{i}"] = np.stack(route) if route else np.zeros(0, np.int64)
        out["metrics"].append({k: v.numpy() for k, v in m.items()})
        if i == 0:
            out["params1"] = {k: v.numpy() for k, v in store._flatten(params).items()}
            out["opt1"] = {k: v.numpy() for k, v in store._flatten(opt).items()}
    out["draws"] = draws
    out["params"] = {k: v.numpy() for k, v in store._flatten(params).items()}
    out["opt"] = {k: v.numpy() for k, v in store._flatten(opt).items()}
    return out


def _jax_batch() -> dict:
    """The reference's scenario's batch (its tokens are its labels)."""
    key = jax.random.PRNGKey(0)
    vocab = j_get_smoke("tinyllama-1.1b").vocab
    return {k: np.asarray(jax.random.randint(key, (B, S), 0, vocab))
            for k in ("tokens", "labels")}


def _jax_reference(batch: dict, out: dict) -> None:
    """JAX's unsharded jitted step over the reference's scenario, 6 steps,
    into ``out``: its losses, step-1 grad norm and params."""
    jcfg = j_get_smoke("tinyllama-1.1b")
    key = jax.random.PRNGKey(0)
    params = jlm.lm_init(key, jcfg)
    ocfg = joptim.OptimizerConfig(lr=1e-2, total_steps=50, warmup=0)
    opt = joptim.init(ocfg, params)
    step = jax.jit(jsteps.make_train_step(jcfg, JAnalogConfig(tile_rows=32).train(eta=0.05),
                                          ocfg))
    out["loss"] = []
    for i in range(6):
        params, opt, m = step(params, opt, batch, jax.random.fold_in(key, i))
        out["loss"].append(float(m["loss"]))
        if i == 0:
            out["grad_norm"] = float(m["grad_norm"])
            out["params"] = {k: np.asarray(v) for k, v in store._flatten(params).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train"))
    batch = _jax_batch()
    os.makedirs(os.path.join(root, "w4"))
    np.savez(os.path.join(root, "w4", "jax_batch.npz"), **batch)
    errors, jref = {}, {}

    def ranks(chain):
        for world, jobs in chain:
            err = _group(world, os.path.join(root, f"w{world}"), jobs)
            errors.update({(world, job): err for job in jobs.split(",")})

    threads = [threading.Thread(target=ranks, args=(c,)) for c in CHAINS]
    threads.append(threading.Thread(target=_jax_reference, args=(batch, jref)))
    for t in threads:
        t.start()
    ref = {case: _unsharded(case) for case in CASES}
    for t in threads:
        t.join()
    return dict(root=root, errors=errors, ref=ref, jax=jref, loaded={})


def _load(runs, world, job):
    """Each rank's results of ``job``, read once for the module (the tests
    only read them)."""
    err = runs["errors"][(world, job)]
    assert not err, err
    if (world, job) not in runs["loaded"]:
        out = os.path.join(runs["root"], f"w{world}")
        runs["loaded"][(world, job)] = [dict(np.load(os.path.join(out, f"{job}.rank{r}.npz")))
                                        for r in range(world)]
    return runs["loaded"][(world, job)]


def _ranks(runs, mesh):
    """Each rank's results at ``mesh``, its jobs' files merged."""
    world, jobs = MESHES[mesh]
    if mesh not in runs["loaded"]:
        ranks = [{} for _ in range(world)]
        for job in jobs:
            for merged, f in zip(ranks, _load(runs, world, job)):
                assert tuple(f["mesh"]) == mesh
                merged.update(f)
        runs["loaded"][mesh] = ranks
    for job in jobs:  # each test still fails on its own group's error
        _load(runs, world, job)
    return runs["loaded"][mesh]


def _mesh_cases(meshes):
    return [(m, c) for m in meshes for c in MESH_CASES[m]]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mesh,case", _mesh_cases([(1, 1), (1, 2)]))
def test_no_data_axis_is_the_unsharded_step_bitwise(runs, mesh, case):
    ref = runs["ref"][case]
    for f in _ranks(runs, mesh):
        for i, want in enumerate(ref["metrics"]):
            for k, v in want.items():
                assert f[f"{case}_step{i}_{k}"].tobytes() == v.tobytes(), (i, k)
        for part in ("params", "opt"):
            for k, v in ref[part].items():
                got = f[f"{case}_{part}::{k}"]
                assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), (part, k)


@pytest.mark.parametrize("mesh,case", _mesh_cases([(2, 1), (2, 2), (4, 1)]))
def test_data_axis_step1_within_rounding(runs, mesh, case):
    ref, f = runs["ref"][case], _ranks(runs, mesh)[0]
    want = float(ref["metrics"][0]["grad_norm"])
    assert abs(float(f[f"{case}_step0_grad_norm"]) - want) <= STEP1_GRAD_NORM_RTOL * want
    for part in ("params1", "opt1"):  # the moments: every gradient leaf, scaled
        worst = {k: _rel(f[f"{case}_{part}::{k}"], v) for k, v in ref[part].items()}
        assert max(worst.values()) <= STEP1_RTOL, (part, worst)


@pytest.mark.parametrize("mesh,case", [
    (m, c) for m, c in _mesh_cases([(2, 1), (2, 2), (4, 1)]) if c in DATA_AXIS_GAP])
def test_data_axis_within_its_stated_tolerance(runs, mesh, case):
    ref, ranks = runs["ref"][case], _ranks(runs, mesh)
    f = ranks[0]
    for r in ranks[1:]:  # every rank holds the same gathered params
        for k in ref["params"]:
            assert np.array_equal(r[f"{case}_params::{k}"], f[f"{case}_params::{k}"]), k
    assert f[f"{case}_step0_loss"].tobytes() == ref["metrics"][0]["loss"].tobytes()
    gap, witness = {}, {}
    for k, v in ref["params"].items():
        got, moved = f[f"{case}_params::{k}"], np.linalg.norm(v.astype(np.float64) - ref["params0"][k])
        if not moved:  # a leaf the step keeps (the clip buffers)
            assert np.array_equal(got, v), k
            continue
        got = got.astype(np.float64)
        gap[k] = np.linalg.norm(got - v) / moved
        witness[k] = np.linalg.norm(got - f[f"{case}_witness_params::{k}"]) / moved
    assert max(gap.values()) <= DATA_AXIS_GAP[case], gap
    assert max(gap.values()) > 0  # not bitwise: the partial sums' order shows
    # the unsharded step run on from the sharded step-1 state lands where
    # the sharded step does: the gap is step 1's rounding, grown by the
    # unsharded step itself
    assert max(witness.values()) <= WITNESS_GAP, witness
    # where the MoE's gap grows: its routing is the unsharded step's at step
    # 2 and flips at step 3, on the witness's rounding-size start
    for i in range(1, STEPS):
        want, route = ref[f"route{i}"], f[f"{case}_witness_route{i}"]
        flips = int((route != want).sum())
        assert flips == 0 if i < STEPS - 1 or CASES[case][0] == "dense" else flips > 0


@pytest.mark.parametrize("mesh,case", _mesh_cases([(1, 1), (1, 2), (2, 1), (2, 2), (4, 1)]))
def test_each_draw_is_a_slice_of_the_unsharded_draw(runs, mesh, case):
    want = runs["ref"][case]["draws"]
    seen = {}
    for f in _ranks(runs, mesh):
        for name, key, p, shape, offset, stride in json.loads(str(f[f"{case}_draws"])):
            assert want[tuple(key)][:2] == (name, p), (key, name)
            n = int(np.prod(shape))
            idx = np.arange(n)
            if stride is not None and stride != shape[-1]:
                idx = (idx // shape[-1]) * stride + idx % shape[-1]
            idx = idx + offset
            assert idx.min() >= 0 and idx.max() < want[tuple(key)][2], key
            seen.setdefault(tuple(key), set()).update(idx.tolist())
    if CASES[case][1].mode == "digital":
        assert not want and not seen
        return
    assert set(seen) == set(want)
    for key, (_, _, numel) in want.items():  # the ranks' slices cover every draw
        assert len(seen[key]) == numel, key


@pytest.mark.parametrize("mesh,case", _mesh_cases([(1, 1), (1, 2), (2, 1), (2, 2), (4, 1)]))
def test_step1_loss_and_per_token_loss_bitwise_and_gathers_exact(runs, mesh, case):
    ref = runs["ref"][case]
    for f in _ranks(runs, mesh):
        assert f[f"{case}_nll"].tobytes() == ref["nll"].tobytes()
        assert f[f"{case}_step0_loss"].tobytes() == ref["metrics"][0]["loss"].tobytes()
        assert bool(f[f"{case}_gather_exact"])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
def test_each_rank_holds_its_slice_and_a_step_repeats_bitwise(runs, mesh):
    d, m = mesh
    for f in _ranks(runs, mesh):
        assert bool(f["dense-analog_twice"])
        shapes = json.loads(str(f["dense-analog_shapes"]))
        blk = "blocks::0::{}::{}::w"
        # columns over model, rows over data (FSDP); w2's K of 128 at whole
        # tiles of 32 over model, its columns over data
        assert shapes[blk.format("attn", "wq")] == [2, 64 // d, 64 // m]
        assert shapes[blk.format("ffn", "w2")] == [2, 128 // m, 64 // d]
        assert shapes["embed::table"] == [256 // m, 64 // d]
        assert shapes["lm_head::w"] == [64 // d, 256 // m]
        if "moe-analog_shapes" in f:
            moe = json.loads(str(f["moe-analog_shapes"]))
            assert moe["blocks::0::moe::w1"] == [2, 4 // m, 64 // d, 128]


def test_reference_scenario_against_jax(runs):
    jref = runs["jax"]
    ranks = _load(runs, 4, "jax")
    f = ranks[0]
    losses = [float(f[f"step{i}_loss"]) for i in range(6)]
    for r in ranks[1:]:
        assert [float(r[f"step{i}_loss"]) for i in range(6)] == losses
    assert min(losses[1:]) < losses[0], losses
    assert abs(losses[-1] - jref["loss"][-1]) < 0.1, (losses, jref["loss"])
    assert losses[0] == pytest.approx(jref["loss"][0], rel=1e-4)
    assert float(f["step0_grad_norm"]) == pytest.approx(jref["grad_norm"], rel=1e-4)
    for k, v in jref["params"].items():
        got = f[f"step0_params::{k}"]
        if k == "embed::table":
            # one element's gradient nearly cancels (-1.8e-6 against 3.6e-2
            # typical); AdamW's first step scales it to about lr, so the
            # two frameworks' rounding of it moves that weight by 3.4e-3
            # (the port's unsharded step shows the same); every other
            # element within 1e-5
            assert (np.abs(got - v) > 1e-5).sum() <= 1, k
            continue
        assert _rel(got, v) <= 1e-4, k
    # a rank holds its slice of every tensor-parallel weight: the (2, 2)
    # mesh's FSDP x TP, the crossbar rule's whole tiles of 32 on w2 and wo
    local = json.loads(str(f["local"]))
    assert local == {"wq": [2, 32, 32], "wo": [2, 32, 32], "w2": [2, 64, 32],
                     "lm_head": [32, 128], "embed": [128, 32]}


def test_column_split_mvm_bitwise_at_one_thread(runs):
    ranks = _load(runs, 4, "hazard")
    for f in ranks:
        assert int(f["threads"]) == 1  # 8 asked for, the group pinned one
    f = ranks[0]
    assert set(f) == {"threads", "analog_m8"} | {f"digital_m{m}" for m in range(2, 9)}
    for k, v in f.items():
        if k != "threads":
            assert v.all(), (k, v)  # output, dx, dw, dr_adc


def test_autograd_operators_sums_and_sharded_updates(runs):
    for f in _load(runs, 2, "ops"):
        for k, v in f.items():
            assert np.asarray(v).all(), k


@pytest.mark.parametrize("sampler", ["bernoulli", "uniform"])
def test_sliced_draws_are_the_whole_draws_slices(sampler):
    key = prng.PRNGKey(11)
    draw = (lambda *a, **kw: prng.bernoulli(key, 0.3, *a, **kw)) if sampler == "bernoulli" \
        else (lambda *a, **kw: prng.uniform(key, *a, **kw))
    whole = draw((37, 23))
    assert torch.equal(draw((10, 23), offset=5 * 23), whole[5:15])
    assert torch.equal(draw((12, 9), offset=20 * 23 + 4, stride=23), whole[20:32, 4:13])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b", "paligemma-3b",
                                  "musicgen-large"])
def test_families_refuse_a_mesh(arch):
    """Every family takes a mesh (the step asks for its shardings next);
    the shard_map MoE dispatch still refuses one."""
    cfg = t_get_smoke(arch)
    with pytest.raises(ValueError, match="takes shardings="):
        tsteps.make_train_step(cfg, TRAIN, OPT, mesh=object())
    sm = dataclasses.replace(_cfg("moe"), moe_dispatch="shard_map")
    with pytest.raises(NotImplementedError, match="einsum MoE dispatch"):
        tsteps.make_train_step(sm, TRAIN, OPT, mesh=object(), shardings=())


def test_process_group_defaults_to_the_card():
    sig = inspect.signature(tmesh.init_process_group)
    assert sig.parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="init_process_group\\('cpu'\\) for gloo"):
        tmesh.make_host_mesh(2)
