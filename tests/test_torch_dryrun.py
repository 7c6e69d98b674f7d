"""The dry run (``repro_torch.launch.dryrun``) and its cost counter
(``repro_torch.analysis.cost``) on the CPU.

* The counter's FLOPs, bytes, op histogram and collectives over a fake
  trace of a one-rank step (a fake process group of one) equal its counts
  over a real CPU run of the same step (a gloo group of one), for train,
  prefill and decode in ``digital`` and ``analog_train``. Train and
  prefill trace the card's route (``kernels.build.card_trace``: B1, B3
  and the draws through their fake-tensor branches) against the CPU's
  plain versions: each dispatcher counts one unit whichever route runs.
  Decode traces the CPU's route, since on a card it runs B2's row code,
  which the CPU has no route to (phase 21 of ``chip_smoke.py`` holds the
  card's decode against its fake trace).
* At (1, 2) over gloo (two ``_torch_dist_worker.py`` processes, the
  ``cost`` job), a real sharded train step's collective calls, operand and
  wire bytes -- and its FLOPs, bytes and ops -- equal the fake trace's over
  a fake group of the same layout.
* The per-rank argument bytes of a smoke dense decode cell at 16x16 are
  the reference's ``run_cell`` ``memory.argument_bytes`` (run in a
  subprocess: its module forces 512 host devices at import; its meshes are
  made with Auto axes there, without which this JAX refuses its sharding
  constraints) but for the two differences named leaf by leaf: the key
  (the port's int64 pair, the reference's uint32 pair) and the KV cache
  (the port's cache holds the KV heads a rank's attention runs -- all of
  them where the model degree does not divide them -- over its whole
  sequence; the reference's splits the sequence over ``model``).
* A real CPU tensor passed to each kernel wrapper takes its plain route
  as before, with a card trace on or off: the fake-tensor branches fire
  only on fake tensors.
* A fake trace replays each emulated operation of ``prng`` after its
  first run of a signature (``cost.memoized``); the replays count the
  FLOPs, bytes, ops and peak that a real run of the same calls counts.
* No process group is left behind, by a cell that passes or one that
  fails.

~25 s alone (the workers and the reference's subprocess run beside the
in-process traces).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.analysis import cost
from repro_torch.configs import get_smoke
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.kernels import analog_mvm as kernel
from repro_torch.kernels import build, decode_rows, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
TIMEOUT = 60
CFG = get_smoke("tinyllama-1.1b")
COST_CELL = ShapeCell("train", 16, 4, "train")  # the worker's cost job's


def _env():
    return {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1",
            "JAX_PLATFORMS": "cpu"}


def _counts(mesh, cell, mode) -> dict:
    c = dryrun.prepare(CFG, cell, mesh, mode, device="cpu")
    with cost.count() as counter:
        c.step(*c.args)
    return {**counter.summary(), "argument_bytes": c.argument_bytes}


def _fake_counts(layout, cell, mode, card: bool) -> dict:
    with dryrun.fake_group(layout) as mesh, FakeTensorMode(), build.card_trace(card):
        return _counts(mesh, cell, mode)


def _same(real: dict, fake: dict) -> None:
    for key in ("flops", "bytes", "ops", "collectives", "wire_bytes", "argument_bytes"):
        assert real[key] == fake[key], key


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """The (1, 2) gloo group's ``cost`` job, started first, read last."""
    out = str(tmp_path_factory.mktemp("cost"))
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", os.path.join(out, "store"),
                               out, "cost"], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    yield out, procs
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run_cell on the smoke dense decode_32k cell at
    16x16, and each argument leaf's per-device bytes, from a subprocess."""
    out = str(tmp_path_factory.mktemp("ref") / "ref.json")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, out], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield out, proc
    proc.kill()


REF_SCRIPT = r"""
import json, sys
from repro.launch import dryrun  # forces 512 host devices first
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec
make = jax.make_mesh
jax.make_mesh = lambda shape, axes, **kw: make(shape, axes,
                                              axis_types=(AxisType.Auto,) * len(axes), **kw)
import jax.numpy as jnp
import numpy as np
from repro import configs
from repro.configs import shapes
from repro.launch import sharding as shd
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import make_serve_step
from repro.models.common import set_logical_rules
from repro.models.lm import lm_init

cfg = configs.get("tinyllama-1.1b").smoke()
rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", False, "digital", verbose=False,
                      override_cfg=cfg)
# run_cell's decode step again, to read which arguments its jit keeps
mesh = make_production_mesh()
set_logical_rules(shd.logical_rules(mesh, cfg, "2d"))
params = jax.eval_shape(lambda k: lm_init(k, cfg), jax.ShapeDtypeStruct((2,), jnp.uint32))
params = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, jnp.bfloat16)
                      if x.dtype == jnp.float32 and len(x.shape) >= 2 else x, params)
specs = shapes.input_specs(cfg, "decode_32k")
key = jax.ShapeDtypeStruct((2,), jnp.uint32)
rep = NamedSharding(mesh, PartitionSpec())
sh = (shd.param_shardings(params, mesh, cfg, inference=True),
      shd.batch_shardings(specs["batch"], mesh), shd.cache_shardings(specs["cache"], mesh, 128),
      rep)
args = (params, specs["batch"], specs["cache"], key)
jitted = jax.jit(make_serve_step(cfg, dryrun.analog_config("digital")), in_shardings=sh,
                 out_shardings=(NamedSharding(mesh, PartitionSpec(shd.batch_axis(mesh, 128))),
                                sh[2]), donate_argnums=(2,))
with mesh:
    kept = jitted.lower(*args)._lowering.compile_args["kept_var_idx"]
leaves = [int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
          for x, s in zip(jax.tree.leaves(args), jax.tree.leaves(sh))]
json.dump({"status": rec["status"], "error": rec.get("error"), "leaves": leaves,
           "kept": sorted(kept), "sizes": [len(jax.tree.leaves(a)) for a in args],
           "argument_bytes": rec.get("memory", {}).get("argument_bytes")},
          open(sys.argv[1], "w"))
"""


@pytest.mark.parametrize("mode", ["digital", "analog_train"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_trace_counts_equal_a_real_cpu_run(tmp_path, kind, mode):
    cell = ShapeCell(kind, 16, 2, kind)
    layout = mesh_lib.MeshLayout(("data", "model"), (1, 1))
    fake = _fake_counts(layout, cell, mode, card=kind != "decode")
    mesh_lib.init_process_group("cpu", store=dist.FileStore(str(tmp_path / "store"), 1),
                                rank=0, world_size=1, timeout_s=TIMEOUT)
    try:
        real = _counts(mesh_lib.make_host_mesh(1), cell, mode)
    finally:
        dist.destroy_process_group()
    _same(real, fake)
    assert fake["flops"] > 0 and fake["bytes"] > 0
    if kind != "decode":  # prefill attention through B3's dispatcher
        assert fake["ops"]["B3"] == CFG.n_layers
    if mode == "analog_train":  # every analog MVM through B1's
        assert fake["ops"]["B1"] >= 7 * CFG.n_layers


def test_sharded_train_collectives_equal_the_fake_trace(workers):
    out, procs = workers
    layout = mesh_lib.MeshLayout(("data", "model"), (1, 2))
    fakes = {mode: _fake_counts(layout, COST_CELL, mode, card=True)
             for mode in ("digital", "analog_train")}
    logs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    for r in range(2):
        got = np.load(os.path.join(out, f"cost.rank{r}.npz"))
        for mode, fake in fakes.items():
            real = json.loads(str(got[mode]))
            _same(real, fake)
            assert set(real["collectives"]) == {"all-gather"} and real["wire_bytes"] > 0


def _rank_leaves(mesh) -> tuple:
    """The port's per-rank argument bytes of the reference's cell, leaf by
    leaf in the reference's argument order (params, batch, cache, key), the
    leaves' count of each argument, and the total."""
    c = dryrun.prepare(CFG, SHAPES["decode_32k"], mesh, "digital", device="cpu")
    params, batch, cache, rng = c.args
    nb = lambda tree: [cost.nbytes(t) for t in tree_lib.leaves(tree)]  # noqa: E731
    parts = (nb(params), [cost.nbytes(batch["tokens"]) // 16], nb(cache), nb(rng))
    return [b for p in parts for b in p], [len(p) for p in parts], c.argument_bytes


def test_argument_bytes_are_the_references_but_the_named_leaves(reference):
    with dryrun.fake_group(dryrun.mesh_layout("")) as mesh, FakeTensorMode(), \
            build.card_trace():
        got, sizes, total = _rank_leaves(mesh)
    out, proc = reference
    log = proc.communicate(timeout=240)[0].decode()
    assert proc.returncode == 0, log[-3000:]
    ref = json.load(open(out))
    assert ref["status"] == "ok", ref["error"]
    want, kept = ref["leaves"], set(ref["kept"])
    assert sizes == ref["sizes"] and len(got) == len(want)
    # the reference's jit prunes the arguments its step does not read (and
    # XLA counts only the kept ones); the port's step is handed them all
    assert sum(want[i] for i in kept) == ref["argument_bytes"]
    n_params, n_batch, n_cache, _ = sizes
    cache = range(n_params + n_batch, n_params + n_batch + n_cache)
    key = len(got) - 1
    pruned = [i for i in range(len(got)) if i not in kept]
    # named: the key -- unread by a digital step, an int64 pair in the port
    assert key in pruned and got[key] == 16 and want[key] == 8
    # named: the clip buffers and ADC ranges a digital forward does not read
    assert all(i < n_params and got[i] == want[i] <= 8 for i in pruned if i != key)
    # every other param leaf and the batch: the reference's bytes
    for i in kept:
        if i not in cache:
            assert got[i] == want[i], i
    # named: each K and V leaf (2 KV heads the 16 model ranks do not
    # divide: every rank holds both over the whole sequence, where the
    # reference holds a 16th of the sequence); the lengths are the same
    for i in cache:
        assert got[i] == want[i] or got[i] == 16 * want[i], i
    diff = sum(got[i] for i in pruned) + sum(got[i] - want[i] for i in cache)
    assert total == ref["argument_bytes"] + diff


def test_real_cpu_tensors_take_the_plain_route(monkeypatch):
    """With the card trace on or off, a real CPU tensor runs each
    wrapper's plain version, bitwise, and no fake branch or launch."""
    def refuse(*a, **k):
        raise AssertionError("a fake-tensor branch ran on a real tensor")

    monkeypatch.setattr(kernel, "_fake_launch", refuse)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((3, 64)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((64, 8)), dtype=torch.float32)
    q = torch.as_tensor(rng.standard_normal((1, 6, 2, 16)), dtype=torch.float32)
    qd, kd = q[:, :1].clone(), q[:, 1:2].clone()
    cache = torch.as_tensor(rng.standard_normal((1, 6, 2, 16)), dtype=torch.float32)
    one = torch.tensor(1.0)
    launches = (kernel.analog_mvm.launches, flash_attention.launches,
                dict(decode_rows.launches), prng.launches)
    outs = []
    for card in (False, True):
        with build.card_trace(card):
            assert not build.on_card(x) and not build.is_fake(x)
            outs.append([
                ops.analog_mvm(x, w, r_adc=one, r_dac=one, bits=8, tile_rows=32),
                flash_attention(q, q, q, causal=True, q_chunk=2, kv_chunk=4),
                decode_rows.norm(x, None, 1e-5),
                *decode_rows.rope(qd, kd, torch.tensor([3]), 10000.0),
                decode_rows.attention(qd, cache, cache, torch.tensor([4])),
                decode_rows.gate(x, x),
                prng.normal(prng.PRNGKey(1), (4, 5)),
            ])
            with pytest.raises(ValueError, match="CUDA"):
                kernel.analog_mvm(x, w, r_adc=one)
    want = [
        ref.analog_mvm_ref(x, w, one, one, 1.0, b_dac=9, b_adc=8, tile_rows=32,
                           per_tile_adc=True, apply_dac=True),
        ref.flash_attention_ref(q, q, q, True, q_chunk=2, kv_chunk=4),
        decode_rows.norm_plain(x, None, 1e-5),
        *decode_rows.rope_plain(qd, kd, torch.tensor([3]), 10000.0),
        decode_rows.attention_plain(qd, cache, cache, torch.tensor([4])),
        decode_rows.gate_plain(x, x),
        prng.normal_erf_inv(prng.PRNGKey(1), (4, 5)) * prng.SQRT2,
    ]
    for got in outs:
        for g, v in zip(got, want):
            assert torch.equal(g, v)
    assert launches == (kernel.analog_mvm.launches, flash_attention.launches,
                        dict(decode_rows.launches), prng.launches)


def _emulations(make) -> cost.Counter:
    """Two calls each of ``prng``'s emulated operations on operands from
    ``make(shape, dtype)``, counted, every output kept (so a later call's
    peak starts above an earlier one's)."""
    x, y = make((48, 40), torch.float32), make((48, 40), torch.float32)
    k, c = make((), torch.int64), make((48, 40), torch.int64)
    with cost.count() as counter:
        kept = [f() for _ in range(2) for f in (lambda: prng.powf(x, y),
                                                lambda: prng.fma(x, y, 0.5),
                                                lambda: prng.threefry2x32(k, k, c, c))]
    assert len(kept) == 6
    return counter


def test_a_replayed_emulation_counts_what_a_real_run_does():
    """A fake trace runs each emulated operation once a signature and
    replays it (``cost.memoized``): its FLOPs, bytes, ops and peak equal a
    real CPU run's, which replays nothing."""
    rng = np.random.default_rng(0)
    real = _emulations(lambda shape, dt: torch.as_tensor(
        rng.uniform(0.5, 2.0, shape) if dt.is_floating_point else rng.integers(0, 2**32, shape),
        dtype=dt))
    assert not real._memo
    with FakeTensorMode():
        fake = _emulations(lambda shape, dt: torch.empty(shape, dtype=dt))
    assert len(fake._memo) == 3 and all(fake._memo.values())
    for key in ("flops", "bytes", "ops", "peak_bytes"):
        assert real.summary()[key] == fake.summary()[key], key


def test_no_process_group_is_left_behind():
    cell = ShapeCell("decode", 8, 2, "decode")
    ok = dryrun.run_cell("tinyllama-1.1b", "decode", False, "digital", verbose=False,
                         override_cfg=CFG, cell=cell, mesh="1x2")
    assert ok["status"] == "ok" and not dist.is_initialized()
    bad = dryrun.run_cell("tinyllama-1.1b", "decode", False, "no-such-mode", verbose=False,
                          override_cfg=CFG, cell=cell, mesh="1x2")
    assert bad["status"] == "fail" and "no-such-mode" in bad["error"]
    assert not dist.is_initialized()
