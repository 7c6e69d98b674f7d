"""Sharded programming and serving of the port over gloo, against JAX's
host chip (``compile_program`` without a mesh).

The reference's own mesh-programmed chip is not bitwise its host chip
(``tests/test_drift_lifecycle.py::test_drift_transitivity_bit_exact_sharded``
fails on this tree), so every sharded result here is held against the
host chip. The ranks run in processes of their own
(``tests/_torch_dist_worker.py``, torch only), 2 and 4 of them, joined by a
``FileStore`` under the test's temporary directory; every group has a
60 s timeout on the process group and on its processes, so a hang fails
one test (the one JAX process that runs the reference's shard_map, no
group, has 240 s). The chips are programmed at ``tile_rows=32``: the smoke widths'
K of 64 and 128 span 2 and 4 crossbar tiles, so row-parallel layers
really split (at 4 ranks ``wo``'s 2 tiles are fewer than the ranks and it
runs column-parallel on the gathered input, and the KV heads, 2, are
replicated).

* The sharded program phase, its 30-day drift and a refresh, saved by the
  port (gathered, rank 0 writes) and loaded by JAX: bitwise JAX's host
  chip, for tinyllama's smoke config and the MoE smoke of
  ``tests/test_sharded_program.py``.
* The forward's logits at M = 16 bitwise the unsharded chip's and JAX's,
  also with the read noise redrawn per MVM (each rank its slice of every
  draw).
  At M = 1 they are held to the ADC tolerance model of
  ``tests/test_kernels.py`` and the same greedy token, not bitwise:
  torch's fp32 ``x @ w[:, cols]`` on the CPU is bitwise the full
  product's columns at M = 8, 64 and 256 but not at M = 1 (a GEMV route;
  measured at K = 1024 and 2048 over 2 and 4 column slices), a known
  property of the library, not a port fault. (At these widths it happens
  to be bitwise.)
* Greedy tokens through ``ServingEngine(mesh=)``, slot and paged, of JAX's
  saved host chip loaded with ``load_program(shardings=)``, and of a data
  axis of 2: JAX's host-chip serving's.
* shard_map MoE against the port's einsum ``moe_apply`` at capacity
  factor 8 (no drops; the reference's bar, rtol 1e-4 / atol 1e-5), and at
  1.25 (its local capacity drops other tokens than the einsum path's
  per-group one) against the reference's ``moe_apply_shardmap`` on a
  fake-device mesh in a JAX subprocess.
* The other families: mamba2-2.7b, recurrentgemma-9b, paligemma-3b and
  musicgen-large at their smoke configs over 2 ranks (recurrentgemma and
  paligemma also over 4: one KV head over 4 ``model`` ranks, replicated),
  each a job of the groups above (``GROUPS``): the sharded chip, aged and
  refreshed, bitwise JAX's host chip of the same params; the logits
  bitwise the port's host chip's; the sharded chip's greedy tokens JAX's
  host chip's -- the recurrent families through the engine, paligemma's
  requests each with its own patches, musicgen's (B, 4) codes through the
  step makers.
* AnalogNet-KWS's depthwise bench config programmed with ``shardings=``,
  its crossbar transforms and its mapping (``tests/test_sharded_program.py``'s
  scenario) over 2 ranks: chip, mapping and logits the unsharded chip's,
  which is JAX's; an LM's transformed layer programs whole, the rest split.
* Per-call PCM inference (``pcm_infer``) on a rank's shards at (1, 2)
  and (2, 2), the dense and MoE smoke configs (the ``pcminfer`` group,
  ~15 s alone): the forward bitwise the unsharded one, and the sharded
  step makers' greedy tokens JAX's host ``pcm_infer`` tokens.
* ``--mesh-model 2`` over 2 processes prints the reference CLI's tokens;
  the refusals that stay (fused decode, paged recurrent serving), and
  that no float crosses ranks in an ``all_reduce``.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro import clock as jclock
from repro import serving as jserving
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import ModelConfig as JModelConfig
from repro.models import analognet as janalognet
from repro.models import lm as jlm
from repro_torch import collectives
from repro_torch import prng
from repro_torch import serving as tserving
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.core import engine as tengine
from repro_torch.core.analog import AnalogConfig as TAnalogConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm

from test_torch_traces import numpy_trace

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
TIMEOUT = 60  # seconds: a group's processes and its process group
#: the reference's shard_map runs in ONE JAX process (fake devices, no
#: process group to hang): its imports and two jit compiles took 18-25 s
#: alone and past 60 s beside the suite's other workers
JAX_TIMEOUT = 240
JINFER = JAnalogConfig(tile_rows=32).infer(b_adc=8, t_seconds=86400.0)
SEP = "::"
CLI = ["--analog", "--batch", "2", "--prompt-len", "8", "--tokens", "6"]


#: each world's worker groups, one after another: the other families' jobs
#: ride along the earlier groups at 2 ranks and take one more group at 4
#: (the families with a single KV head); the first groups start beside
#: this process's JAX work and the suite's other files, so they are the
#: lightest
GROUPS = {2: ("chips-dense,fam-mamba2,fam-musicgen", "chips-moe", "forward-dense,fam-pali",
              "forward-moe", "shardmap", "serve,cnn,fam-rgemma", "pcminfer"),
          4: ("chips-dense", "chips-moe", "forward-dense", "forward-moe", "shardmap",
              "serve,fam-pali", "fam-rgemma", "pcminfer")}
FAM_WORLDS = {"mamba2": (2,), "rgemma": (2, 4), "pali": (2, 4), "musicgen": (2,)}
#: the worker's (``_torch_dist_worker.py``) family names, and its audio
#: rectangle: rows, prompt frames, greedy steps
FAMILIES = {"mamba2": "mamba2-2.7b", "rgemma": "recurrentgemma-9b", "pali": "paligemma-3b",
            "musicgen": "musicgen-large"}
CODEBOOK = (2, 6, 3)
#: the worker's ``pcminfer`` rectangle (rows, prompt tokens, greedy steps)
INFER_RECT = (2, 8, 3)


def fam_inputs(cfg, seed: int, b: int, s: int) -> dict:
    """The worker's ``fam_inputs``: frames for the audio family, else
    tokens (and image patches for the vision family), as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _jcfg(name):
    if name == "dense":
        return j_get_smoke("tinyllama-1.1b")
    if name in FAMILIES:
        return j_get_smoke(FAMILIES[name])
    return JModelConfig(name="t", family="moe", n_layers=2, n_experts=8, top_k=2).smoke()


def _to_jax(tree):
    """The port's param tree as the reference's, leaf for leaf, each dict
    in its own order (the program walk's)."""
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return jlm.LMParams(*(_to_jax(getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_jax(v) for v in tree)
    return tree


def _job_of(world: int, job: str) -> str:
    """The group string that runs ``job`` at ``world`` ranks."""
    return next(g for g in GROUPS[world] if job in g.split(","))


def _jax_codes(host, jcfg) -> np.ndarray:
    """The reference's step makers' (steps, B, C) greedy codes on ``host``
    over the worker's frames (``CODEBOOK``)."""
    b, s, n = CODEBOOK
    frames = jnp.asarray(fam_inputs(jcfg, 6, b, s + n)["frames"])
    cache = jlm.init_lm_cache(jcfg, b, s + n, jnp.float32)
    logits, cache = jsteps.make_prefill_step(jcfg, host.cfg)(
        host.params, {"frames": frames[:, :s]}, cache, jax.random.PRNGKey(3))
    codes = [np.asarray(logits[:, -1].argmax(-1)).astype(np.int32)]
    step = jax.jit(jsteps.make_serve_step(jcfg, host.cfg))
    for i in range(n):
        got, cache = step(host.params, {"frames": frames[:, s + i:s + i + 1]}, cache,
                          jax.random.PRNGKey(4))
        codes.append(np.asarray(got))
    return np.stack(codes)


def _jax_families(ref: dict) -> None:
    """JAX's host chips of the families (the port's params, which are the
    reference's but mamba2's ``dt_bias``: torch's exp), aged and refreshed,
    and their greedy tokens on the worker's requests (``fam_requests``),
    musicgen's codes through the reference's step makers; and
    AnalogNet-KWS's depthwise bench chip with its transforms and mapping."""
    from benchmarks.common import KWS_BENCH_DW as J_KWS_BENCH_DW
    from repro_torch.models import lm as tlm

    for name, arch in FAMILIES.items():
        jcfg = _jcfg(name)
        jp = _to_jax(tlm.lm_init(prng.PRNGKey(0), t_get_smoke(arch), device="cpu"))
        host = jengine.compile_program(jp, JINFER, jax.random.PRNGKey(1))
        out = {"jp": jp, "prog": host, "aged": jengine.age_program(host, 30 * 86400.0),
               "fresh": jsteps.refresh_program(host, jp,
                                               jax.random.fold_in(jax.random.PRNGKey(43), 1))}
        if jcfg.n_codebooks:
            out["codes"] = _jax_codes(host, jcfg)
        else:
            if jcfg.frontend == "vision_patches":
                batch = fam_inputs(jcfg, 4, 2, 9)
                reqs = [jserving.Request(rid=i, prompt=batch["tokens"][i], max_new_tokens=4,
                                         features={"patches": jnp.asarray(
                                             batch["patches"][i:i + 1])}) for i in range(2)]
            else:
                reqs = [_jreq(r) for r in numpy_trace(2, 3, vocab=jcfg.vocab, rate=400.0,
                                                      prompt_lens=(9, 16), new_tokens=(3, 8))]
            rep = jserving.ServingEngine.for_program(
                host, jcfg, jserving.ServingConfig(n_slots=2, s_max=48),
            ).run(reqs, clock=jclock.VirtualClock())
            out["tokens"] = {r.rid: rep.tokens_of(r.rid) for r in reqs}
        ref[name] = out
    jp = janalognet.cnn_init(jax.random.PRNGKey(0), J_KWS_BENCH_DW)
    ref["cnn"] = jengine.compile_program(
        jp, JINFER, jax.random.PRNGKey(1),
        transforms=janalognet.crossbar_transforms(J_KWS_BENCH_DW), with_mapping=True)


def _jax_infer_tokens(jparams) -> dict:
    """JAX's host ``pcm_infer`` greedy tokens through the reference's step
    makers, eagerly, on the worker's ``pcminfer`` prompts and keys."""
    b, s, n = INFER_RECT
    out = {}
    for name in ("dense", "moe"):
        jcfg = _jcfg(name)
        toks = np.random.default_rng(21).integers(0, jcfg.vocab, size=(b, s)).astype(np.int32)
        cache = jlm.init_lm_cache(jcfg, b, s + n, jnp.float32)
        logits, cache = jsteps.make_prefill_step(jcfg, JINFER)(
            jparams[name], {"tokens": jnp.asarray(toks)}, cache, jax.random.PRNGKey(3))
        got = [np.asarray(logits[:, -1].argmax(-1)).astype(np.int32)]
        step = jsteps.make_serve_step(jcfg, JINFER)
        for i in range(n - 1):
            nxt, cache = step(jparams[name], {"tokens": jnp.asarray(got[-1])[:, None]}, cache,
                              jax.random.fold_in(jax.random.PRNGKey(4), i))
            got.append(np.asarray(nxt))
        out[name] = np.stack(got, axis=1)
    return out


def _env():
    return {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1",
            "JAX_PLATFORMS": "cpu"}


def _group(world: int, out: str, jobs: str, artifact: str = "") -> str:
    """Run ``world`` worker ranks of ``jobs``; '' or the failure's output.
    With ``TORCH_DIST_GROUP_LOG`` set to a file, each group's wall seconds
    are appended to it (how far a group stays inside its timeout)."""
    t0 = time.perf_counter()
    err = _run_group(world, out, jobs, artifact)
    log = os.environ.get("TORCH_DIST_GROUP_LOG")
    if log:
        with open(log, "a") as f:
            f.write(f"{world} {jobs} {time.perf_counter() - t0:.1f} {'failed' if err else 'ok'}\n")
    return err


def _run_group(world: int, out: str, jobs: str, artifact: str) -> str:
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, f"store_{jobs.replace(',', '_')}")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), store, out, jobs]
        + ([artifact] if artifact else []),
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TIMEOUT)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            return f"{jobs} at {world} ranks: timed out after {TIMEOUT} s"
    bad = [log for p, log in zip(procs, logs) if p.returncode]
    return f"{jobs} at {world} ranks failed:\n" + bad[0][-3000:] if bad else ""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_ranks(out: str) -> tuple:
    """``--mesh-model 2`` over 2 processes as torchrun starts them."""
    env = {**_env(), "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", *CLI,
         "--mesh-model", "2"],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(2)]
    try:
        res = [p.communicate(timeout=TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        return None, "timed out"
    return [r[0].decode() for r in res], "".join(
        r[1].decode()[-2000:] for p, r in zip(procs, res) if p.returncode)


def _jax_shardmap(bank_npz: str, out: str) -> str:
    """The reference's ``moe_apply_shardmap`` over ``model`` degrees 2 and 4
    of fake devices: ``out % n`` holds each; '' or the failure."""
    script = f"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {os.path.join(REPO, 'src')!r})
import dataclasses, jax, numpy as np, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.analog import AnalogConfig, AnalogCtx
from repro.models import ModelConfig
from repro.models.moe_shardmap import moe_apply_shardmap
d = np.load({bank_npz!r})
cfg = dataclasses.replace(ModelConfig(name="t", family="moe", n_layers=2, n_experts=8,
                                      top_k=2).smoke(), capacity_factor=float(d["cf"]))
bank = {{k: jnp.asarray(d[k]) for k in ("w1", "w3", "w2", "r_adc", "w_clip_buf",
                                        "out_scale_buf")}}
bank["router"] = {{"w": jnp.asarray(d["router"])}}
acfg = dataclasses.replace(AnalogConfig(tile_rows=32).infer(b_adc=8), mode="pcm_programmed")
ctx = AnalogCtx(cfg=acfg, gain_s=jnp.asarray(d["gain_s"]))
for n in (2, 4):
    with Mesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model")):
        np.save({out!r} % n, np.asarray(moe_apply_shardmap(bank, jnp.asarray(d["x"]), ctx, cfg)))
"""
    try:
        p = subprocess.run([sys.executable, "-c", script], env=_env(), capture_output=True,
                           timeout=JAX_TIMEOUT)
    except subprocess.TimeoutExpired:
        return "timed out"
    return p.stderr.decode()[-3000:] if p.returncode else ""


def _shardmap_x() -> np.ndarray:
    """The tokens the worker's ``shardmap`` job feeds its capacity-dropping
    case (its third draw from ``default_rng(11)``)."""
    rng = np.random.default_rng(11)
    rng.standard_normal((2, 8, 64))
    rng.integers(0, 256, size=(2, 8))
    return rng.standard_normal((2, 8, 64)).astype(np.float32)


def _jreq(r):
    return jserving.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                            arrival_t=r.arrival_t)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    jparams = {n: jlm.lm_init(jax.random.PRNGKey(0), _jcfg(n)) for n in ("dense", "moe")}
    serve_chip = jengine.compile_program(jparams["dense"], JINFER, jax.random.PRNGKey(42))
    artifact = os.path.join(root, "jax_chip")
    jstore.save_program(artifact, serve_chip)
    moe_chip = jengine.compile_program(jparams["moe"], JINFER, jax.random.PRNGKey(1))
    bank = jax.tree.map(lambda a: np.asarray(a[0]), moe_chip.params.blocks[0]["moe"])
    bank = dict(cf=1.25, router=bank["router"]["w"], gain_s=np.asarray(moe_chip.params.gain_s),
                **{k: bank[k] for k in ("w1", "w3", "w2", "r_adc", "w_clip_buf", "out_scale_buf")})
    errors, cli = {}, {}

    def ranks(world):
        out = os.path.join(root, f"w{world}")
        for jobs in GROUPS[world]:
            errors[(world, jobs)] = _group(world, out, jobs,
                                           artifact if "serve" in jobs.split(",") else "")

    def cli_run():
        cli["out"], cli["err"] = _cli_ranks(root)

    def jax_run():  # the reference's shard_map on the same bank and tokens
        npz = os.path.join(root, "bank.npz")
        np.savez(npz, x=_shardmap_x(), **bank)
        errors["jax"] = _jax_shardmap(npz, os.path.join(root, "jax_y%d.npy"))

    threads = [threading.Thread(target=ranks, args=(w,)) for w in (2, 4)]
    threads += [threading.Thread(target=cli_run), threading.Thread(target=jax_run)]
    for t in threads:
        t.start()
    # meanwhile, JAX's host chips, their ages and refreshes, and serving
    ref = {}
    for name in ("dense", "moe"):
        host = moe_chip if name == "moe" else jengine.compile_program(
            jparams[name], JINFER, jax.random.PRNGKey(1))
        ref[name] = {"prog": host, "aged": jengine.age_program(host, 30 * 86400.0),
                     "fresh": jsteps.refresh_program(host, jparams[name],
                                                     jax.random.fold_in(jax.random.PRNGKey(43), 1))}
    trace = numpy_trace(1, 7, vocab=256, rate=400.0, prompt_lens=(4, 9, 16, 23, 33),
                        new_tokens=(3, 10))
    jtokens = {}
    for paged in (False, True):
        kw = dict(n_slots=3, s_max=48)
        if paged:
            kw.update(paged=True, page_size=5, prefill_batch=2)
        rep = jserving.ServingEngine.for_program(
            serve_chip, _jcfg("dense"), jserving.ServingConfig(**kw),
        ).run([_jreq(r) for r in trace], scheduler=jserving.BucketedScheduler() if paged else None,
              clock=jclock.VirtualClock())
        jtokens["paged" if paged else "slot"] = {r.rid: rep.tokens_of(r.rid) for r in trace}
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["serve", *CLI]
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = argv
    # JAX's programming-event counter is global: the families' chips are
    # programmed after the serving above, not beside it
    fam = {}
    _jax_families(fam)
    infer = _jax_infer_tokens(jparams)
    for t in threads:
        t.join()
    return dict(root=root, errors=errors, ref=ref, trace=trace, jtokens=jtokens,
                jcli=buf.getvalue(), cli=cli, jparams=jparams, fam=fam, infer=infer)


def _ok(runs, world, jobs):
    err = runs["errors"][(world, _job_of(world, jobs))]
    assert not err, err


def _load(runs, world, job):
    out = os.path.join(runs["root"], f"w{world}")
    return [dict(np.load(os.path.join(out, f"{job}.rank{r}.npz"))) for r in range(world)]


def _bitwise(jtree, ktree):
    want, got = jstore._flatten(jtree), jstore._flatten(ktree)
    assert set(want) == set(got)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == np.asarray(w).tobytes(), f"{k}: {(g != w).sum()} of {w.size} differ"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_sharded_chip_aged_and_refreshed_are_the_host_chip(runs, world, name):
    _ok(runs, world, f"chips-{name}")
    out = os.path.join(runs["root"], f"w{world}")
    for stage in ("prog", "aged", "fresh"):
        loaded = jstore.load_program(os.path.join(out, f"{name}_{stage}"))
        want = runs["ref"][name][stage]
        _bitwise(want.params, loaded.params)
        _bitwise(want.state, loaded.state)
        assert loaded.t_seconds == want.t_seconds and loaded.age_history == want.age_history


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_sharded_pcm_infer_forward_is_the_unsharded_one(runs, world, name):
    """Per-call PCM inference on a rank's shards at (1, 2) and (2, 2): every
    draw its slice of the whole layer's, the weight scale and the GDC the
    layer's, the row-parallel partials summed in tile order -- the logits
    bitwise the unsharded forward's on every rank."""
    _ok(runs, world, "pcminfer")
    for r in _load(runs, world, "pcminfer"):
        assert r[f"{name}_logits"].tobytes() == r[f"{name}_host"].tobytes()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_sharded_pcm_infer_steps_give_jax_tokens(runs, world, name):
    """The sharded prefill and serve steps (``mesh=``; at (2, 2) each data
    rank its row, gathered) give JAX's host ``pcm_infer`` greedy tokens."""
    _ok(runs, world, "pcminfer")
    for r in _load(runs, world, "pcminfer"):
        assert np.array_equal(r[f"{name}_tokens"], runs["infer"][name])


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_shard(runs, world):
    for name in ("dense", "moe"):
        _ok(runs, world, f"chips-{name}")
    dense, moe = (json.loads(str(_load(runs, world, f"chips-{name}")[0]["shapes"]))[name]
                  for name in ("dense", "moe"))
    n = world
    assert dense["wq"] == [2, 64, 64 // n]  # columns: heads
    assert dense["embed"] == [256 // n, 64] and dense["lm_head"] == [64, 256 // n]
    assert dense["w2"] == [2, 128 // n, 64]  # rows: whole crossbar tiles of 32
    # wo's K of 64 is 2 tiles: split as rows over 2 ranks, as columns over 4
    assert dense["wo"] == ([2, 32, 64] if n == 2 else [2, 64, 16])
    assert moe["bank_w1"] == [2, 4 // n, 64, 128]  # the rank's experts


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_sharded_logits_are_the_host_chips(runs, world, name):
    _ok(runs, world, f"chips-{name}")
    _ok(runs, world, f"forward-{name}")
    ranks = _load(runs, world, f"forward-{name}")
    loaded = jstore.load_program(os.path.join(runs["root"], f"w{world}", f"{name}_prog"),
                                 params_like=runs["jparams"][name])
    for r in ranks[1:]:  # every rank holds the whole logits
        for k in ranks[0]:
            assert np.array_equal(r[k], ranks[0][k]), k
    f = ranks[0]
    # M = 16: bitwise the unsharded chip and JAX's (the sharded chip JAX loaded)
    got = f[f"{name}_m16"]
    assert got.tobytes() == f[f"{name}_m16_host"].tobytes()
    jlogits, _ = jlm.lm_forward(loaded.params, {"tokens": f[f"{name}_m16_tokens"]},
                                loaded.cfg, _jcfg(name))
    assert got.tobytes() == np.asarray(jlogits).tobytes()
    # the read noise redrawn per MVM: each rank's slice of every draw
    assert f[f"{name}_resample"].tobytes() == f[f"{name}_resample_host"].tobytes()
    assert not np.array_equal(f[f"{name}_resample"], f[f"{name}_m16"])
    # M = 1: the ADC tolerance model (one step a row tile of the lm_head,
    # fewer than 1% of the logits more than half a step off) and the token
    got, host = f[f"{name}_m1"], f[f"{name}_m1_host"]
    step = 1.0 / 127 * float(np.asarray(loaded.params.lm_head["out_scale_buf"]))
    diff = np.abs(got - host)
    assert diff.max() <= 2 * step + 1e-6
    assert (diff > step / 2).mean() < 0.01
    assert np.array_equal(got.argmax(-1), host.argmax(-1))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_serving_gives_the_host_chips_tokens(runs, world):
    _ok(runs, world, "serve")
    ranks = _load(runs, world, "serve")
    for r in ranks[1:]:
        for k in ranks[0]:
            assert np.array_equal(r[k], ranks[0][k]), k
    got = ranks[0]
    kinds = ["slot", "paged", "loaded"] + (["data"] if world == 2 else [])
    for kind in kinds:
        want = runs["jtokens"]["paged" if kind == "paged" else "slot"]
        for r in runs["trace"]:
            assert np.array_equal(got[f"{kind}_rid{r.rid}"], want[r.rid]), (kind, r.rid)


@pytest.mark.parametrize("world", [2, 4])
def test_shardmap_moe_meets_einsum_and_the_reference(runs, world):
    _ok(runs, world, "shardmap")
    assert not runs["errors"]["jax"], runs["errors"]["jax"]
    f = _load(runs, world, "shardmap")[0]
    # no drops: the einsum path's values, at the reference's bar
    np.testing.assert_allclose(f["cf8.0_shardmap"], f["cf8.0_einsum"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f["fwd_shardmap"], f["fwd_einsum"], rtol=1e-4, atol=1e-5)
    # drops: the local capacity is not the per-group one; the reference's
    # shard_map on the same host-chip bank and tokens
    assert not np.allclose(f["cf1.25_shardmap"], f["cf1.25_einsum"], rtol=1e-4, atol=1e-5)
    assert np.array_equal(f["cf1.25_x"], _shardmap_x())
    want = np.load(os.path.join(runs["root"], f"jax_y{world}.npy"))
    np.testing.assert_allclose(f["cf1.25_shardmap"], want, atol=1e-4)


FAM_CASES = [(w, n) for n, ws in FAM_WORLDS.items() for w in ws]


@pytest.mark.parametrize("world,name", FAM_CASES)
def test_family_chip_aged_and_refreshed_are_the_host_chip(runs, world, name):
    _ok(runs, world, f"fam-{name}")
    out = os.path.join(runs["root"], f"w{world}")
    want = runs["fam"][name]
    for stage in ("prog", "aged", "fresh"):
        loaded = jstore.load_program(os.path.join(out, f"{name}_{stage}"),
                                     params_like=want["jp"])
        _bitwise(want[stage].params, loaded.params)
        _bitwise(want[stage].state, loaded.state)
        assert loaded.t_seconds == want[stage].t_seconds
    # the sharded chip really is split: every projection's columns or its
    # rows at whole tiles, on every rank
    ranks = _load(runs, world, f"fam-{name}")
    splits = [json.loads(str(f[f"{name}_splits"])) for f in ranks]
    assert all(s == splits[0] for s in splits)
    assert splits[0] and all(dim in (-1, -2) for _, dim in splits[0]), splits[0]


@pytest.mark.parametrize("world,name", FAM_CASES)
def test_family_logits_and_tokens_are_the_host_chips(runs, world, name):
    _ok(runs, world, f"fam-{name}")
    ranks = _load(runs, world, f"fam-{name}")
    for r in ranks[1:]:  # every rank holds the whole logits and the same tokens
        for k in ranks[0]:
            assert np.array_equal(r[k], ranks[0][k]), k
    f, want = ranks[0], runs["fam"][name]
    assert f[f"{name}_m16"].tobytes() == f[f"{name}_m16_host"].tobytes()
    if "codes" in want:
        b, _, n = CODEBOOK
        assert f[f"{name}_codes"].shape == (n + 1, b, 4)
        assert np.array_equal(f[f"{name}_codes"], want["codes"])
        return
    assert want["tokens"]
    for rid, toks in want["tokens"].items():
        assert np.array_equal(f[f"{name}_rid{rid}"], toks), rid


def test_cnn_sharded_with_transforms_is_the_host_chip(runs):
    _ok(runs, 2, "cnn")
    ranks = _load(runs, 2, "cnn")
    want = runs["fam"]["cnn"]
    loaded = jstore.load_program(os.path.join(runs["root"], "w2", "cnn_prog"))
    _bitwise(want.params, loaded.params)
    _bitwise(want.state, loaded.state)
    assert loaded.mapping.n_arrays == want.mapping.n_arrays
    assert loaded.mapping.utilization == want.mapping.utilization
    for f in ranks:
        assert f["cnn_logits"].tobytes() == f["cnn_logits_host"].tobytes()
        for k in ("cnn_mesh", "cnn_params_bitwise", "cnn_state_bitwise", "cnn_mapping_equal",
                  "lm_head_whole", "lm_transform_bitwise"):
            assert bool(f[k]), k


def test_mesh_model_cli_prints_the_reference_clis_tokens(runs):
    outs, err = runs["cli"]["out"], runs["cli"]["err"]
    assert outs is not None and not err, err
    tok = lambda out: re.search(r"^generated token ids \(first sequence\): (.*)$", out, re.M)
    want = tok(runs["jcli"])
    assert want, runs["jcli"]
    assert tok(outs[0]).group(1) == want.group(1)
    assert "programmed 8 analog layers once on 2-device mesh" in outs[0]
    assert outs[1] == ""  # rank 0 prints


def test_refusals_in_the_references_words(capsys):
    tcfg = t_get_smoke("tinyllama-1.1b")
    tparams = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    prog = tengine.compile_program(tparams, TAnalogConfig(tile_rows=32).infer(),
                                   prng.PRNGKey(1), device="cpu")
    cfg = tserving.ServingConfig(n_slots=2, s_max=16, fused_decode=True)
    with pytest.raises(NotImplementedError, match="one single-device kernel; sharded "
                       "serving keeps the per-layer path"):
        tserving.ServingEngine.for_program(prog, tcfg, cfg, mesh=object(), device="cpu")
    # the shard_map MoE's training stays refused under a mesh; the other
    # families are not refused (the step asks for its shardings next)
    from repro_torch.models.common import ModelConfig as TModelConfig

    sm = dataclasses.replace(TModelConfig(name="t", family="moe", n_layers=2, n_experts=8,
                                          top_k=2).smoke(), moe_dispatch="shard_map")
    with pytest.raises(NotImplementedError, match="einsum MoE dispatch"):
        tsteps.make_train_step(sm, TAnalogConfig(), None, mesh=object(), shardings=())
    for arch in FAMILIES.values():
        with pytest.raises(ValueError, match="takes shardings="):
            tsteps.make_train_step(t_get_smoke(arch), TAnalogConfig(), None, mesh=object())
    # the CLI: fused decode with a mesh (the reference CLI's words), and a
    # mesh without the processes it needs; paged recurrent serving
    for mod in (tserve, jserve):
        with pytest.raises(SystemExit):
            mod.validate_args(mod.build_parser(), mod.build_parser().parse_args(
                ["--analog", "--fused-decode", "--mesh-model", "2"]))
        assert "sharded serving keeps the per-layer path" in capsys.readouterr().err
        with pytest.raises(SystemExit):
            mod.validate_args(mod.build_parser(), mod.build_parser().parse_args(
                ["--arch", "mamba2-2.7b", "--request-trace", "2", "--kv-page-size", "8",
                 "--mesh-model", "2"]))
        assert "position-free recurrent state" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", *CLI, "--mesh-model", "2"])
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_serving_mesh(2)


def test_no_float_crosses_ranks_in_an_all_reduce():
    import torch

    src = os.path.join(REPO, "src", "repro_torch")
    users = []
    for dirpath, _, files in os.walk(src):
        for f in files:
            if f.endswith(".py") and "all_reduce(" in open(os.path.join(dirpath, f)).read():
                users.append(os.path.relpath(os.path.join(dirpath, f), src))
    assert users == ["collectives.py"]
    text = open(os.path.join(src, "collectives.py")).read()
    assert text.count("dist.all_reduce(") == 2
    assert "ReduceOp.MAX" in text and text.count("ReduceOp.SUM") == 1
    with pytest.raises(TypeError, match="integers only"):
        collectives.all_reduce_sum_int(torch.ones(2), None)
