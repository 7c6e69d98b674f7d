"""One rank of the port's multi-rank CPU checks (``test_torch_distributed.py``,
``test_torch_sharded_train.py``).

``python tests/_torch_dist_worker.py RANK WORLD STORE OUT JOBS [ARTIFACT]``
asks for 8 intra-op threads, joins a gloo group of WORLD ranks over a
``FileStore`` at STORE (60 s timeout; the group pins one thread), runs the
comma-separated JOBS in order (``chips-dense``: the ``chips`` job over one
model) and writes their results under OUT (``<job>.rank<r>.npz``, or
artifacts). It imports torch and the port only; the tests hold what it
writes against JAX and the port's unsharded results.

The models: tinyllama-1.1b's smoke config (``dense``) and the MoE smoke of
``tests/test_sharded_program.py`` (``moe``: 8 experts, top-2, smoke-cut to
4), programmed (and trained) at ``tile_rows=32`` so the smoke widths' K of
64 and 128 span several crossbar tiles and row splits really happen; the
other families' smoke configs (``FAMILIES``: ``mamba2``, ``rgemma``,
``pali``, ``musicgen``) in the ``fam`` and ``train*`` jobs; AnalogNet-KWS's
depthwise bench config in the ``cnn`` job.
"""

import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch import clock as tclock  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.analog import AnalogConfig, AnalogCtx  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm, moe, moe_shardmap  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.training import optim  # noqa: E402

from test_torch_traces import numpy_trace  # noqa: E402

INFER = AnalogConfig(tile_rows=32).infer(b_adc=8, t_seconds=86400.0)
CHIP_KEY = 1
S_MAX = 48


#: the other families' short names (a job name splits at "-") -> arch
FAMILIES = {"mamba2": "mamba2-2.7b", "rgemma": "recurrentgemma-9b", "pali": "paligemma-3b",
            "musicgen": "musicgen-large"}


def cfg_of(name: str) -> ModelConfig:
    if name == "dense":
        return get_smoke("tinyllama-1.1b")
    if name in FAMILIES:
        return get_smoke(FAMILIES[name])
    return ModelConfig(name="t", family="moe", n_layers=2, n_experts=8, top_k=2).smoke()


def trace(cfg):
    return numpy_trace(1, 7, vocab=cfg.vocab, rate=400.0,
                       prompt_lens=(4, 9, 16, 23, 33), new_tokens=(3, 10))


def tokens_of(report, reqs) -> dict:
    return {f"rid{r.rid}": report.tokens_of(r.rid) for r in reqs}


def job_chips(ctx, models):
    """Sharded chips saved (gathered, rank 0 writes), aged, refreshed; the
    local shapes of a few leaves."""
    shapes = {}
    for name in models:
        cfg = cfg_of(name)
        params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
        prog = steps.program_for_serving(params, INFER, prng.PRNGKey(CHIP_KEY),
                                         mesh=ctx["mesh"], model_cfg=cfg)
        blk = prog.params.blocks[0]
        shapes[name] = {k: list(v) for k, v in {
            "wq": blk["attn"]["wq"]["w"].shape, "wo": blk["attn"]["wo"]["w"].shape,
            "embed": prog.params.embed["table"].shape,
            "lm_head": prog.params.lm_head["w"].shape,
            **({"w2": blk["ffn"]["w2"]["w"].shape} if "ffn" in blk else
               {"bank_w1": blk["moe"]["w1"].shape}),
        }.items()}
        store.save_program(os.path.join(ctx["out"], f"{name}_prog"), prog)
        store.save_program(os.path.join(ctx["out"], f"{name}_aged"),
                           engine.age_program(prog, 30 * 86400.0))
        fresh = steps.refresh_program(prog, params, prng.fold_in(prng.PRNGKey(43), 1),
                                      mesh=ctx["mesh"], model_cfg=cfg)
        store.save_program(os.path.join(ctx["out"], f"{name}_fresh"), fresh)
    return {"shapes": json.dumps(shapes)}


def job_forward(ctx, models):
    """Logits of the sharded and the unsharded chip at M = 16 and M = 1, and
    at M = 16 with the read noise redrawn per MVM (a chip compiled with its
    read buffers serves its frozen draw without a key)."""
    out = {}
    rng = np.random.default_rng(5)
    resample = dataclasses.replace(INFER, resample_read_noise=True)
    for name in models:
        cfg = cfg_of(name)
        params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
        prog = steps.program_for_serving(params, resample, prng.PRNGKey(CHIP_KEY),
                                         mesh=ctx["mesh"], model_cfg=cfg)
        host = engine.compile_program(params, resample, prng.PRNGKey(CHIP_KEY), device="cpu")
        for rows, shape in (("m16", (2, 8)), ("m1", (1, 1))):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=shape))
            out[f"{name}_{rows}_tokens"] = toks.numpy()
            for key, chip in ((f"{name}_{rows}", prog), (f"{name}_{rows}_host", host)):
                out[key] = lm.lm_forward(chip.params, {"tokens": toks}, chip.cfg, cfg)[0].numpy()
        toks = torch.as_tensor(out[f"{name}_m16_tokens"])
        for key, chip in ((f"{name}_resample", prog), (f"{name}_resample_host", host)):
            out[key] = lm.lm_forward(chip.params, {"tokens": toks}, chip.cfg, cfg,
                                     rng=prng.PRNGKey(9))[0].numpy()
    return out


def job_shardmap(ctx, models):
    """The shard_map MoE against the einsum path on the same chip, at
    capacity factor 8 (no drops) and 1.25; a forward through it."""
    out = {}
    rng = np.random.default_rng(11)
    for cf in (8.0, 1.25):
        cfg = dataclasses.replace(cfg_of("moe"), capacity_factor=cf)
        params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
        prog = steps.program_for_serving(params, INFER, prng.PRNGKey(CHIP_KEY),
                                         mesh=ctx["mesh"], model_cfg=cfg)
        host = engine.compile_program(params, INFER, prng.PRNGKey(CHIP_KEY), device="cpu")
        x = torch.as_tensor(rng.standard_normal((2, 8, cfg.d_model)), dtype=torch.float32)
        actx = lambda p: AnalogCtx(cfg=prog.cfg, gain_s=p.gain_s)
        bank = lm._index(prog.params.blocks[0], 0)["moe"]
        out[f"cf{cf}_x"] = x.numpy()
        out[f"cf{cf}_shardmap"] = moe_shardmap.moe_apply_shardmap(
            bank, x, actx(prog.params), cfg).numpy()
        out[f"cf{cf}_einsum"] = moe.moe_apply(
            lm._index(host.params.blocks[0], 0)["moe"], x, actx(host.params), cfg).numpy()
        if cf == 8.0:
            sm = dataclasses.replace(cfg, moe_dispatch="shard_map")
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 8)))
            out["fwd_shardmap"] = lm.lm_forward(prog.params, {"tokens": toks}, prog.cfg, sm)[0].numpy()
            out["fwd_einsum"] = lm.lm_forward(host.params, {"tokens": toks}, host.cfg, cfg)[0].numpy()
    return out


def _serve(prog, cfg, mesh, paged: bool, reqs):
    kw = dict(n_slots=3, s_max=S_MAX)
    if paged:
        kw.update(paged=True, page_size=5, prefill_batch=2)
    eng = tserving.ServingEngine.for_program(prog, cfg, tserving.ServingConfig(**kw),
                                             mesh=mesh, device="cpu")
    return eng.run(reqs, scheduler=tserving.BucketedScheduler() if paged else None,
                   clock=tclock.VirtualClock())


def job_serve(ctx, models):
    """Greedy tokens of the sharded chip, slot and paged; of a data axis of
    2 (each data group its slots) where the world is 2; of JAX's saved host
    chip loaded with ``load_program(shardings=)``."""
    cfg = cfg_of("dense")
    reqs = trace(cfg)
    params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
    prog = steps.program_for_serving(params, INFER, prng.PRNGKey(42),
                                     mesh=ctx["mesh"], model_cfg=cfg)
    out = {}
    for paged in (False, True):
        rep = _serve(prog, cfg, ctx["mesh"], paged, reqs)
        out.update({f"{'paged' if paged else 'slot'}_{k}": v
                    for k, v in tokens_of(rep, reqs).items()})
    if ctx["artifact"]:
        loaded = store.load_program(
            ctx["artifact"], params_like=params,
            shardings=shd.program_shardings(params, ctx["mesh"], cfg), device="cpu")
        out.update({f"loaded_{k}": v for k, v in
                    tokens_of(_serve(loaded, cfg, ctx["mesh"], False, reqs), reqs).items()})
    if ctx["world"] == 2:
        data_mesh = mesh_lib.make_serving_mesh(1)  # (data 2, model 1)
        dprog = steps.program_for_serving(params, INFER, prng.PRNGKey(42), mesh=data_mesh,
                                          model_cfg=cfg)
        eng = tserving.ServingEngine.for_program(
            dprog, cfg, tserving.ServingConfig(n_slots=4, s_max=S_MAX), device="cpu")
        assert eng.data_rows is not None
        rep = eng.run(reqs, clock=tclock.VirtualClock())
        out.update({f"data_{k}": v for k, v in tokens_of(rep, reqs).items()})
    return out


def fam_inputs(cfg, seed: int, b: int, s: int) -> dict:
    """A batch of ``cfg``'s inputs as numpy: frames for the audio family,
    else tokens (and image patches for the vision family)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def fam_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


def fam_requests(cfg) -> list:
    """The served requests: 3 of two prompt lengths (one prefill shape
    each); the vision family's 2 with their own patches."""
    if cfg.frontend != "vision_patches":
        return numpy_trace(2, 3, vocab=cfg.vocab, rate=400.0, prompt_lens=(9, 16),
                           new_tokens=(3, 8))
    batch = fam_inputs(cfg, 4, 2, 9)
    return [tserving.Request(rid=i, prompt=batch["tokens"][i], max_new_tokens=4,
                             features={"patches": torch.from_numpy(batch["patches"][i:i + 1])})
            for i in range(2)]


#: the audio family's rectangle: rows, prompt frames, greedy steps
CODEBOOK = (2, 6, 3)


def codes(prog, cfg, frames) -> np.ndarray:
    """The step makers' (steps, B, C) greedy codes over ``frames``."""
    b, s, n = CODEBOOK
    cache = lm.init_lm_cache(cfg, b, s + n, torch.float32, device="cpu",
                             kv_heads=lm.cache_kv_heads(prog.params, cfg))
    logits, cache = steps.make_prefill_step(cfg, prog.cfg, device="cpu")(
        prog.params, {"frames": frames[:, :s]}, cache, prng.PRNGKey(3))
    out = [logits[:, -1].argmax(-1).to(torch.int32).numpy()]
    step = steps.make_serve_step(cfg, prog.cfg, device="cpu")
    for i in range(n):
        got, cache = step(prog.params, {"frames": frames[:, s + i:s + i + 1]}, cache,
                          prng.PRNGKey(4))
        out.append(got.numpy())
    return np.stack(out)


def job_fam(ctx, models):
    """The other families' sharded chips: saved (gathered), aged and
    refreshed; the logits at M = 16 of the sharded and the unsharded chip;
    the sharded chip's served tokens (the engine; the audio family's codes
    through the step makers); which layers split."""
    out = {}
    for name in models:
        cfg = cfg_of(name)
        params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
        prog = steps.program_for_serving(params, INFER, prng.PRNGKey(CHIP_KEY),
                                         mesh=ctx["mesh"], model_cfg=cfg)
        host = engine.compile_program(params, INFER, prng.PRNGKey(CHIP_KEY), device="cpu")
        store.save_program(os.path.join(ctx["out"], f"{name}_prog"), prog)
        store.save_program(os.path.join(ctx["out"], f"{name}_aged"),
                           engine.age_program(prog, 30 * 86400.0))
        fresh = steps.refresh_program(prog, params, prng.fold_in(prng.PRNGKey(43), 1),
                                      mesh=ctx["mesh"], model_cfg=cfg)
        store.save_program(os.path.join(ctx["out"], f"{name}_fresh"), fresh)
        splits = []
        engine._walk(prog.params, lambda path, node: splits.append(
            (path, None if node.get("tp") is None else node["tp"].dim)) or node)
        out[f"{name}_splits"] = np.array(json.dumps(splits))
        batch = fam_inputs(cfg, 5, 2, 8)
        for key, chip in ((f"{name}_m16", prog), (f"{name}_m16_host", host)):
            out[key] = lm.lm_forward(chip.params, fam_batch(batch), chip.cfg, cfg)[0].numpy()
        if cfg.n_codebooks:
            b, s, n = CODEBOOK
            frames = torch.from_numpy(fam_inputs(cfg, 6, b, s + n)["frames"])
            out[f"{name}_codes"] = codes(prog, cfg, frames)
            continue
        reqs = fam_requests(cfg)
        eng = tserving.ServingEngine.for_program(
            prog, cfg, tserving.ServingConfig(n_slots=2, s_max=S_MAX), device="cpu")
        assert eng.mesh is ctx["mesh"]
        rep = eng.run(reqs, clock=tclock.VirtualClock())
        out.update({f"{name}_{k}": v for k, v in tokens_of(rep, reqs).items()})
    return out


def job_cnn(ctx, models):
    """AnalogNet-KWS's depthwise bench config programmed with
    ``shardings=``, its crossbar transforms and its mapping, against the
    same chip unsharded: params, state, mapping and logits; the gathered
    chip saved. Then tinyllama's smoke config with a transform on its
    lm_head: that layer whole on every rank, the rest split, gathered
    bitwise the unsharded chip compiled with the same transform."""
    from repro_torch import tree as tree_lib
    from repro_torch.bench.common import KWS_BENCH_DW
    from repro_torch.models import analognet

    mesh, cfg = ctx["mesh"], KWS_BENCH_DW
    params = analognet.cnn_init(prng.PRNGKey(0), cfg, device="cpu")
    kw = dict(transforms=analognet.crossbar_transforms(cfg), with_mapping=True, device="cpu")
    sharded = engine.compile_program(params, INFER, prng.PRNGKey(1),
                                     shardings=shd.program_shardings(params, mesh), **kw)
    host = engine.compile_program(params, INFER, prng.PRNGKey(1), **kw)
    got = sharded.gather()
    store.save_program(os.path.join(ctx["out"], "cnn_prog"), sharded)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2,) + cfg.input_hw + (cfg.in_channels,)), dtype=torch.float32)
    out = {"cnn_mesh": np.array(sharded.mesh is mesh),
           "cnn_x": x.numpy(),
           "cnn_logits": analognet.cnn_apply(sharded.params, x, sharded.cfg, cfg).numpy(),
           "cnn_logits_host": analognet.cnn_apply(host.params, x, host.cfg, cfg).numpy()}
    for part in ("params", "state"):
        a, b = (store._flatten(getattr(p, part)) for p in (got, host))
        out[f"cnn_{part}_bitwise"] = np.array(
            list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a))
    out["cnn_mapping_equal"] = np.array(got.mapping == host.mapping
                                        and sharded.mapping == host.mapping)
    # an LM layer with a transform programs whole; the rest are sharded
    lcfg = cfg_of("dense")
    lp = lm.lm_init(prng.PRNGKey(0), lcfg, device="cpu")
    tf = {"lm_head": lambda w: w * 1.0}
    lsh = steps.program_for_serving(lp, INFER, prng.PRNGKey(CHIP_KEY), mesh=mesh,
                                    model_cfg=lcfg, transforms=tf)
    lhost = engine.compile_program(lp, INFER, prng.PRNGKey(CHIP_KEY), transforms=tf,
                                   device="cpu")
    lgot = lsh.gather()
    out["lm_head_whole"] = np.array("tp" not in lsh.params.lm_head
                                    and "tp" in lsh.params.blocks[0]["attn"]["wq"])
    out["lm_transform_bitwise"] = np.array(all(
        torch.equal(a, b) for a, b in zip(tree_lib.leaves(lgot.params) + tree_lib.leaves(
            lgot.state), tree_lib.leaves(lhost.params) + tree_lib.leaves(lhost.state))))
    return out


# --------------------------------------------------------------- sharded training

#: the sharded train step's cases, (model, config, accum_steps): stage 2
#: with both masks (b_adc 6, p 0.5), also over 2 microbatches, and stage 1
TRAIN = AnalogConfig(tile_rows=32).train(eta=0.1, b_adc=6, quant_noise_p=0.5)
DIGITAL = AnalogConfig(tile_rows=32)
#: the reference's scenario (``tests/test_distributed.py``)
JAX_TRAIN = AnalogConfig(tile_rows=32).train(eta=0.05)
OPT = optim.OptimizerConfig(lr=1e-2, total_steps=50, warmup=0)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 32, 3
TRAIN_CASES = {"dense-analog": ("dense", TRAIN, 1), "moe-analog": ("moe", TRAIN, 1),
               "dense-digital": ("dense", DIGITAL, 1), "moe-digital": ("moe", DIGITAL, 1),
               "dense-analog-accum2": ("dense", TRAIN, 2),
               "mamba2-analog": ("mamba2", TRAIN, 1), "rgemma-analog": ("rgemma", TRAIN, 1),
               "pali-analog": ("pali", TRAIN, 1)}
#: the other families' cases (the ``train1xf-<names>`` and
#: ``train2xf-<names>`` jobs run them at (1, world) and (2, world / 2)),
#: FAMILY_STEPS steps on a model axis and one on a data axis (held to the
#: step-1 bars)
FAMILY_CASES = ("mamba2-analog", "rgemma-analog", "pali-analog")
FAMILY_STEPS = 2
#: (data, model) -> the cases a mesh runs
MESH_CASES = {(1, 1): ("dense-analog", "moe-analog", "dense-digital"),
              (1, 2): tuple(c for c in TRAIN_CASES if c not in FAMILY_CASES) + FAMILY_CASES,
              (2, 1): ("dense-analog", "moe-analog", "rgemma-analog"),
              (2, 2): ("dense-analog",),
              (4, 1): ("moe-analog",)}


def train_batch(vocab: int) -> dict:
    rng = np.random.default_rng(3)
    return {k: torch.as_tensor(rng.integers(0, vocab, size=(TRAIN_B, TRAIN_S)))
            for k in ("tokens", "labels")}


def step_key(i: int):
    return prng.fold_in(prng.PRNGKey(0), i)


class DrawLog:
    """Every draw of ``prng.bernoulli``, ``normal`` and ``normal_erf_inv``
    while on: (sampler, key, p, shape, offset, stride)."""

    NAMES = ("bernoulli", "normal", "normal_erf_inv")

    def __init__(self):
        self.on, self.draws = False, []
        for name in self.NAMES:
            setattr(prng, name, self._wrap(name, getattr(prng, name)))

    def _wrap(self, name, fn):
        def draw(key, *args, **kw):
            if self.on:
                a = list(args)
                p = a.pop(0) if name == "bernoulli" else None
                shape = kw.get("shape", a[0] if a else ())
                offset = kw.get("offset", a[1] if len(a) > 1 else 0)
                stride = kw.get("stride", a[2] if len(a) > 2 else None)
                self.draws.append([name, [int(v) for v in key], p, list(shape), int(offset),
                                   stride])
            return fn(key, *args, **kw)
        return draw


DRAWS = DrawLog()


def per_token_nll(logits, labels):
    logits = logits.float()
    return torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None])[..., 0]


def sharded_nll(params, p_sh, mesh, cfg, acfg, batch, key):
    """The per-token loss of the sharded step's forward at ``params`` (the
    rank's slices), gathered over ``data``."""
    from repro_torch import collectives, tree as tree_lib
    from repro_torch.models.common import logical_rules_of

    data = collectives.axis_of(mesh, "data")
    n = TRAIN_B // data.size
    fsdp = shd.fsdp_axes(mesh)
    with torch.no_grad(), logical_rules_of(shd.logical_rules(mesh, cfg, training=True), mesh):
        view = shd.train_view(tree_lib.tree_map(lambda t, sh: shd.gather_leaf(t, sh, fsdp),
                                                params, p_sh), p_sh)
        rows = {k: v[data.rank * n:(data.rank + 1) * n] for k, v in batch.items()}
        logits, _ = lm.lm_forward(view, {"tokens": rows["tokens"]}, acfg, cfg, rng=key)
        nll = per_token_nll(logits, rows["labels"])
        return collectives.all_gather_dim(nll, 0, tuple(i * n for i in range(data.size + 1)),
                                          data)


def flat(tree, prefix: str) -> dict:
    return {f"{prefix}::{k}": v.numpy() for k, v in store._flatten(tree).items()}


def job_train(ctx, model: int, cases=None):
    """The sharded train step over a (world / model, model) mesh, each of
    its cases (default: the mesh's ``MESH_CASES``) TRAIN_STEPS steps: metrics a step, the gathered params and
    optimizer state after the first and the last, step 1's draws, the
    step-1 forward's per-token loss, FSDP gathers and the local shapes; the
    first case's step 1 run twice. On a data axis rank 0 also runs the
    unsharded step on from the sharded step-1 state (``witness``)."""
    from repro_torch import tree as tree_lib

    mesh = mesh_lib.make_host_mesh(model)
    shape = tuple(mesh.mesh.shape)
    out = {"mesh": np.array(shape)}
    for case in MESH_CASES[shape] if cases is None else cases:
        name, acfg, accum = TRAIN_CASES[case]
        cfg = cfg_of(name)
        params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
        opt = optim.init(OPT, params)
        batch = train_batch(cfg.vocab)
        p_sh = shd.param_shardings(params, mesh, cfg, analog_cfg=acfg)
        o_sh = shd.build_opt_shardings(opt, params, p_sh, mesh)
        ps, os_ = shd.shard_tree(params, p_sh), shd.shard_tree(opt, o_sh)
        exact = all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(shd.gather_tree(ps, p_sh)) + tree_lib.leaves(shd.gather_tree(os_, o_sh)),
            tree_lib.leaves(params) + tree_lib.leaves(opt)))
        out[f"{case}_gather_exact"] = np.array(exact)
        out[f"{case}_shapes"] = np.array(json.dumps({k: list(v.shape) for k, v in
                                                     store._flatten(ps).items()}))
        out[f"{case}_nll"] = sharded_nll(ps, p_sh, mesh, cfg, acfg, batch,
                                         prng.fold_in(step_key(0), 0)).numpy()
        step = steps.make_train_step(cfg, acfg, OPT, accum, mesh=mesh, shardings=(p_sh, o_sh))
        n_steps = TRAIN_STEPS if case not in FAMILY_CASES else (
            FAMILY_STEPS if shape[0] == 1 else 1)
        for i in range(n_steps):
            DRAWS.on, DRAWS.draws = i == 0, []
            new = step(ps, os_, batch, step_key(i))
            DRAWS.on = False
            if i == 0:
                out[f"{case}_draws"] = np.array(json.dumps(DRAWS.draws))
                if case == MESH_CASES[shape][0]:  # the same step again: the same bits
                    again = step(ps, os_, batch, step_key(0))
                    out[f"{case}_twice"] = np.array(all(torch.equal(a, b) for a, b in zip(
                        tree_lib.leaves(new), tree_lib.leaves(again))))
            ps, os_, m = new
            out.update({f"{case}_step{i}_{k}": v.numpy() for k, v in m.items()})
            if i == 0:
                first = shd.gather_tree(ps, p_sh), shd.gather_tree(os_, o_sh)
                out.update({**flat(first[0], f"{case}_params1"), **flat(first[1], f"{case}_opt1")})
        out.update(flat(shd.gather_tree(ps, p_sh), f"{case}_params"))
        out.update(flat(shd.gather_tree(os_, o_sh), f"{case}_opt"))
        if shape[0] > 1 and ctx["rank"] == 0 and case not in FAMILY_CASES:
            out.update({f"{case}_witness_{k}": v
                        for k, v in witness(cfg, acfg, accum, batch, *first).items()})
    return out


def witness(cfg, acfg, accum, batch, params, opt) -> dict:
    """The port's unsharded step run from ``params`` and ``opt`` (a step-1
    state) through steps 2 to TRAIN_STEPS: its params, and each step's MoE
    routing (``route<i>``: every layer's top-k expert choices)."""
    step = steps.make_train_step(cfg, acfg, OPT, accum)
    out = {}
    for i in range(1, TRAIN_STEPS):
        with routing() as route:
            params, opt, _ = step(params, opt, batch, step_key(i))
        out[f"route{i}"] = np.stack(route) if route else np.zeros(0, np.int64)
    return {**flat(params, "params"), **out}


@contextlib.contextmanager
def routing():
    """The top-k expert choices of every ``moe._topk_routing`` call in the
    block, appended to the yielded list."""
    calls, topk = [], moe._topk_routing

    def record(gates, k, cap):
        out = topk(gates, k, cap)
        calls.append(torch.stack(out[0]).numpy())
        return out

    moe._topk_routing = record
    try:
        yield calls
    finally:
        moe._topk_routing = topk


def job_train1x1(ctx, models):
    return job_train(ctx, 1)


def job_train1xn(ctx, models):
    """The (1, world) mesh's dense and MoE cases of ``models`` (``train1xn``:
    both; ``train1xn-dense``, ``train1xn-moe``: one, a group each)."""
    return job_train(ctx, ctx["world"], [c for c in MESH_CASES[(1, ctx["world"])]
                                         if c not in FAMILY_CASES
                                         and TRAIN_CASES[c][0] in models])


def job_train1xf(ctx, models):
    return job_train(ctx, ctx["world"], [f"{m}-analog" for m in models])


def job_train2xn(ctx, models):
    return job_train(ctx, ctx["world"] // 2, [c for c in MESH_CASES[(2, ctx["world"] // 2)]
                                              if c not in FAMILY_CASES])


def job_train4x1(ctx, models):
    """The (world, 1) mesh's cases: the MoE's 2 routing groups do not split
    over 4 data ranks (``moe.moe_apply``'s gathered rows)."""
    return job_train(ctx, 1)


def job_train2xf(ctx, models):
    return job_train(ctx, ctx["world"] // 2, [f"{m}-analog" for m in models])


def job_jax(ctx, models):
    """The reference's scenario at (2, 2): its batch (OUT/jax_batch.npz),
    its config, 6 steps."""
    d = np.load(os.path.join(ctx["out"], "jax_batch.npz"))
    mesh = mesh_lib.make_host_mesh(2)
    cfg = cfg_of("dense")
    params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
    opt = optim.init(OPT, params)
    batch = {k: torch.as_tensor(d[k]) for k in ("tokens", "labels")}
    p_sh = shd.param_shardings(params, mesh, cfg, analog_cfg=JAX_TRAIN)
    o_sh = shd.build_opt_shardings(opt, params, p_sh, mesh)
    ps, os_ = shd.shard_tree(params, p_sh), shd.shard_tree(opt, o_sh)
    step = steps.make_train_step(cfg, JAX_TRAIN, OPT, mesh=mesh, shardings=(p_sh, o_sh))
    out = {}
    for i in range(6):
        ps, os_, m = step(ps, os_, batch, step_key(i))
        out.update({f"step{i}_{k}": v.numpy() for k, v in m.items()})
        if i == 0:
            out.update(flat(shd.gather_tree(ps, p_sh), "step0_params"))
    blk = ps.blocks[0]
    out["local"] = np.array(json.dumps({k: list(v.shape) for k, v in {
        "wq": blk["attn"]["wq"]["w"], "wo": blk["attn"]["wo"]["w"],
        "w2": blk["ffn"]["w2"]["w"], "lm_head": ps.lm_head["w"],
        "embed": ps.embed["table"]}.items()}))
    return out


def job_hazard(ctx, models):
    """One column-parallel layer over a (1, world) mesh at K = 1024, N =
    2048, digital at M = 2-8 and analog_train (p = 0.5) at 8: every rank's
    output (whole: the layer gathers its columns), input gradient, range
    gradient and weight-gradient columns, gathered, against the whole layer
    on rank 0 (one intra-op thread, as the group pinned it). Rank 0 writes
    the comparisons."""
    from repro_torch import collectives
    from repro_torch.core.analog import AnalogCtx, linear_apply
    from repro_torch.models.common import logical_rules_of

    world, rank = ctx["world"], ctx["rank"]
    mesh = mesh_lib.make_host_mesh(world)
    axis = collectives.axis_of(mesh, "model")
    ranks = tuple(range(world + 1))
    rng = np.random.default_rng(7)
    k, n = 1024, 2048
    w = torch.as_tensor(rng.standard_normal((k, n)) * k**-0.5, dtype=torch.float32)
    split = shd.Split(-1, shd.even_bounds(n, world), rank)
    out = {"threads": np.array(torch.get_num_threads())}
    analog = AnalogConfig().train(eta=0.1, b_adc=8, quant_noise_p=0.5)

    def run(acfg, x, gy, layer, tp=None):
        layer = {**layer, "w": layer["w"].clone().requires_grad_(),
                 "r_adc": torch.ones(()).requires_grad_()}
        x = x.clone().requires_grad_()
        ctx_a = AnalogCtx(cfg=acfg, gain_s=torch.ones(()), key=prng.PRNGKey(5))
        with logical_rules_of(shd.logical_rules(mesh, training=True), mesh):
            y = linear_apply({**layer, "tp": tp} if tp else layer, x, ctx_a)
            (y * gy).sum().backward()
        dr = layer["r_adc"].grad
        return y.detach(), x.grad, layer["w"].grad, torch.zeros(()) if dr is None else dr

    for mode, acfg, ms in (("digital", AnalogConfig(), range(2, 9)),
                           ("analog", analog, (8,))):
        for m in ms:
            x = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32)
            gy = torch.as_tensor(rng.standard_normal((m, n)), dtype=torch.float32)
            clip = torch.tensor([-1.0, 1.0])
            y, gx, gw, gr = run(acfg, x, gy, {"w": split.take(w), "w_clip_buf": clip}, split)
            got = [collectives.all_gather_dim(t[None], 0, ranks, axis) for t in (y, gx, gr)]
            got.insert(2, collectives.all_gather_dim(gw, -1, split.bounds, axis))
            if rank == 0:
                want = run(acfg, x, gy, {"w": w, "w_clip_buf": clip})
                out[f"{mode}_m{m}"] = np.array([
                    torch.equal(got[2], want[2]),
                    *(all(torch.equal(g, v) for g in t) for t, v in zip(
                        got[:2] + got[3:], want[:2] + want[3:]))])
    return out


def job_ops(ctx, models):
    """The autograd operators, ``sum_in_rank_order`` and the optimizer's
    update on sharded leaves against the whole update, over the (world, 1)
    and (1, world) meshes."""
    from repro_torch import collectives
    from repro_torch import tree as tree_lib

    out, world, rank = {}, ctx["world"], ctx["rank"]
    mesh = mesh_lib.make_host_mesh(world)
    axis = collectives.axis_of(mesh, "model")
    rng = np.random.default_rng(9)
    whole = torch.as_tensor(rng.standard_normal((3, 10)), dtype=torch.float32)
    cot = torch.as_tensor(rng.standard_normal((3, 10)), dtype=torch.float32)
    bounds = (0,) + tuple(range(1, world)) + (10,)  # uneven: the last rank takes the rest
    lo, hi = bounds[rank], bounds[rank + 1]
    x = whole.clone().requires_grad_()
    part = collectives.split(x, 1, bounds, axis)
    (part * cot[:, lo:hi]).sum().backward()
    out["split"] = np.array([torch.equal(part, whole[:, lo:hi]), torch.equal(x.grad, cot)])
    xl = whole[:, lo:hi].clone().requires_grad_()
    full = collectives.gather(xl, 1, bounds, axis)
    (full * cot).sum().backward()
    out["gather"] = np.array([torch.equal(full, whole), torch.equal(xl.grad, cot[:, lo:hi])])
    mine = whole * (rank + 1) + 0.1
    total = collectives.sum_in_rank_order(mine, axis)
    want = whole * 1 + 0.1
    for r in range(1, world):
        want = want + (whole * (r + 1) + 0.1)
    out["sum"] = np.array(torch.equal(total, want))
    for model in (1, world):
        mesh = mesh_lib.make_host_mesh(model)
        cfg = cfg_of("dense")
        params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
        grads = tree_lib.tree_map(lambda p: torch.as_tensor(
            rng.standard_normal(tuple(p.shape)), dtype=p.dtype), params)
        p_sh = shd.param_shardings(params, mesh, cfg, analog_cfg=TRAIN)
        for kind in ("adamw", "adafactor"):
            ocfg = dataclasses.replace(OPT, kind=kind, factored_min_dim=32)
            st = optim.init(ocfg, params)
            o_sh = shd.build_opt_shardings(st, params, p_sh, mesh)
            want = optim.update(ocfg, params, grads, st)
            got = optim.update(ocfg, shd.shard_tree(params, p_sh), shd.shard_tree(grads, p_sh),
                               shd.shard_tree(st, o_sh), (p_sh, o_sh))
            got = (shd.gather_tree(got[0], p_sh), shd.gather_tree(got[1], o_sh), got[2])
            out[f"update_{kind}_model{model}"] = np.array(all(
                torch.equal(a, b) for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(want))))
    return out


#: the pcm_infer job's rectangle: rows, prompt tokens, greedy steps
INFER_RECT = (2, 8, 3)


def infer_tokens(cfg) -> np.ndarray:
    """The pcm_infer job's prompts (also the test's, for JAX)."""
    b, s, _ = INFER_RECT
    return np.random.default_rng(21).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def job_pcminfer(ctx, models):
    """Per-call PCM inference (``pcm_infer``) on a rank's shards over a
    (world / 2, 2) mesh: the forward's logits on the shards (``serve_view``)
    and on the whole params (the unsharded forward, at one thread as the
    group runs), and the greedy tokens of the sharded step makers
    (``make_prefill_step``/``make_serve_step(mesh=)``), the ranks' rows
    gathered."""
    from repro_torch import collectives
    from repro_torch.models.common import logical_rules_of

    mesh = mesh_lib.make_host_mesh(2)
    data = collectives.axis_of(mesh, "data")
    out = {}
    b, s, n = INFER_RECT
    for name in models:
        cfg = cfg_of(name)
        params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
        p_sh = shd.param_shardings(params, mesh, cfg, inference=True, analog_cfg=INFER)
        local = shd.shard_tree(params, p_sh)
        toks = torch.as_tensor(infer_tokens(cfg)).long()
        with torch.no_grad(), logical_rules_of(shd.logical_rules(mesh, cfg), mesh):
            view = shd.serve_view(local, p_sh)
            out[f"{name}_logits"] = lm.lm_forward(view, {"tokens": toks}, INFER, cfg,
                                                  rng=prng.PRNGKey(7))[0].numpy()
        out[f"{name}_host"] = lm.lm_forward(params, {"tokens": toks}, INFER, cfg,
                                            rng=prng.PRNGKey(7))[0].numpy()
        prefill = steps.make_prefill_step(cfg, INFER, device="cpu", mesh=mesh, shardings=p_sh)
        serve = steps.make_serve_step(cfg, INFER, device="cpu", mesh=mesh, shardings=p_sh)
        cache = steps.sharded_cache(cfg, local, p_sh, mesh, b, s + n, device="cpu")
        logits, cache = prefill(local, {"tokens": toks}, cache, prng.PRNGKey(3))
        got = [logits[:, -1].argmax(-1).to(torch.int32)]
        cache = lm.unstack_cache(cache)
        for i in range(n - 1):
            nxt, cache = serve(local, {"tokens": got[-1][:, None]}, cache,
                               prng.fold_in(prng.PRNGKey(4), i))
            got.append(nxt)
        rows = torch.stack(got, dim=1)
        out[f"{name}_tokens"] = collectives.all_gather_dim(
            rows, 0, shd.even_bounds(b, data.size), data).numpy() if rows.shape[0] < b \
            else rows.numpy()
    return out


#: the cost job's cell: (kind, seq, global batch) and its modes
COST_CELL = ("train", 16, 4)
COST_MODES = ("digital", "analog_train")


def job_cost(ctx, models):
    """A real sharded train step of the dense smoke config over the (1,
    world) mesh under ``analysis.cost.count``: its counts (the test holds
    them against the fake trace's over a fake group of the same layout)."""
    from repro_torch.analysis import cost
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun

    mesh = mesh_lib.make_host_mesh(ctx["world"])
    kind, seq, batch = COST_CELL
    out = {}
    for mode in COST_MODES:
        c = dryrun.prepare(cfg_of("dense"), ShapeCell(kind, seq, batch, kind), mesh, mode,
                           device="cpu")
        with cost.count() as counter:
            c.step(*c.args)
        out[mode] = np.array(json.dumps({**counter.summary(), "argument_bytes": c.argument_bytes}))
    return out


JOBS = {"cost": job_cost, "pcminfer": job_pcminfer, "chips": job_chips, "forward": job_forward,
        "shardmap": job_shardmap, "serve": job_serve, "fam": job_fam, "cnn": job_cnn,
        "train1x1": job_train1x1, "train1xn": job_train1xn, "train1xf": job_train1xf,
        "train2xf": job_train2xf, "train2xn": job_train2xn, "train4x1": job_train4x1,
        "jax": job_jax, "hazard": job_hazard, "ops": job_ops}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store_path, out, jobs = sys.argv[3], sys.argv[4], sys.argv[5].split(",")
    torch.set_num_threads(8)  # the gloo group pins one (launch.mesh.init_process_group)
    mesh_lib.init_process_group("cpu", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout_s=60)
    assert torch.get_num_threads() == 1
    ctx = {"mesh": mesh_lib.make_serving_mesh(world), "out": out, "world": world,
           "rank": rank, "artifact": sys.argv[6] if len(sys.argv) > 6 else None}
    for job in jobs:  # "name" or "name-model": a job over one model
        name, *models = job.split("-")
        fams = name in ("fam", "train1xf", "train2xf")
        res = JOBS[name](ctx, models or (tuple(FAMILIES) if fams else ("dense", "moe")))
        np.savez(os.path.join(out, f"{job}.rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
