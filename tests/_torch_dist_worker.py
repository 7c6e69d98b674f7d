"""One rank of the port's multi-rank CPU checks (``test_torch_distributed.py``).

``python tests/_torch_dist_worker.py RANK WORLD STORE OUT JOBS [ARTIFACT]``
joins a gloo group of WORLD ranks over a ``FileStore`` at STORE (60 s
timeout), runs the comma-separated JOBS in order (``chips-dense``: the
``chips`` job over one model) and writes their results under OUT
(``<job>.rank<r>.npz``, or artifacts). It imports torch and the
port only; the test holds what it writes against JAX's host chip.

The models: tinyllama-1.1b's smoke config (``dense``) and the MoE smoke of
``tests/test_sharded_program.py`` (``moe``: 8 experts, top-2, smoke-cut to
4), programmed at ``tile_rows=32`` so the smoke widths' K of 64 and 128
span several crossbar tiles and row splits really happen.
"""

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

from test_torch_traces import numpy_trace  # noqa: E402

INFER = AnalogConfig(tile_rows=32).infer(b_adc=8, t_seconds=86400.0)
CHIP_KEY = 1
S_MAX = 48


def cfg_of(name: str) -> ModelConfig:
    if name == "dense":
        return get_smoke("tinyllama-1.1b")
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


JOBS = {"chips": job_chips, "forward": job_forward, "shardmap": job_shardmap,
        "serve": job_serve}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store_path, out, jobs = sys.argv[3], sys.argv[4], sys.argv[5].split(",")
    torch.set_num_threads(1)
    mesh_lib.init_process_group("cpu", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout_s=60)
    ctx = {"mesh": mesh_lib.make_serving_mesh(world), "out": out, "world": world,
           "artifact": sys.argv[6] if len(sys.argv) > 6 else None}
    for job in jobs:  # "name" or "name-model": a job over one model
        name, *models = job.split("-")
        res = JOBS[name](ctx, models or ("dense", "moe"))
        np.savez(os.path.join(out, f"{job}.rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
