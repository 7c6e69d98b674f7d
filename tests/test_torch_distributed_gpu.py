"""Sharded programming and serving on one card: a world of 1 over NCCL.

One card cannot hold two NCCL ranks, so the multi-rank semantics are held
on the CPU over gloo (``tests/test_torch_distributed.py``); here the NCCL
process group, the collectives, the sharded program phase and B1, B3 and
the bank form on a rank's shards run on the card at smoke width:

* the sharded chip (``program_for_serving(mesh=)``), gathered, is bitwise
  the unsharded chip; its strided draws (``prng.normal(stride=)``) are the
  CPU's;
* its logits are bitwise the unsharded chip's, with the same B1 and B3
  launches and no plain call; the collectives ran;
* ``ServingEngine(mesh=)`` serves the unsharded engine's tokens; the
  shard_map MoE at capacity factor 8 serves the einsum path's tokens with
  one bank launch a family;
* the sharded train step (``make_train_step(mesh=)``) at smoke width in
  bf16, two steps of each stage: params, optimizer state and metrics
  bitwise the unsharded step's, with the same B1 and B3 launches.

Marked ``gpu``: each test skips on a host without a CUDA device. On the
card: ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_distributed_gpu.py``. This file imports only the port.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    mesh_lib.init_process_group("cuda", store=store, rank=0, world_size=1, timeout_s=60)
    yield mesh_lib.make_serving_mesh(1)
    from repro_torch.models.common import set_logical_rules

    set_logical_rules({})
    dist.destroy_process_group()


def _leaves(tree):
    from repro_torch.checkpoint import store

    return store._flatten(tree)


def test_strided_draws_on_the_card_are_the_cpus(mesh):
    from repro_torch import prng

    key = prng.PRNGKey(3)
    whole = prng.normal(key, (300, 200))
    block = prng.normal(key.to("cuda"), (100, 50), offset=120 * 200 + 70, stride=200)
    assert torch.equal(block.cpu(), whole[120:220, 70:120])


def test_sharded_chip_logits_and_launches_are_the_unsharded(mesh):
    from repro_torch import collectives, prng
    from repro_torch.configs import get_smoke
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.bfloat16)
    params = lm.lm_init(prng.PRNGKey(0), cfg, device="cuda")
    acfg = AnalogConfig().infer(b_adc=8)
    host = engine.compile_program(params, acfg, prng.PRNGKey(1), device="cuda")
    sharded = steps.program_for_serving(params, acfg, prng.PRNGKey(1), mesh=mesh, model_cfg=cfg)
    assert "tp" in sharded.params.blocks[0]["ffn"]["w2"]
    gathered = sharded.gather()
    for a, b in ((host.params, gathered.params), (host.state, gathered.state)):
        la, lb = _leaves(a), _leaves(b)
        assert la.keys() == lb.keys()
        assert all(torch.equal(la[k], lb[k]) for k in la)
    toks = torch.randint(0, cfg.vocab, (8, 16), device="cuda")
    out = {}
    for name, prog in (("host", host), ("sharded", sharded)):
        kernel.analog_mvm.launches = 0
        fa.flash_attention.launches = 0
        collectives.reset_stats()
        logits, _ = lm.lm_forward(engine.cast_weights(prog.params, cfg.dtype),
                                  {"tokens": toks}, prog.cfg, cfg)
        torch.cuda.synchronize()
        out[name] = (logits, kernel.analog_mvm.launches, fa.flash_attention.launches,
                     collectives.stats["calls"])
    assert torch.equal(out["host"][0], out["sharded"][0])
    assert out["host"][1:3] == out["sharded"][1:3] and out["host"][1] > 0
    assert out["host"][3] == 0 and out["sharded"][3] > 0  # the sharded path gathered


def test_sharded_serving_and_shardmap_moe_tokens(mesh):
    import numpy as np

    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serving import Request, ServingConfig, ServingEngine

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, size=int(n)), max_new_tokens=6)
            for i, n in enumerate((5, 9, 16, 3))]
    acfg = AnalogConfig().infer(b_adc=8)

    steps_run = []

    def tokens(prog, cfg, mesh_):
        rep = ServingEngine.for_program(prog, cfg, ServingConfig(n_slots=4, s_max=32),
                                        mesh=mesh_, device="cuda").run(reqs)
        steps_run.append(rep.n_steps)
        return {r.rid: rep.tokens_of(r.rid).tolist() for r in reqs}

    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.bfloat16)
    params = lm.lm_init(prng.PRNGKey(0), cfg, device="cuda")
    host = steps.program_for_serving(params, acfg, prng.PRNGKey(1))
    sharded = steps.program_for_serving(params, acfg, prng.PRNGKey(1), mesh=mesh, model_cfg=cfg)
    assert tokens(sharded, cfg, mesh) == tokens(host, cfg, None)

    moe = dataclasses.replace(get_smoke("phi3.5-moe-42b-a6.6b"), dtype=torch.bfloat16,
                              capacity_factor=8.0)
    params = lm.lm_init(prng.PRNGKey(0), moe, device="cuda")
    chip = steps.program_for_serving(params, acfg, prng.PRNGKey(1), mesh=mesh, model_cfg=moe)
    einsum = tokens(chip, moe, mesh)
    kernel.analog_mvm_bank.launches = 0
    shard_map = tokens(chip, dataclasses.replace(moe, moe_dispatch="shard_map"), mesh)
    assert shard_map == einsum
    # one bank launch a family of each MoE layer, every prefill and step
    forwards = len(reqs) + steps_run[-1]
    assert kernel.analog_mvm_bank.launches == 3 * moe.n_layers * forwards


@pytest.mark.parametrize("mode", ["digital", "analog_train"])
def test_sharded_train_step_is_the_unsharded_step(mesh, mode):
    from repro_torch import prng
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_smoke
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.common import set_logical_rules
    from repro_torch.training import optim

    set_logical_rules({})
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.bfloat16)
    acfg = AnalogConfig(tile_rows=32)
    if mode == "analog_train":
        acfg = acfg.train(eta=0.1, b_adc=6, quant_noise_p=0.5)
    ocfg = optim.OptimizerConfig(lr=1e-2, total_steps=50, warmup=0)
    params = lm.lm_init(prng.PRNGKey(0), cfg, device="cuda")
    opt = optim.init(ocfg, params)
    batch = {k: torch.randint(0, cfg.vocab, (8, 32), device="cuda") for k in ("tokens", "labels")}
    p_sh = shd.param_shardings(params, mesh, cfg, analog_cfg=acfg)
    o_sh = shd.build_opt_shardings(opt, params, p_sh, mesh)
    out = {}
    for name, step, p, o in (
            ("unsharded", steps.make_train_step(cfg, acfg, ocfg), params, opt),
            ("sharded", steps.make_train_step(cfg, acfg, ocfg, mesh=mesh, shardings=(p_sh, o_sh)),
             shd.shard_tree(params, p_sh), shd.shard_tree(opt, o_sh))):
        kernel.analog_mvm.launches = 0
        fa.flash_attention.launches = 0
        metrics = []
        for i in range(2):
            p, o, m = step(p, o, batch, prng.fold_in(prng.PRNGKey(0).to("cuda"), i))
            metrics.append(m)
        torch.cuda.synchronize()
        if name == "sharded":
            p, o = shd.gather_tree(p, p_sh), shd.gather_tree(o, o_sh)
        out[name] = (tree_lib.leaves((p, o, metrics)), kernel.analog_mvm.launches,
                     fa.flash_attention.launches)
    want, got = out["unsharded"], out["sharded"]
    assert len(want[0]) == len(got[0])
    assert all(torch.equal(a, b) for a, b in zip(want[0], got[0]))
    assert want[1:] == got[1:] and want[2] > 0 and (mode == "digital" or want[1] > 0)
