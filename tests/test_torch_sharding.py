"""The port's placement rules (``repro_torch.launch.sharding``, ``mesh``)
against the reference's, with no process group.

For every registered arch's param tree -- the smoke config's real tensors
from both packages' ``lm_init``, and the full-size tree from
``jax.eval_shape`` -- on the meshes (2, 4), (1, 4), (16, 16) and
(2, 16, 16), for serving and training and for the ``2d`` and ``dp``
layouts, the port's spec of each leaf is the reference's
``PartitionSpec`` entry by entry; so are ``batch_shardings``,
``cache_shardings``, ``logical_rules`` and ``build_opt_shardings``. The
reference's functions read only ``mesh.axis_names`` and ``mesh.shape``, so
a ``jax.sharding.AbstractMesh`` gives them the shape and nothing of the
reference changes. Then the port's own crossbar rule (tile-aligned row
splits, including an uneven split and a weight with fewer tiles than
ranks) and ``make_serving_mesh``'s contract.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshd
from repro.models import analognet as janalognet
from repro.models import lm as jlm
from repro.training import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.models import analognet as tanalognet
from repro_torch.models import lm as tlm

SHAPES = [(2, 4), (1, 4), (16, 16), (2, 16, 16)]


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes():
    """(reference's stand-in mesh, the port's layout) of every mesh shape."""
    return [(AbstractMesh(s, _names(s)), tmesh.MeshLayout(_names(s), s)) for s in SHAPES]


def _jspecs(tree):
    return [tuple(sh.spec) for sh in jax.tree.leaves(tree)]


def _tspecs(tree):
    return [sh.spec for sh in tree_lib.leaves(tree)]


def _trees(arch: str, size: str):
    """(reference tree, port tree, reference cfg, port cfg): the
    reference's shapes (``jax.eval_shape``); at ``smoke`` the port's own
    tensors (a CNN has one size: ``smoke`` its tensors, ``full`` the
    reference's shapes on both sides)."""
    key = jax.random.PRNGKey(0)
    if arch in jconfigs.CNN_ARCHS:
        jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
        jtree = jax.eval_shape(lambda: janalognet.cnn_init(key, jcfg))
        if size == "full":
            return jtree, jtree, jcfg, tcfg
        return jtree, tanalognet.cnn_init(prng.PRNGKey(0), tcfg, device="cpu"), jcfg, tcfg
    jcfg = jconfigs.get(arch) if size == "full" else jconfigs.get_smoke(arch)
    tcfg = tconfigs.get(arch) if size == "full" else tconfigs.get_smoke(arch)
    jtree = jax.eval_shape(lambda: jlm.lm_init(key, jcfg))
    if size == "full":
        return jtree, jtree, jcfg, tcfg
    return jtree, tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu"), jcfg, tcfg


ARCHS = list(tconfigs.ALL_ARCHS)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references(arch, size):
    jtree, ttree, jcfg, tcfg = _trees(arch, size)
    n_leaves = len(jax.tree.leaves(jtree))
    assert len(tree_lib.leaves(ttree)) == n_leaves
    split = 0
    for amesh, lay in _meshes():
        for layout in ("2d", "dp"):
            for inference in (False, True):
                want = _jspecs(jshd.param_shardings(jtree, amesh, jcfg, inference, layout))
                got = _tspecs(tshd.param_shardings(ttree, lay, tcfg, inference, layout))
                assert got == want, (arch, size, lay, layout, inference)
                split += sum(any(e is not None for e in s) for s in got)
        # the program phase's layout is the serving one
        want = _jspecs(jshd.param_shardings(jtree, amesh, jcfg, inference=True))
        assert _tspecs(tshd.program_shardings(ttree, lay, tcfg)) == want
    assert split > 0  # something is really sharded


@pytest.mark.parametrize("arch", [a for a in ARCHS if a in tconfigs.LM_ARCHS])
def test_batch_cache_rules_and_optimizer_specs_are_the_references(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jparams = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    for amesh, lay in _meshes():
        for layout in ("2d", "dp"):
            assert tshd.logical_rules(lay, tcfg, layout) == jshd.logical_rules(amesh, jcfg, layout)
        assert tshd.logical_rules(lay) == jshd.logical_rules(amesh)
        for b in (1, 2, 4, 16, 32, 512):
            batch = {"tokens": jax.ShapeDtypeStruct((b, 8), jnp.int32),
                     "labels": jax.ShapeDtypeStruct((b, 8), jnp.int32),
                     "frames": jax.ShapeDtypeStruct((b, 8, 64), jnp.float32),
                     "patches": jax.ShapeDtypeStruct((b, 4, 64), jnp.float32)}
            for layout in ("2d", "dp"):
                assert (_tspecs(tshd.batch_shardings(batch, lay, layout))
                        == _jspecs(jshd.batch_shardings(batch, amesh, layout)))
                assert tshd.batch_axis(lay, b, layout) == jshd.batch_axis(amesh, b, layout)
        for b in (1, 4, 16, 32):
            cache = jax.eval_shape(lambda b=b: jlm.init_lm_cache(jcfg, b, 32, jnp.float32))
            assert (_tspecs(tshd.cache_shardings(cache, lay, b))
                    == _jspecs(jshd.cache_shardings(cache, amesh, b)))
        shards_j = jshd.param_shardings(jparams, amesh, jcfg)
        shards_t = tshd.param_shardings(jparams, lay, tcfg)
        for kind in ("adamw", "adafactor"):
            opt = jax.eval_shape(lambda k=kind: joptim.init(joptim.OptimizerConfig(kind=k),
                                                            jparams))
            want = jshd.build_opt_shardings(opt, jparams, shards_j, amesh)
            got = tshd.build_opt_shardings(opt, jparams, shards_t, lay)
            assert got.step.spec == tuple(want.step.spec)
            for field in ("m", "v", "v_col"):
                assert (_tspecs(getattr(got, field))
                        == _jspecs(getattr(want, field))), (arch, lay, kind, field)


def test_tile_bounds_cut_rows_at_crossbar_tiles():
    # tinyllama-1.1b's w2: 6 tiles over 2 ranks are 3 + 3 (3,072 + 2,560 rows)
    assert tshd.tile_bounds(5632, 2, 1024) == (0, 3072, 5632)
    assert tshd.tile_bounds(5632, 4, 1024) == (0, 2048, 4096, 5120, 5632)
    assert tshd.tile_bounds(5 * 1024, 2, 1024) == (0, 3072, 5120)  # uneven: 3 + 2 tiles
    assert tshd.tile_bounds(128, 4, 32) == (0, 32, 64, 96, 128)
    assert tshd.tile_bounds(64, 2, 32) == (0, 32, 64)
    # fewer tiles than ranks, one tile, or one ADC over all of K: rows stay whole
    assert tshd.tile_bounds(2048, 4, 1024) is None
    assert tshd.tile_bounds(1024, 2, 1024) is None
    assert tshd.tile_bounds(5632, 2, 1024, per_tile_adc=False) is None


def test_layer_split_applies_the_crossbar_rule():
    row = (None, "model", None)  # a stacked row-parallel weight's spec
    sp = tshd.layer_split(row, (22, 5632, 2048), 2, 1, 1024, True)
    assert (sp.dim, sp.bounds, sp.start, sp.stop) == (-2, (0, 3072, 5632), 3072, 5632)
    # fewer tiles than ranks: the rank computes its columns from the whole input
    sp = tshd.layer_split(row, (2, 64, 64), 4, 2, 32, True)
    assert (sp.dim, sp.bounds) == (-1, (0, 16, 32, 48, 64))
    sp = tshd.layer_split(row, (2, 128, 64), 2, 0, 32, False)
    assert (sp.dim, sp.bounds) == (-1, (0, 32, 64))
    assert tshd.layer_split(row, (2, 64, 63), 4, 0, 32, True) is None  # nor columns
    sp = tshd.layer_split((None, None, "model"), (2, 64, 256), 4, 3, 32, True)
    assert (sp.dim, sp.bounds, sp.start) == (-1, (0, 64, 128, 192, 256), 192)
    sp = tshd.layer_split((None, "model", None, None), (2, 8, 64, 128), 4, 1, 32, True, bank=True)
    assert (sp.dim, sp.bounds, sp.start, sp.stop) == (-3, (0, 2, 4, 6, 8), 2, 4)
    assert tshd.layer_split((), (64, 64), 2, 0, 32, True) is None
    t = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(tshd.Split(-1, (0, 2, 4), 1).take(t), t[..., 2:])
    assert tshd.Split(-1, (0, 32, 64), 0).aligned(16) and not tshd.Split(-1, (0, 8, 16), 0).aligned(16)


def test_make_serving_mesh_contract():
    # the reference's contract (tests/test_sharded_program.py) on the layouts
    for n in (1, 2, 4, 8):
        lay = tmesh.serving_layout(n)
        assert lay.axis_names == ("data", "model")
        assert lay.shape["model"] == n and lay.shape["data"] == 1
        lay3 = tmesh.serving_layout(n, 3)  # non-divisor degrees round down
        assert n % lay3.shape["model"] == 0 and lay3.size == n
    assert tmesh.serving_layout(8, 3).shape == {"data": 4, "model": 2}
    assert tmesh.serving_layout(4, 9).shape == {"data": 1, "model": 4}
    # against the reference's functions over this process's devices
    jm = jmesh.make_serving_mesh()
    assert tmesh.layout_of(jm) == tmesh.serving_layout(len(jax.devices()))
    assert tmesh.layout_of(jmesh.make_host_mesh(2)) == tmesh.host_layout(len(jax.devices()), 2)
    assert tmesh.host_layout(8, 2).shape == {"data": 4, "model": 2}
    assert tmesh.production_layout().shape == {"data": 16, "model": 16}
    assert tmesh.production_layout(multi_pod=True).sizes == (2, 16, 16)
    assert tmesh.production_layout(multi_pod=True).axis_names == ("pod", "data", "model")


def test_device_meshes_need_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    for make in (tmesh.make_serving_mesh, tmesh.make_host_mesh, tmesh.make_production_mesh):
        with pytest.raises(RuntimeError, match="torchrun"):
            make()
