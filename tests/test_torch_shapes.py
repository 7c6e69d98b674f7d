"""The dry run's shape cells and input specs (``repro_torch.configs.shapes``)
against the reference's (``repro.configs.shapes``), for all 10 LM archs
at full size and the 4 shape cells: ``applicable``, every batch and cache
spec's shape and dtype (the cache stacked and unstacked), and the
full-width parameter count of a fake ``lm_init`` against
``jax.eval_shape(lm_init)``'s. Nothing is allocated on either side: the
reference's specs are ``ShapeDtypeStruct``s, the port's are made on fake
tensors. ~15 s alone, most of it JAX tracing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch import tree as tree_lib
from repro_torch.configs import shapes as tshapes
from repro_torch.models import lm as tlm

ARCHS = list(jconfigs.LM_ARCHS)
DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32}


def _jleaves(tree) -> list:
    return [(tuple(x.shape), DTYPES[jnp.dtype(x.dtype)]) for x in jax.tree.leaves(tree)]


def _tleaves(tree) -> list:
    return [(tuple(x.shape), x.dtype) for x in tree_lib.leaves(tree)]


def test_registries_agree():
    assert list(tconfigs.LM_ARCHS) == ARCHS
    assert tconfigs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    assert {k: v.__dict__ for k, v in tshapes.SHAPES.items()} == {
        k: v.__dict__ for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_and_specs_are_the_references(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for shape in jshapes.SHAPES:
        assert tshapes.applicable(arch, shape) == jshapes.applicable(arch, shape)
        want, got = jshapes.input_specs(jcfg, shape), tshapes.input_specs(tcfg, shape)
        assert set(got) == set(want)
        assert sorted(got["batch"]) == sorted(want["batch"])
        for k in want["batch"]:
            assert _tleaves(got["batch"][k]) == _jleaves(want["batch"][k]), (shape, k)
        if "cache" in want:
            assert _tleaves(got["cache"]) == _jleaves(want["cache"]), shape
    # the cache in both layouts at a cut size (the cells use one each)
    for stacked in (True, False):
        want = jshapes.cache_specs(jcfg, 3, 40, stacked=stacked)
        assert _tleaves(tshapes.cache_specs(tcfg, 3, 40, stacked=stacked)) == _jleaves(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_count_is_the_references(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    shapes = jax.eval_shape(lambda k: jlm.lm_init(k, jcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    with FakeTensorMode():
        params = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
        got = sum(t.numel() for t in tree_lib.leaves(params))
    assert got == want


def test_specs_make_fake_tensors():
    cfg = tconfigs.get("tinyllama-1.1b")
    specs = tshapes.input_specs(cfg, "decode_32k")
    with FakeTensorMode():
        made = [s.make("cpu") for s in tree_lib.leaves(specs)]
    assert _tleaves(made) == [(s.shape, s.dtype) for s in tree_lib.leaves(specs)]
    # layers x ((k, v) x B x S x kv heads x hd x bf16 + an int32 length)
    assert sum(s.nbytes for s in tree_lib.leaves(specs["cache"])) == 22 * (
        2 * 128 * 32768 * 4 * 64 * 2 + 4)
