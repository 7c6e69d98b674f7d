"""Port parity: a chip loaded on its model's template keeps the template's
structure (``repro_torch.checkpoint.store.load_program(params_like=...)``).

A model with non-parametric norms (``nonparametric_ln=True``, olmo's flavor)
holds empty ``norm1``/``norm2`` dicts, which an artifact stores no array
for. The reference rebuilds the loaded params on the template
(``repro/checkpoint/store.py::_cast_like``); so does the port. Here the
tinyllama smoke config with ``nonparametric_ln=True`` on both sides: JAX
programs and saves the chip, the port loads it with ``params_like`` and
serves JAX's greedy tokens from it.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import clock as jclock
from repro import serving as jserving
from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.models import lm as jlm
from repro_torch import clock as tclock
from repro_torch import convert, prng
from repro_torch import serving as tserving
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.models import lm as tlm

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from test_torch_traces import numpy_trace

S_MAX = 32


@pytest.fixture(scope="module")
def chip(tmp_path_factory):
    jcfg = dataclasses.replace(j_get_smoke("tinyllama-1.1b"), nonparametric_ln=True)
    tcfg = dataclasses.replace(t_get_smoke("tinyllama-1.1b"), nonparametric_ln=True)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    jprog = jengine.compile_program(
        jparams, JAnalogConfig(tile_rows=32).infer(b_adc=6), jax.random.PRNGKey(7))
    path = str(tmp_path_factory.mktemp("chip") / "prog")
    jstore.save_program(path, jprog)
    template = tlm.lm_init(prng.PRNGKey(0), tcfg, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, jprog=jprog, path=path,
                template=template)


def test_the_template_keeps_the_empty_norms(chip):
    blocks = chip["template"].blocks
    assert blocks[0]["norm1"] == {} and blocks[0]["norm2"] == {}
    loaded = tstore.load_program(chip["path"], params_like=chip["template"], device="cpu")
    assert isinstance(loaded.params, tlm.LMParams)
    for b in loaded.params.blocks:
        assert b["norm1"] == {} and b["norm2"] == {}
    # the program phase's own leaves survive, and every stored array is JAX's
    jflat = jax.tree_util.tree_flatten_with_path(chip["jprog"].params)[0]
    assert any("out_scale_buf" in jax.tree_util.keystr(p) for p, _ in jflat)
    wq = loaded.params.blocks[0]["attn"]["wq"]
    assert "out_scale_buf" in wq
    assert np.array_equal(wq["w"].numpy(),
                          np.asarray(chip["jprog"].params.blocks[0]["attn"]["wq"]["w"]))


def test_without_the_template_the_empty_norms_are_lost(chip):
    """The behaviour without ``params_like`` stays: the tree is the
    artifact's arrays alone."""
    loaded = tstore.load_program(chip["path"], device="cpu")
    assert "norm1" not in loaded.params.blocks[0]


def test_the_loaded_chip_serves_jaxs_tokens(chip):
    c = chip
    trace = numpy_trace(5, 5, vocab=c["tcfg"].vocab, rate=400.0, prompt_lens=(4, 8),
                        new_tokens=(3, 6))
    jtrace = [jserving.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                               arrival_t=r.arrival_t) for r in trace]
    jrep = jserving.ServingEngine.for_program(
        c["jprog"], c["jcfg"], jserving.ServingConfig(n_slots=2, s_max=S_MAX),
        ref_params=c["jparams"]).run(jtrace, clock=jclock.VirtualClock())
    loaded = tstore.load_program(c["path"], params_like=c["template"], device="cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, c["jparams"]), c["tcfg"],
                                        device="cpu")
    trep = tserving.ServingEngine.for_program(
        loaded, c["tcfg"], tserving.ServingConfig(n_slots=2, s_max=S_MAX),
        ref_params=tparams, device="cpu").run(trace, clock=tclock.VirtualClock())
    assert trep.n_requests == jrep.n_requests == len(trace)
    for r in trace:
        assert np.array_equal(trep.tokens_of(r.rid), jrep.tokens_of(r.rid)), r.rid
    assert trep.counters["decisions"] == jrep.counters["decisions"]
    assert abs(trep.counters["top1"] - jrep.counters["top1"]) <= 1e-5
