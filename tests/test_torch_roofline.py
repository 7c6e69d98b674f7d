"""The port's roofline (``repro_torch.analysis.roofline``) and collective
ring factors (``repro_torch.collectives.wire_bytes``) against the
reference's ``repro.analysis.roofline`` and ``repro.analysis.hlo``.

``model_flops``, ``model_bytes`` and ``active_params`` are bitwise the
reference's for every arch x shape cell; every ``Roofline`` property and
``row()`` equal the reference's on the same inputs once the reference
module's peaks are the port's (monkeypatched for the test; no file
changes); the port's peaks are an H100 SXM's at 700 W, not a TPU's; and
the wire bytes of each collective kind equal what ``collective_stats``
reads off a synthetic HLO line of the same op, shape and group. ~5 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroof
from repro.configs import shapes as jshapes
from repro.models import lm as jlm
from repro_torch import collectives
from repro_torch import configs as tconfigs
from repro_torch.analysis import roofline as troof
from repro_torch.configs import shapes as tshapes

ARCHS = list(jconfigs.LM_ARCHS)


def _n_params(cfg) -> int:
    shapes = jax.eval_shape(lambda k: jlm.lm_init(k, cfg), jax.ShapeDtypeStruct((2,), jnp.uint32))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_peaks_are_the_h100s():
    assert (troof.PEAK_FLOPS_BF16, troof.HBM_BW, troof.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert "H100" in troof.__doc__ and "700 W" in troof.__doc__ and "H100" in troof.CARD
    assert (jroof.PEAK_FLOPS_BF16, jroof.HBM_BW, jroof.LINK_BW) != (
        troof.PEAK_FLOPS_BF16, troof.HBM_BW, troof.LINK_BW)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_bytes_and_active_params_are_the_references(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    n = _n_params(jcfg)
    assert troof.active_params(tcfg, n) == jroof.active_params(jcfg, n)
    active = jroof.active_params(jcfg, n)
    for shape in jshapes.SHAPES:
        jcell, tcell = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
        got = troof.model_flops(tcfg, n, active, tcell)
        want = jroof.model_flops(jcfg, n, active, jcell)
        assert np.float64(got).tobytes() == np.float64(want).tobytes()
        for cache_bytes, param_bytes in ((0.0, 2.0 * n), (3.5e9, 4.0 * n)):
            got = troof.model_bytes(tcell, cache_bytes, param_bytes, n, active)
            want = jroof.model_bytes(jcell, cache_bytes, param_bytes, n, active)
            assert np.float64(got).tobytes() == np.float64(want).tobytes()


CASES = [  # (flops, bytes, wire bytes, chips, model flops, model bytes): each term dominant
    (4.2e15, 1.1e12, 3.0e9, 256, 6.1e17, 9.0e11),
    (1.0e12, 9.9e11, 1.0e8, 1, 2.0e12, 8.0e11),
    (1.0e12, 1.0e9, 7.7e10, 4, 3.0e12, 1.0e9),
    (0.0, 0.0, 0.0, 1, 0.0, 0.0),
]


@pytest.mark.parametrize("case", CASES)
def test_roofline_is_the_references_at_the_cards_peaks(monkeypatch, case):
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroof, name, getattr(troof, name))
    flops, nbytes, wire, chips, mf, mb = case
    kw = dict(arch="a", shape="s", mesh="m", chips=chips, flops_per_dev=flops,
              bytes_per_dev=nbytes, wire_bytes_per_dev=wire, model_flops_total=mf,
              collective_counts={"all-gather": 3}, model_bytes_total=mb)
    got, want = troof.Roofline(**kw), jroof.Roofline(**kw)
    for prop in ("t_compute", "t_memory", "t_collective", "bottleneck", "t_step",
                 "useful_flops_fraction", "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.row() == want.row()


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind,hlo_op", [("all-gather", "all-gather"),
                                         ("all-reduce", "all-reduce"),
                                         ("all-to-all", "all-to-all")])
def test_wire_bytes_are_hlo_collective_stats(kind, hlo_op, g):
    """The port counts an all-gather by its gathered bytes, an all-reduce
    and an all-to-all by their operand's: the reference's HLO line names the
    result shape, which is the gathered tensor, or the operand's shape."""
    elems = 1024 * g
    line = (f"  %c = f32[{elems}]{{0}} {hlo_op}(%a), channel_id=1, "
            f"replica_groups=[{64 // g},{g}]<=[64], to_apply=%sum\n")
    stats = jhlo.collective_stats(line)
    operand, wire = collectives.wire_bytes(kind, elems * 4, g)
    assert stats.counts == {hlo_op: 1}
    assert operand == stats.operand_bytes[hlo_op]
    assert wire == pytest.approx(stats.wire_bytes[hlo_op], rel=0, abs=0)
