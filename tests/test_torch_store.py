"""Port parity: the cim-program v1 reader (repro_torch.checkpoint.store).

A chip programmed and saved by the JAX reference loads in the port with
every array bitwise equal; plans, ages and the chip id carry over; broken
artifacts are refused as the reference refuses them.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_smoke as j_get_smoke
from repro.core import engine as jengine
from repro.core.analog import AnalogConfig as JAnalogConfig
from repro.models import lm_init as j_lm_init
from repro_torch.checkpoint import store as tstore
from repro_torch.models.lm import LMParams

SEP = "::"


def _flat_torch(tree, prefix=""):
    """'::'-joined leaf paths of the port's params/state -> numpy arrays."""
    out = {}
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree.numpy()}
    for k, v in items:
        out.update(_flat_torch(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    return out


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = j_get_smoke("tinyllama-1.1b")
    params = j_lm_init(jax.random.PRNGKey(0), cfg)
    program = jengine.compile_program(
        params, JAnalogConfig().infer(b_adc=4), jax.random.PRNGKey(3),
        b_adc_overrides={"lm_head": 8}, chip_id=5,
    )
    path = str(tmp_path_factory.mktemp("chip") / "prog")
    jstore.save_program(path, program)
    return path, program


def test_load_program_bitwise(artifact):
    path, jprog = artifact
    prog = tstore.load_program(path, device="cpu")
    assert isinstance(prog.params, LMParams)
    want = {**{f"params{SEP}{k}": v for k, v in jstore._flatten(jprog.params).items()},
            **{f"state{SEP}{k}": v for k, v in jstore._flatten(jprog.state).items()}}
    got = {**{f"params{SEP}{k}": v for k, v in _flat_torch(prog.params).items()},
           **{f"state{SEP}{k}": v for k, v in _flat_torch(prog.state).items()}}
    assert set(got) == set(want)
    for k in want:
        if k.endswith(f"{SEP}key"):  # threefry keys: uint32 words held in int64
            assert got[k].dtype == np.int64 and want[k].dtype == np.uint32, k
            got[k] = got[k].astype(np.uint32)
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    # the lm_head override is shape-encoded: 8 bits, body at 4
    assert prog.params.lm_head["b_adc_buf"].shape[-1] == 8


def test_load_program_plans_ages_and_identity(artifact):
    path, jprog = artifact
    prog = tstore.load_program(path, device="cpu")
    assert dataclasses.asdict(prog.cfg) == dataclasses.asdict(jprog.cfg)
    assert {p: (pl.k, pl.n, pl.spec.b_adc, pl.tile_rows, pl.per_tile_adc)
            for p, pl in prog.plans.items()} == {
        p: (pl.k, pl.n, pl.spec.b_adc, pl.tile_rows, pl.per_tile_adc)
        for p, pl in jprog.plans.items()}
    assert prog.plans["lm_head"].spec.b_adc == 8
    assert prog.plans["blocks/0/ffn/w2"].spec.b_adc == 4
    assert prog.t_seconds == jprog.t_seconds
    assert prog.age_history == jprog.age_history
    assert prog.chip_id == jprog.chip_id == 5
    assert prog.mapping is None


def _edit_meta(path, fn):
    mp = os.path.join(path, "meta.json")
    with open(mp) as f:
        meta = json.load(f)
    fn(meta)
    with open(mp, "w") as f:
        json.dump(meta, f)


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def test_refuses_newer_version_missing_commit_and_bad_format(artifact, tmp_path):
    path, _ = artifact
    newer = _copy(path, tmp_path / "newer")
    _edit_meta(newer, lambda m: m.update(version=2))
    with pytest.raises(ValueError, match="newer"):
        tstore.load_program(newer, device="cpu")
    other = _copy(path, tmp_path / "other")
    _edit_meta(other, lambda m: m.update(format="something-else"))
    with pytest.raises(ValueError, match="cim-program"):
        tstore.load_program(other, device="cpu")
    uncommitted = _copy(path, tmp_path / "uncommitted")
    os.remove(os.path.join(uncommitted, "COMMIT"))
    with pytest.raises(FileNotFoundError):
        tstore.load_program(uncommitted, device="cpu")


def test_refuses_malformed_plans(artifact, tmp_path):
    path, _ = artifact
    bad_len = _copy(path, tmp_path / "bad_len")
    _edit_meta(bad_len, lambda m: m["plans"].update(lm_head=[64]))
    with pytest.raises(ValueError, match="malformed"):
        tstore.load_program(bad_len, device="cpu")
    bad_bits = _copy(path, tmp_path / "bad_bits")
    _edit_meta(bad_bits, lambda m: m["plans"].update(lm_head=[64, 256, 5]))
    with pytest.raises(ValueError, match="supported"):
        tstore.load_program(bad_bits, device="cpu")


def test_legacy_two_entry_plans_and_no_age_history(artifact, tmp_path):
    path, jprog = artifact
    legacy = _copy(path, tmp_path / "legacy")

    def strip(meta):
        meta["plans"] = {p: e[:2] for p, e in meta["plans"].items()}
        del meta["age_history"], meta["chip_id"]

    _edit_meta(legacy, strip)
    prog = tstore.load_program(legacy, device="cpu")
    # two-entry plans take the config's bitwidth
    assert {pl.spec.b_adc for pl in prog.plans.values()} == {jprog.cfg.b_adc}
    assert prog.age_history == (jprog.t_seconds,)
    assert prog.chip_id is None
    assert torch.equal(prog.params.embed["table"],
                       torch.from_numpy(np.array(jprog.params.embed["table"])))
