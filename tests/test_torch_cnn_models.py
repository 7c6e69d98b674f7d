"""The CNN path's helpers and hardware models in the port against the
reference, on the CPU.

* ``im2col`` bitwise at strides 1 and 2 on odd and even sizes (XLA's
  "SAME" padding puts the odd pixel after: at stride 2 on width 10 it pads
  (0, 1), where a symmetric pad of 1 would shift every patch), and
  ``conv_weight_as_matrix`` and ``depthwise_densify`` bitwise;
* ``map_layers``, ``mapping_to_dict``, ``mapping_from_dict`` and
  ``occupancy_grid`` equal for KWS, VWW, VWW with bottlenecks,
  MicroNet-KWS-S and random layer lists;
* the AON-CiM models (``aoncim.model_perf``, ``calibrate``,
  ``pipeline_sim.simulate``) equal at 4, 6 and 8 bits (the same Python
  arithmetic: every float is the reference's);
* the port's copies of the hardware-model benchmarks print the
  reference's rows string for string, and the port's ``bench.pipeline``
  the reference's ``pipeline_*`` rows and bitwidth-sweep agreements;
* ``heuristic_ranges``: the DAC range bitwise; the ADC range within 4 f32
  ulps (it multiplies two standard deviations, each the correctly rounded
  value in the port and up to 2 ulps off it in the reference's f32 sums);
* write-verify programming bitwise (the reference jitted: its compiler
  fuses the loop's products into its sums).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.core import aoncim as jaoncim
from repro.core import crossbar as jcb
from repro.core import heuristic_ranges as jhr
from repro.core import pipeline_sim as jps
from repro.core import programming as jprog
from repro.models import analognet as jan
from repro.models import micronet as jmn
from repro_torch import prng
from repro_torch.core import aoncim as taoncim
from repro_torch.core import crossbar as tcb
from repro_torch.core import heuristic_ranges as thr
from repro_torch.core import pipeline_sim as tps
from repro_torch.core import programming as tprog
from repro_torch.models import analognet as tan
from repro_torch.models import micronet as tmn


@pytest.mark.parametrize("h,w,c,k,stride", [
    (49, 10, 1, 3, 1), (49, 10, 5, 3, 2), (25, 5, 3, 3, 2), (10, 10, 2, 3, 2),
    (9, 9, 2, 3, 2), (100, 100, 3, 3, 2), (7, 8, 4, 1, 1), (8, 7, 3, 1, 2),
])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_im2col_bitwise(h, w, c, k, stride, padding):
    x = np.random.default_rng(h * w + c).standard_normal((2, h, w, c)).astype(np.float32)
    want = np.asarray(jcb.im2col(jnp.asarray(x), k, k, stride, padding))
    got = tcb.im2col(torch.from_numpy(x), k, k, stride, padding).numpy()
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_kernel_blocks_bitwise():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 3, 7, 5)).astype(np.float32)
    assert (tcb.conv_weight_as_matrix(torch.from_numpy(w)).numpy().tobytes()
            == np.asarray(jcb.conv_weight_as_matrix(jnp.asarray(w))).tobytes())
    dw = rng.standard_normal((3, 3, 6, 1)).astype(np.float32)
    want = np.asarray(jcb.depthwise_densify(jnp.asarray(dw)))
    got = tcb.depthwise_densify(torch.from_numpy(dw)).numpy()
    assert got.shape == want.shape == (54, 6) and got.tobytes() == want.tobytes()


def _layer_lists():
    lists = {
        "kws": (jan.layer_shapes(jan.analognet_kws_config()),
                tan.layer_shapes(tan.analognet_kws_config())),
        "vww": (jan.layer_shapes(jan.analognet_vww_config()),
                tan.layer_shapes(tan.analognet_vww_config())),
        "vww_bneck": (jan.layer_shapes(jan.analognet_vww_config(True)),
                      tan.layer_shapes(tan.analognet_vww_config(True))),
        "micronet": (jmn.micronet_layer_shapes(jmn.micronet_kws_s_config()),
                     tmn.micronet_layer_shapes(tmn.micronet_kws_s_config())),
        "micronet_64": (jmn.micronet_layer_shapes(jmn.micronet_kws_s_config(), 64, 64),
                        tmn.micronet_layer_shapes(tmn.micronet_kws_s_config(), 64, 64)),
    }
    rng = np.random.default_rng(7)
    for i in range(3):
        rows = [int(v) for v in rng.integers(1, 3000, 12)]
        cols = [int(v) for v in rng.integers(1, 900, 12)]
        spec = [(f"l{j}", r, c, int(rng.integers(1, 50))) for j, (r, c) in enumerate(zip(rows, cols))]
        lists[f"random{i}"] = ([jcb.LayerShape(*s) for s in spec],
                               [tcb.LayerShape(*s) for s in spec])
    return lists


LISTS = _layer_lists()


@pytest.mark.parametrize("name", sorted(LISTS))
def test_mappings_equal(name):
    jl, tl = LISTS[name]
    assert [dataclasses.asdict(s) for s in jl] == [dataclasses.asdict(s) for s in tl]
    for rows, cols in ((1024, 512), (128, 128), (64, 64)):
        jm, tm = jcb.map_layers(jl, rows, cols), tcb.map_layers(tl, rows, cols)
        d = tcb.mapping_to_dict(tm)
        assert d == jcb.mapping_to_dict(jm)
        assert tcb.mapping_to_dict(tcb.mapping_from_dict(d)) == d
        assert jcb.mapping_to_dict(jcb.mapping_from_dict(d)) == d
        assert (tm.utilization, tm.occupancy, tm.n_arrays) == (
            jm.utilization, jm.occupancy, jm.n_arrays)
        for a in range(tm.n_arrays):
            assert np.array_equal(tcb.occupancy_grid(tm, a), jcb.occupancy_grid(jm, a))
        with pytest.raises(ValueError, match="out of range"):
            tcb.occupancy_grid(tm, tm.n_arrays)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_aoncim_models_equal(bits):
    for name in ("kws", "vww", "micronet"):
        jl, tl = LISTS[name]
        jp, tp = jaoncim.model_perf(jl, bits), taoncim.model_perf(tl, bits)
        for key in ("latency_s", "energy_j", "ops", "inf_per_s", "tops", "tops_per_w",
                    "uj_per_inf"):
            assert getattr(tp, key) == getattr(jp, key), (name, key)
        for jlp, tlp in zip(jp.layers, tp.layers):
            assert (tlp.phases_per_mvm, tlp.cycles, tlp.latency_s, tlp.energy_j, tlp.ops) == (
                jlp.phases_per_mvm, jlp.cycles, jlp.latency_s, jlp.energy_j, jlp.ops)
        for clock in (800e6, 100e6):
            jr = jps.simulate(jl, bits, jps.PipelineConfig(digital_clock_hz=clock))
            tr = tps.simulate(tl, bits, tps.PipelineConfig(digital_clock_hz=clock))
            assert [dataclasses.asdict(x) for x in tr.layers] == [
                dataclasses.asdict(x) for x in jr.layers]
            assert (tr.stall_fraction, tr.latency_s) == (jr.stall_fraction, jr.latency_s)
    assert (taoncim.peak_tops(bits), taoncim.peak_power_w(bits), taoncim.e_phase_full(bits)) == (
        jaoncim.peak_tops(bits), jaoncim.peak_power_w(bits), jaoncim.e_phase_full(bits))
    js = jaoncim.calibrate(LISTS["kws"][0], LISTS["vww"][0], bits=bits)
    ts = taoncim.calibrate(LISTS["kws"][1], LISTS["vww"][1], bits=bits)
    assert (ts.adc_frac, ts.row_frac, ts.dig_frac) == (js.adc_frac, js.row_frac, js.dig_frac)


@pytest.mark.parametrize("bench", ["table2_aoncim", "table3_depthwise", "fig8_layerwise"])
def test_hardware_bench_rows_equal(bench):
    import importlib

    want = importlib.import_module(f"benchmarks.{bench}").run()
    got = importlib.import_module(f"repro_torch.bench.{bench}").run()
    assert got == want


def test_pipeline_bench_rows():
    from benchmarks import pipeline_bench as jpb
    from benchmarks.common import KWS_BENCH as J_KWS_BENCH
    from repro_torch.bench import pipeline as tpb

    got = tpb.run(fast=True, device="cpu")
    assert got[:6] == _reference_pipeline_rows(jpb)
    names = [r.split(",")[0] for r in got[6:]]
    assert names == ["serve_percall_pcm", "serve_programmed_pcm", "serve_programmed_pcm_b4",
                     "serve_programmed_pcm_b6", "serve_programmed_pcm_b8", "serve_drift_24h"]
    params = jan.cnn_init(jax.random.PRNGKey(0), J_KWS_BENCH)
    want_sweep = [r.split(",")[2] for r in jpb._bitwidth_sweep_rows(params, J_KWS_BENCH, 1)]
    assert [r.split(",")[2] for r in got[8:11]] == want_sweep
    # the trained-model row (held against the reference's in test_torch_bench_trained.py)
    assert got[11].endswith("_chips=4_program_events=0")


def _reference_pipeline_rows(jpb) -> list[str]:
    """The reference's ``pipeline_*`` rows (its ``run`` without the serving
    rows, which train a model)."""
    rows = []
    for name, cfg in (("kws", jan.analognet_kws_config()), ("vww", jan.analognet_vww_config())):
        shapes = jan.layer_shapes(cfg)
        for bits in (8, 6, 4):
            rep = jpb.simulate(shapes, bits)
            slow = jpb.simulate(shapes, bits, jpb.PipelineConfig(digital_clock_hz=100e6))
            rows.append(jpb.csv_row(
                f"pipeline_{name}_{bits}b", rep.latency_s * 1e6,
                f"stall={rep.stall_fraction*100:.1f}%"
                f"_at100MHz={slow.stall_fraction*100:.1f}%"))
    return rows


def _ulps(a, b) -> int:
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def test_heuristic_ranges():
    rng = np.random.default_rng(1)
    for _ in range(12):
        n = int(rng.integers(2, 30000))
        x = (rng.standard_normal(n) * 10 ** rng.uniform(-3, 2)).astype(np.float32)
        w = (rng.standard_normal((int(rng.integers(5, 2000)), 24)) * 0.1).astype(np.float32)
        jd, ja = jhr.heuristic_ranges(jnp.asarray(x), jnp.asarray(w))
        td, ta = thr.heuristic_ranges(torch.from_numpy(x), torch.from_numpy(w))
        assert np.float32(jd).tobytes() == td.numpy().tobytes()
        assert _ulps(ja, ta.item()) <= 4
    params = tan.cnn_init(prng.PRNGKey(0), tan.analognet_kws_config(), device="cpu")
    jparams = jan.cnn_init(jax.random.PRNGKey(0), jan.analognet_kws_config())
    acts = {"conv2": rng.standard_normal((4, 954)).astype(np.float32),
            "fc": rng.standard_normal((4, 106)).astype(np.float32)}
    jnew = jhr.calibrate_model_ranges(jparams, {k: jnp.asarray(v) for k, v in acts.items()})
    tnew = thr.calibrate_model_ranges(params, {k: torch.from_numpy(v) for k, v in acts.items()})
    for name in acts:
        assert _ulps(jnew[name]["r_adc"], tnew[name]["r_adc"].item()) <= 4
    assert abs(float(jnew["gain_s"]) - tnew["gain_s"].item()) <= 1e-5 * float(jnew["gain_s"])
    assert tnew["conv1"]["r_adc"] is params["conv1"]["r_adc"]


def test_write_verify_bitwise():
    rng = np.random.default_rng(0)
    g = rng.uniform(0, 1, (64, 48)).astype(np.float32)
    wv = jax.jit(jprog.program_write_verify)
    for seed in (0, 1):
        jg, jc = wv(jax.random.PRNGKey(seed), jnp.asarray(g))
        tg, tc = tprog.program_write_verify(prng.PRNGKey(seed), torch.from_numpy(g))
        assert tg.numpy().tobytes() == np.asarray(jg).tobytes()
        assert np.array_equal(tc.numpy(), np.asarray(jc))
    w = (rng.standard_normal((70, 33)) * 0.3).astype(np.float32)
    cfg = tprog.WriteVerifyConfig(n_iter=4, tol=0.002)
    jcfg = jprog.WriteVerifyConfig(n_iter=4, tol=0.002)
    sim = jax.jit(lambda k, w: jprog.simulate_weights_write_verify(k, w, 86400.0, wv=jcfg))
    want = sim(jax.random.PRNGKey(3), jnp.asarray(w))
    got = tprog.simulate_weights_write_verify(prng.PRNGKey(3), torch.from_numpy(w), 86400.0,
                                              wv=cfg)
    for a, b in zip(want, got):
        assert b.numpy().tobytes() == np.asarray(a).tobytes()
    assert 0.0 < float(got[2]) < 1.0  # a tight band leaves some devices unconverged
