"""AON-CiM accelerator performance/energy model (paper Sec. 5, Table 2, Fig. 8),
port of ``repro.core.aoncim`` (numpy only, its own copy).

Every latency, TOPS and TOPS/W figure here is the MODELLED AON-CiM
accelerator's (a 1024 x 512 PCM array at 130/34/10 ns per conversion
phase), not a measurement of the card the port runs on.

Layer-serial execution model: the whole network lives in one (or, for the
LM-scale generalization, several) 1024 x 512 PCM array(s); layers execute one
at a time; the digital pipeline (FP scaling, BN, ReLU, pooling, IM2COL, SRAM)
is designed to never stall the array (Sec. 5.2), so the array cycle time fully
determines latency.

Cycle model
-----------
The 4-input analog column mux gives 128 ADCs for 512 columns, so one MVM of a
layer occupying ``C_act`` physical columns (across all of its row tiles)
requires ``ceil(C_act / 128)`` conversion phases of ``T_CiM(bits)`` each:
130/34/10 ns at 8/6/4-bit activations (PWM DAC latency is exponential in
bitwidth). Peak throughput therefore is

    1024 * 512 * 2 ops / (4 * T_CiM)  =  2.02 / 7.71 / 26.21 TOPS,

matching Table 2's peak numbers exactly.

Energy model
------------
Per conversion phase:  E_phase = n_adc * E_adc(b) + n_rows * E_row(b) + E_dig(b)
with unused DACs/ADCs clock-gated (Sec. 5.2). The total at full utilization is
anchored to the paper's peak TOPS/W (13.55 / 45.55 / 112.44 at 8/6/4 b); the
split between ADC / row-drive / digital is calibrated against the model-level
anchors (KWS 8.58/26.76/57.39, VWW 4.37/12.82/25.69 TOPS/W) -- see
``calibrate`` and bench/table2_aoncim.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.crossbar import LayerShape, Mapping, map_layers

T_CIM = {8: 130e-9, 6: 34e-9, 4: 10e-9}  # s, per conversion phase (Table 2)
ARRAY_ROWS = 1024
ARRAY_COLS = 512
N_ADC = ARRAY_COLS // 4  # Mux4
PEAK_TOPS_PER_W = {8: 13.55, 6: 45.55, 4: 112.44}  # Table 2 anchors


def peak_tops(bits: int) -> float:
    return ARRAY_ROWS * ARRAY_COLS * 2 / (4 * T_CIM[bits]) / 1e12


def peak_power_w(bits: int) -> float:
    return peak_tops(bits) / PEAK_TOPS_PER_W[bits]


def e_phase_full(bits: int) -> float:
    """Energy of one full-array conversion phase (J)."""
    return peak_power_w(bits) * T_CIM[bits]


@dataclasses.dataclass(frozen=True)
class EnergySplit:
    """Fractions of the full-phase energy attributed to each component.

    adc_frac: 128 ADC conversions; row_frac: 1024 PWM row drives;
    dig_frac: digital pipeline + SRAM + control (per phase, utilization-
    independent). adc + row + dig = 1.
    """

    adc_frac: float = 0.60
    row_frac: float = 0.25

    @property
    def dig_frac(self) -> float:
        return 1.0 - self.adc_frac - self.row_frac

    def e_adc(self, bits: int) -> float:
        return self.adc_frac * e_phase_full(bits) / N_ADC

    def e_row(self, bits: int) -> float:
        return self.row_frac * e_phase_full(bits) / ARRAY_ROWS

    def e_dig(self, bits: int) -> float:
        return self.dig_frac * e_phase_full(bits)


# Calibrated against the reconstructed AnalogNets (see
# bench/table2_aoncim.py --calibrate); falls back to physical priors
# (ADC-dominant, cf. Sec. 5.2 "ADCs consume more area/energy than DACs").
DEFAULT_SPLIT = EnergySplit()


@dataclasses.dataclass(frozen=True)
class LayerPerf:
    layer: LayerShape
    phases_per_mvm: int
    cycles: int
    latency_s: float
    energy_j: float
    ops: int

    @property
    def tops(self) -> float:
        return self.ops / self.latency_s / 1e12

    @property
    def tops_per_w(self) -> float:
        return self.ops / self.energy_j / 1e12


@dataclasses.dataclass(frozen=True)
class ModelPerf:
    layers: list[LayerPerf]
    mapping: Mapping
    bits: int

    @property
    def latency_s(self) -> float:
        return sum(l.latency_s for l in self.layers)  # layer-serial

    @property
    def energy_j(self) -> float:
        return sum(l.energy_j for l in self.layers)

    @property
    def ops(self) -> int:
        return sum(l.ops for l in self.layers)

    @property
    def inf_per_s(self) -> float:
        return 1.0 / self.latency_s

    @property
    def tops(self) -> float:
        return self.ops / self.latency_s / 1e12

    @property
    def tops_per_w(self) -> float:
        return self.ops / self.energy_j / 1e12

    @property
    def uj_per_inf(self) -> float:
        return self.energy_j * 1e6


def layer_perf(
    layer: LayerShape,
    bits: int,
    split: EnergySplit = DEFAULT_SPLIT,
    array_rows: int = ARRAY_ROWS,
    array_cols: int = ARRAY_COLS,
) -> LayerPerf:
    """Latency/energy of one layer in layer-serial execution."""
    n_row_tiles = math.ceil(layer.rows / array_rows)
    n_col_strips = math.ceil(layer.cols / array_cols)
    # Physical columns occupied across all row tiles & column strips.
    cols_active = 0
    row_drives = 0  # (row, phase) products summed over blocks
    adcs_per_phase = array_cols // 4
    for rt in range(n_row_tiles):
        r = min(array_rows, layer.rows - rt * array_rows)
        for cs in range(n_col_strips):
            c = min(array_cols, layer.cols - cs * array_cols)
            cols_active += c
            row_drives += r * math.ceil(c / adcs_per_phase)
    phases = math.ceil(cols_active / adcs_per_phase)
    cycles = layer.n_patches * phases
    latency = cycles * T_CIM[bits]
    e_mvm = (
        cols_active * split.e_adc(bits)
        + row_drives * split.e_row(bits)
        + phases * split.e_dig(bits)
    )
    energy = layer.n_patches * e_mvm
    ops = 2 * layer.macs
    return LayerPerf(layer, phases, cycles, latency, energy, ops)


def model_perf(
    layers: Sequence[LayerShape],
    bits: int,
    split: EnergySplit = DEFAULT_SPLIT,
    array_rows: int = ARRAY_ROWS,
    array_cols: int = ARRAY_COLS,
) -> ModelPerf:
    mapping = map_layers(layers, array_rows, array_cols)
    perfs = [layer_perf(l, bits, split, array_rows, array_cols) for l in layers]
    return ModelPerf(perfs, mapping, bits)


def calibrate(
    kws_layers: Sequence[LayerShape],
    vww_layers: Sequence[LayerShape],
    bits: int = 8,
    targets: dict[str, float] | None = None,
) -> EnergySplit:
    """Solve the (adc_frac, row_frac) split from the two model-level anchors.

    Given the paper's measured TOPS/W for AnalogNet-KWS and -VWW at ``bits``,
    the per-phase energy decomposition has exactly two free parameters once
    the full-phase energy is pinned by the peak numbers; two anchors determine
    them. Falls back to the physical prior if the solution is non-physical
    (a sign the reconstructed architectures deviate too far from Fig. 10).
    """
    targets = targets or {"kws": 8.58, "vww": 4.37}

    def model_energy_terms(layers):
        # energy = a * adc_frac + r * row_frac + d * dig_frac, per unit
        # of e_phase_full: collect coefficients.
        a = r = d = 0.0
        for layer in layers:
            lp = layer_perf(layer, bits)  # reuse geometry only
            n_row_tiles = math.ceil(layer.rows / ARRAY_ROWS)
            n_col_strips = math.ceil(layer.cols / ARRAY_COLS)
            cols_active = 0
            row_drives = 0
            for rt in range(n_row_tiles):
                rr = min(ARRAY_ROWS, layer.rows - rt * ARRAY_ROWS)
                for cs in range(n_col_strips):
                    cc = min(ARRAY_COLS, layer.cols - cs * ARRAY_COLS)
                    cols_active += cc
                    row_drives += rr * math.ceil(cc / N_ADC)
            a += layer.n_patches * cols_active / N_ADC
            r += layer.n_patches * row_drives / ARRAY_ROWS
            d += layer.n_patches * lp.phases_per_mvm
        return a, r, d

    coeffs = []
    for name, layers in (("kws", kws_layers), ("vww", vww_layers)):
        ops = sum(2 * l.macs for l in layers)
        target_energy = ops / (targets[name] * 1e12)  # J
        a, r, d = model_energy_terms(layers)
        e = e_phase_full(bits)
        coeffs.append((a * e, r * e, d * e, target_energy))

    # Constrained grid search: the paper states ADCs dominate (Sec. 5.2 --
    # "ADCs consume more energy than DACs"; Fig. 8's tall-layer advantage
    # requires it), so the fit is restricted to adc_frac > row_frac. An
    # exact 2x2 solve can land row-dominant when the reconstructed
    # architectures' geometry deviates from the (unpublished) Fig. 10 one.
    best, best_err = DEFAULT_SPLIT, float("inf")
    for adc_frac in np.linspace(0.35, 0.9, 56):
        for row_frac in np.linspace(0.0, min(adc_frac - 0.05, 1 - adc_frac), 30):
            dig = 1.0 - adc_frac - row_frac
            err = 0.0
            for a, r, d, tgt in coeffs:
                pred = a * adc_frac + r * row_frac + d * dig
                err += (np.log(pred) - np.log(tgt)) ** 2
            if err < best_err:
                best_err = err
                best = EnergySplit(adc_frac=float(adc_frac), row_frac=float(row_frac))
    return best
