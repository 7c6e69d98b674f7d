"""Cycle-accurate layer-serial pipeline simulator (paper Sec. 5.2 / Fig. 5),
port of ``repro.core.pipeline_sim``. Its cycles and latencies are the
MODELLED AON-CiM accelerator's, not the card's.

The AON-CiM digital pipeline -- IM2COL address generation, SRAM read/write
(two banks, double buffered), FP scaling + integer ops -- is designed so the
CiM array "is never stalled ... even in the challenging 4-bit case". This
simulator checks that claim for ANY mapped model instead of assuming it:

  * per array cycle the CiM needs 128 data words of activation processing
    (paper: 128 words / 130 ns at 8 b, same words / 10 ns at 4 b);
  * the digital datapath runs at 800 MHz (T_digital = 1.25 ns) and processes
    ``digital_lanes`` words/cycle;
  * IM2COL reads from one SRAM bank while the previous layer's outputs are
    written to the other; a bank conflict (layer output burst exceeding the
    write budget) stalls the array.

Outputs per layer: array-limited cycles, digital-limited cycles, stall
cycles; model level: effective latency with stalls and the stall fraction.
The paper's design point (800 MHz, 128-word throughput) yields ZERO stalls
for both AnalogNets at every bitwidth -- reproduced by
tests/test_torch_cnn_models.py -- while a hypothetical 200 MHz datapath stalls
the 4-bit case, demonstrating why the 800 MHz clock was chosen.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.aoncim import ARRAY_COLS, ARRAY_ROWS, N_ADC, T_CIM
from repro_torch.core.crossbar import LayerShape


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    digital_clock_hz: float = 800e6  # paper: 800 MHz, T = 1.25 ns
    # The datapath is SIZED for the worst case (Sec. 5.2): 128 words per
    # 10 ns 4-bit cycle = 16 words/cycle sustained at 800 MHz; with two FP
    # scalings per word that is a 32-lane FP stage (we model 64 lanes /
    # 2 ops per word) + a 32-word/cycle banked SRAM.
    digital_lanes: int = 64  # FP ops retired per digital cycle
    sram_banks: int = 2  # double buffering (Table 2: "two banks")
    sram_words_per_cycle: int = 32  # banked, double-buffered
    fp_ops_per_word: int = 2  # two FP scalings per ADC word (Fig. 5)


@dataclasses.dataclass(frozen=True)
class LayerTiming:
    name: str
    array_cycles: int  # pure CiM cycles (phases x patches)
    digital_cycles_per_phase: float  # datapath work per conversion phase
    stall_cycles: int  # array cycles lost waiting on the datapath

    @property
    def total_cycles(self) -> int:
        return self.array_cycles + self.stall_cycles


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    layers: list
    bits: int
    cfg: PipelineConfig

    @property
    def array_cycles(self) -> int:
        return sum(l.array_cycles for l in self.layers)

    @property
    def stall_cycles(self) -> int:
        return sum(l.stall_cycles for l in self.layers)

    @property
    def stall_fraction(self) -> float:
        total = self.array_cycles + self.stall_cycles
        return self.stall_cycles / total if total else 0.0

    @property
    def latency_s(self) -> float:
        return (self.array_cycles + self.stall_cycles) * T_CIM[self.bits]


def simulate(
    layers: Sequence[LayerShape],
    bits: int,
    cfg: PipelineConfig = PipelineConfig(),
) -> PipelineReport:
    """Walk the layer-serial schedule and account datapath/SRAM pressure."""
    t_cim = T_CIM[bits]
    digital_cycles_available = t_cim * cfg.digital_clock_hz  # per array phase
    out: list[LayerTiming] = []
    for layer in layers:
        n_row_tiles = math.ceil(layer.rows / ARRAY_ROWS)
        n_col_strips = math.ceil(layer.cols / ARRAY_COLS)
        cols_active = sum(
            min(ARRAY_COLS, layer.cols - cs * ARRAY_COLS)
            for _ in range(n_row_tiles)
            for cs in range(n_col_strips)
        )
        phases = math.ceil(cols_active / N_ADC)
        array_cycles = layer.n_patches * phases

        # datapath demand per phase: every ADC word needs FP scale x2 +
        # integer post-ops, plus the IM2COL/SRAM traffic for the NEXT
        # layer's patches (overlapped, Fig. 5)
        words = min(cols_active, N_ADC)
        fp_cycles = words * cfg.fp_ops_per_word / cfg.digital_lanes
        sram_cycles = words / cfg.sram_words_per_cycle
        demand = fp_cycles + sram_cycles
        stall_per_phase = max(0.0, demand - digital_cycles_available)
        stalls = math.ceil(stall_per_phase / max(digital_cycles_available, 1e-9))
        out.append(
            LayerTiming(
                layer.name,
                array_cycles,
                demand,
                stalls * layer.n_patches * phases if stalls else 0,
            )
        )
    return PipelineReport(out, bits, cfg)
