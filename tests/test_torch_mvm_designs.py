"""The pure-Python pieces of the programmed-MVM kernel's designs, on the CPU.

``kernels/analog_mvm.py`` picks one of four hand-written designs
(``select_design``), sizes the decode design's split-K grid
(``split_plan``), the prefill design's (``prefill_plan``) and the tiled
fp32 design's tile (``tiled_plan``); ``chip_smoke.py`` computes each timed
shape's bound (``mvm_bound``) and the prefill Ms it times (``prefill_ms``).
The kernels themselves run only on the card
(``tests/test_torch_kernel_gpu.py``, ``test_torch_cnn_gpu.py``,
``test_torch_train_gpu.py``).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import analog_mvm as kernel

REPO = Path(__file__).resolve().parents[1]
#: tinyllama-1.1b's projections: (name, K, N)
TINYLLAMA = [("wq|wo", 2048, 2048), ("wk|wv", 2048, 256), ("w1|w3", 2048, 5632),
             ("w2", 5632, 2048), ("lm_head", 2048, 32000)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m,design", [(1, "decode"), (8, "decode"), (16, "decode"),
                                      (17, "prefill"), (128, "prefill"), (256, "prefill")])
def test_bf16_design_by_m_at_the_threshold(m, design):
    assert kernel.DECODE_MAX_M == 16
    for _, k, n in TINYLLAMA:
        assert kernel.select_design(torch.bfloat16, m, k, n) == design


@pytest.mark.parametrize("m", [1, 8, 16, 17, 256])
def test_fp32_and_the_dac_keep_the_cuda_core_design(m):
    """fp32 runs the register-tiled CUDA-core design (with or without the
    DAC or a mask); bf16 with the DAC keeps the gemv design."""
    assert kernel.select_design(torch.float32, m, 2048, 2048) == "tiled"
    assert kernel.select_design(torch.float32, m, 2048, 2048, apply_dac=True) == "tiled"
    assert kernel.select_design(torch.bfloat16, m, 2048, 2048, apply_dac=True) == "gemv"


@pytest.mark.parametrize("m,design", [(1, "gemv"), (8, "gemv"), (16, "gemv"),
                                      (17, "prefill"), (64, "prefill"), (512, "prefill")])
def test_bf16_keep_masks_above_16_rows_run_the_prefill_design(m, design):
    for _, k, n in TINYLLAMA:
        assert kernel.select_design(torch.bfloat16, m, k, n, keep=True) == design
    # with the DAC, or at a shape the tensor cores refuse, the mask stays on gemv
    assert kernel.select_design(torch.bfloat16, m, 2048, 2048, keep=True, apply_dac=True) == "gemv"
    assert kernel.select_design(torch.bfloat16, m, 2044, 2048, keep=True) == "gemv"


@pytest.mark.parametrize("m", [1, 7, 16, 17, 64, 256, 32_000, 160_000])
@pytest.mark.parametrize("dac,keep", [(False, False), (True, False), (False, True), (True, True)])
def test_every_fp32_launch_runs_the_tiled_design(m, dac, keep):
    for k, n in [(9, 106), (954, 106), (106, 12), (27, 24), (128, 2), (2048, 256),
                 (5632, 2048), (2044, 130)]:
        assert kernel.select_design(torch.float32, m, k, n, apply_dac=dac, keep=keep) == "tiled"


@pytest.mark.parametrize("k,n,tile_rows,per_tile,design", [
    (2048, 2048, 1024, True, "prefill"),
    (1000, 2048, 1024, True, "prefill"),   # one ragged span: no tile boundary inside
    (2044, 2048, 1024, True, "gemv"),      # K % 8: x rows not 16-byte aligned
    (2048, 130, 1024, True, "gemv"),       # N % 8: w rows not 16-byte aligned
    (2048, 2048, 1000, True, "gemv"),      # crossbar tiles not whole sub-chunks
    (2048, 2048, 1000, False, "prefill"),  # ... unless the ADC runs once
    (2048, 2048, 256, True, "prefill"),
    (96, 40, 32, True, "gemv"),            # three 32-row crossbar tiles
    (96, 40, 1024, True, "prefill"),       # one tile, shorter than a sub-chunk
])
def test_tensor_core_designs_take_only_their_shapes(k, n, tile_rows, per_tile, design):
    assert kernel.select_design(torch.bfloat16, 64, k, n, tile_rows=tile_rows,
                                per_tile_adc=per_tile) == design


@pytest.mark.parametrize("name,k,n,warps,strips,n_sub", [
    ("wq|wo", 2048, 2048, 4, 32, 16),
    ("wk|wv", 2048, 256, 1, 16, 16),
    ("w1|w3", 2048, 5632, 4, 88, 16),
    ("w2", 5632, 2048, 4, 32, 44),
    ("lm_head", 2048, 32000, 4, 500, 16),
])
def test_decode_split_plan_on_tinyllama(name, k, n, warps, strips, n_sub):
    plan = kernel.split_plan(8, k, n)
    assert (plan.warps, plan.strips, plan.n_sub) == (warps, strips, n_sub), name
    assert plan.blocks == strips * n_sub >= 256  # several hundred blocks in flight
    assert plan.strips * 16 * plan.warps >= n
    assert plan.workspace_bytes == n_sub * 8 * n * 4


def test_decode_split_plan_sums_tiles_in_order():
    plan = kernel.split_plan(8, 5632, 2048)
    # 44 sub-chunks of 128 rows: tiles 0..4 take 8 each, the ragged tile 5 four
    assert plan.tile_of_sub == tuple([t for t in range(5) for _ in range(8)] + [5] * 4)
    assert list(plan.tile_of_sub) == sorted(plan.tile_of_sub)
    # one ADC conversion over all of K: every sub-chunk in tile 0
    assert set(kernel.split_plan(8, 5632, 2048, per_tile_adc=False).tile_of_sub) == {0}
    assert set(kernel.split_plan(8, 1000, 64).tile_of_sub) == {0}


def test_decode_split_plan_prefers_wide_strips_when_blocks_suffice():
    assert kernel.split_plan(8, 2048, 4096).warps == 4
    assert kernel.split_plan(8, 2048, 1024).warps == 2   # 32 strips of 2 warps x 16 sub
    assert kernel.split_plan(8, 128, 64).warps == 1      # too small for any: one warp
    assert kernel.split_plan(8, 128, 64).blocks == 4


def test_prefill_bound_at_m256_by_hand():
    cs = _chip_smoke()
    r = cs.mvm_bound(256, 2048, 2048)
    assert r["bytes"] == (2048 * 2048 + 2 * 256 * 2048) * 2 == 10_485_760
    assert r["flops"] == 2 * 256 * 2048 * 2048 == 2_147_483_648
    assert r["bound_by"] == "bytes"
    assert r["bound_ms"] == pytest.approx(10_485_760 / 3.35e12 * 1e3)  # 0.003130 ms
    head = cs.mvm_bound(256, 2048, 32000)
    assert head["bytes"] == 148_504_576 and head["flops"] == 33_554_432_000
    assert head["bound_ms"] == pytest.approx(0.0443297, rel=1e-5)
    w2 = cs.mvm_bound(256, 5632, 2048)
    assert w2["bound_ms"] == pytest.approx((5632 * 2048 + 256 * 5632 + 256 * 2048) * 2
                                           / 3.35e12 * 1e3)
    # past the ridge the operations bound it
    big = cs.mvm_bound(1024, 2048, 2048)
    assert big["bound_by"] == "operations"
    assert big["bound_ms"] == pytest.approx(2 * 1024 * 2048 * 2048 / 989e12 * 1e3)


def test_prefill_ms_are_phase_9s():
    # one 256-token prompt, and rows x bucket: 4 x 32, 2 x 64, 1 x 128, 1 x 256
    assert _chip_smoke().prefill_ms() == (128, 256)


def test_cpu_tensors_never_reach_a_design():
    """The kernel wrapper refuses CPU tensors, through the public entry and
    through each design's launcher."""
    x = torch.zeros((8, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 64), dtype=torch.bfloat16)
    before = dict(kernel.analog_mvm.design_launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.analog_mvm(x, w, r_adc=1.0)
    for design in kernel.DESIGNS:
        with pytest.raises(ValueError, match="CUDA"):
            kernel._launch(design, x, w, r_adc=1.0)
    assert kernel.analog_mvm.design_launches == before


def test_public_entry_takes_no_design():
    import inspect

    assert "design" not in inspect.signature(kernel.analog_mvm).parameters


@pytest.mark.parametrize("name,k,n", TINYLLAMA)
def test_decode_flags_are_one_per_block(name, k, n):
    """The decode design's arrival flags: one per block (strip x sub-chunk),
    carved from the call's own workspace after the partials."""
    plan = kernel.split_plan(8, k, n)
    assert plan.flags == plan.blocks == plan.strips * plan.n_sub, name


@pytest.mark.parametrize("m,k,n,flags", [
    (256, 2048, 2048, 2 * 32 * 2),   # split at its 2 crossbar tiles: one per block
    (256, 5632, 2048, 2 * 32 * 6),
    (128, 2048, 256, 1 * 4 * 2),
    (256, 2048, 32000, 0),           # enough output tiles: not split, no flags
    (256, 5632, 2048, None),         # per_tile_adc off: never split
])
def test_prefill_flags_only_when_split(m, k, n, flags):
    plan = kernel.prefill_plan(m, k, n, per_tile_adc=flags is not None)
    assert plan.flags == (flags or 0)
    assert (plan.flags > 0) == (plan.splits > 1)


@pytest.mark.parametrize("m,k,n", [(8, 2048, 256), (3, 1000, 520), (256, 5632, 2048),
                                   (200, 2048, 256), (256, 2048, 32000)])
def test_workspace_puts_the_flags_on_8_byte_words_after_the_partials(m, k, n):
    for plan in (kernel.split_plan(min(m, 16), k, n), kernel.prefill_plan(m, k, n)):
        words, off = kernel.workspace_words(plan)
        assert off % 2 == 0 and 4 * off >= plan.workspace_bytes > 4 * off - 8
        assert words == off + 2 * plan.flags


def test_call_tags_are_distinct_64_bit_words():
    tags = [kernel._tag() for _ in range(10_000)]
    assert len(set(tags)) == len(tags)
    assert all(0 < t < 2**64 for t in tags)
    # a flag lowered by one call (~tag) never raises another's
    assert not set(tags) & {t ^ (2**64 - 1) for t in tags}
    # spread over the bits, not the small integers a plain count would give
    assert sum(t >= 2**56 for t in tags) > 0.95 * len(tags)


def test_b1_served_ms_are_the_serving_phases():
    """Decode at 8 slots; exact-length prompts (16 .. 256) and their lm_head
    at one row; bucketed prefill at 4 x 32, 2 x 64, 1 x 128, 1 x 256 and
    their lm_head at 4, 2 and 1 rows."""
    cs = _chip_smoke()
    assert cs.b1_served_ms() == (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert set(cs.prefill_ms()) <= set(cs.b1_served_ms())
    assert set(cs.PROMPT_LENS) <= set(cs.b1_served_ms())


def test_b1_key_names_the_dtype():
    cs = _chip_smoke()
    assert cs.b1_key(8, 2048, 256, torch.bfloat16, "decode") == (8, 2048, 256, "bfloat16",
                                                                  "decode")


@pytest.mark.parametrize("name,k,n,splits,blocks", [
    ("wq|wo", 2048, 2048, 2, 128),
    ("wk|wv", 2048, 256, 2, 16),
    ("w1|w3", 2048, 5632, 2, 352),
    ("w2", 5632, 2048, 6, 384),
    ("lm_head", 2048, 32000, 1, 1000),   # enough output tiles: no split
])
def test_prefill_plan_at_m256(name, k, n, splits, blocks):
    plan = kernel.prefill_plan(256, k, n)
    assert (plan.row_tiles, plan.col_tiles) == (2, -(-n // 64)), name
    assert (plan.splits, plan.blocks) == (splits, blocks), name
    assert plan.workspace_bytes == (splits * 256 * n * 4 if splits > 1 else 0)


def test_prefill_plan_never_splits_one_adc_conversion():
    # the ADC over all of K cannot be split at tile boundaries
    assert kernel.prefill_plan(256, 5632, 2048, per_tile_adc=False).splits == 1
    assert kernel.prefill_plan(256, 1024, 2048).splits == 1   # K is one tile
    assert kernel.prefill_plan(128, 5632, 256).splits == 6    # the ragged tile counts


def test_expected_b1_launches_by_design():
    """chip_smoke.py's per-design expectation: a prefill's lm_head runs at
    M = rows (the last token), its 154 layer projections at rows x tokens."""
    cs = _chip_smoke()
    got = cs.b1_designs([(1, 16), (1, 256), (4, 32)], decode_steps=3)
    assert got == {"gemv": 0, "decode": 155 + 1 + 1 + 3 * 155, "prefill": 154 + 154,
                   "tiled": 0}
    # the CNN phase: every conv and the FC of every call one tiled launch
    assert cs.b1_only("tiled", 5 * 38) == {"gemv": 0, "decode": 0, "prefill": 0, "tiled": 190}
    # the training forms: fp32 tiled at any M; bf16 prefill above 16 rows
    # (phase 16 (b) at 1 x 64 tokens, (c) at 4 x 128), gemv up to
    assert cs.train_design(torch.float32, 64) == "tiled"
    assert cs.train_design(torch.float32, 1) == "tiled"
    assert cs.train_design(torch.bfloat16, 64) == "prefill"
    assert cs.train_design(torch.bfloat16, 512) == "prefill"
    assert cs.train_design(torch.bfloat16, 16) == "gemv"
    assert cs.b1_only(cs.train_design(torch.bfloat16, 512), 155)["prefill"] == 155


#: the tiled design's grid at each programmed MVM of the paper's CNNs:
#: (arch, batch) -> [(layer, bm, bn, blocks)]
TILED_CNN = {
    ("analognet-kws", 1): [("conv1", 16, 128, 31), ("conv2", 16, 128, 8),
                           ("conv3", 16, 128, 8), ("conv4", 16, 128, 8),
                           ("fc", 64, 16, 1)],
    ("analognet-kws", 256): [("conv1", 64, 128, 1960), ("conv2", 64, 128, 500),
                             ("conv3", 64, 128, 500), ("conv4", 64, 128, 500),
                             ("fc", 64, 16, 4)],
    ("analognet-kws", 64): [("conv1", 64, 128, 490), ("conv2", 32, 128, 250),
                            ("conv3", 32, 128, 250), ("conv4", 32, 128, 250),
                            ("fc", 64, 16, 1)],
    ("analognet-vww", 64): [("stem", 256, 32, 625), ("b1_expand", 64, 128, 625),
                            ("b1_proj", 256, 32, 157), ("b2_expand", 64, 128, 169),
                            ("b2_proj", 64, 64, 169), ("b3_expand", 32, 128, 196),
                            ("b3_proj", 32, 64, 98), ("b4_expand", 32, 128, 196),
                            ("b4_proj", 16, 128, 196), ("head", 16, 128, 196),
                            ("fc", 64, 16, 1)],
    ("analognet-vww", 1): [("stem", 64, 32, 40), ("b1_expand", 16, 128, 40),
                           ("b1_proj", 64, 32, 10), ("b2_expand", 16, 128, 11),
                           ("b2_proj", 32, 64, 6), ("b3_expand", 16, 128, 8),
                           ("b3_proj", 32, 64, 2), ("b4_expand", 16, 128, 8),
                           ("b4_proj", 16, 128, 4), ("head", 16, 128, 4),
                           ("fc", 64, 16, 1)],
}


@pytest.mark.parametrize("arch,batch", sorted(TILED_CNN))
def test_tiled_plan_at_the_cnn_shapes(arch, batch):
    from repro_torch.configs import get
    from repro_torch.models.analognet import mvm_shapes

    got = []
    for name, m, k, n in mvm_shapes(get(arch), batch):
        plan = kernel.tiled_plan(m, n)
        assert plan.bm * plan.row_tiles >= m > plan.bm * (plan.row_tiles - 1)
        assert plan.bn * plan.col_tiles >= n > plan.bn * (plan.col_tiles - 1)
        got.append((name, plan.bm, plan.bn, plan.blocks))
    assert got == TILED_CNN[arch, batch]


@pytest.mark.parametrize("n,bn", [(1, 16), (2, 16), (12, 16), (16, 16), (17, 32), (24, 32),
                                  (32, 32), (48, 64), (64, 64), (96, 128), (106, 128),
                                  (128, 128), (192, 128), (32000, 128)])
def test_tiled_column_tile_holds_n_without_a_wider_tile(n, bn):
    plan = kernel.tiled_plan(100_000, n)
    assert plan.bn == bn
    assert plan.col_tiles == -(-n // bn)
    # narrower tiles would not hold N in one tile (below 128 columns)
    assert n > 128 or all(b < n for b in kernel.TILED_BN if b < bn)


@pytest.mark.parametrize("m,n,bm", [(1, 12, 64), (4224, 64, 32), (8384, 64, 32),
                                    (8385, 64, 64), (16_768, 64, 64), (16_769, 64, 128),
                                    (16_896, 128, 64), (512, 32000, 64), (64, 2048, 16),
                                    (33_537, 24, 256), (33_536, 24, 128)])
def test_tiled_row_tile_puts_a_block_on_every_sm(m, n, bm):
    plan = kernel.tiled_plan(m, n)
    rows = kernel.TILED_BM[plan.bn]
    assert plan.bm == bm and bm in rows
    assert plan.row_tiles * plan.col_tiles >= kernel.SMS or plan.bm == rows[-1]
    assert all(-(-m // b) * plan.col_tiles < kernel.SMS for b in rows if b > bm)


def test_tiled_row_tiles_are_8_4_and_2_rows_a_thread():
    """256 threads: BN / TN across N (TN = 4 columns a thread, 2 at BN =
    16), the rest across M at 8, 4 or 2 rows a thread."""
    for bn, rows in kernel.TILED_BM.items():
        tn = 2 if bn == 16 else 4
        assert rows == tuple(tm * 256 // (bn // tn) for tm in (8, 4, 2))


@pytest.mark.parametrize("m,k,n,splits", [(64, 2048, 256, 2), (64, 5632, 2048, 6),
                                          (512, 2048, 5632, 1), (512, 2048, 32000, 1),
                                          (17, 2048, 2048, 2), (131, 1024, 520, 1)])
def test_the_bf16_training_form_plans_as_the_serving_prefill(m, k, n, splits):
    """A keep launch runs the prefill design on the serving plan: the split-K
    path (one block per crossbar tile, each applying its own tile's mask
    before it writes its partial) where the output tiles are few, one block
    per output tile otherwise."""
    assert kernel.select_design(torch.bfloat16, m, k, n, keep=True) == "prefill"
    plan = kernel.prefill_plan(m, k, n)
    assert plan.splits == splits
    assert plan.flags == (plan.blocks if splits > 1 else 0)


@pytest.mark.parametrize("m,n,blocks", [
    (125, 106, 8),      # KWS conv2, one image: 8 row tiles of 16
    (1, 12, 1),         # the always-on FC: one block
    (8, 2048, 16),      # one row tile, 16 column tiles of 128
    (64, 2048, 64),     # 4 row tiles of 16
    (256, 2048, 256),
    (32_000, 106, 500),
])
def test_tiled_grid_is_one_block_an_output_tile(m, n, blocks):
    """One block walks all of K for each output tile, however few the tiles
    (the always-on stream's single image fills 8 of 132 SMs at KWS's
    conv2)."""
    plan = kernel.tiled_plan(m, n)
    assert plan.blocks == plan.row_tiles * plan.col_tiles == blocks
