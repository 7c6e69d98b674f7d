"""The pure-Python pieces of the fused decode kernel's design, on the CPU.

``kernels/decode_fused.py`` chooses each projection's MVM work item
(``mvm_items``), lays out the kernel's dynamic shared memory
(``fused_layout``: weight ring, staged x, work area), sizes its workspace
(``workspace_strides``), row passes (``row_slices``) and attention items
(``attn_heads``), counts the items of each MVM phase (``phase_items``)
and deals them to the blocks (``item_table``); ``chip_smoke.py`` computes the
step's bound (``fused_bound``) and reads its per-phase timing table
(``b2_breakdown``). The kernel itself runs only on the card
(``tests/test_torch_fused_decode_gpu.py``).
"""

import dataclasses
import importlib.util
import types
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get, get_smoke
from repro_torch.kernels import decode_fused as df

REPO = Path(__file__).resolve().parents[1]
TINYLLAMA = get("tinyllama-1.1b")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plans(cfg, tile_rows=1024, per_tile_adc=True):
    """Stand-ins of the eight projections' ExecutionPlans (FUSED_PROJS
    order, then the lm_head): their K, N and tiling."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    kn = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (d, cfg.n_kv_heads * hd),
          (cfg.n_heads * hd, d), (d, f), (d, f), (f, d), (d, cfg.vocab)]
    return [types.SimpleNamespace(k=k, n=n, tile_rows=tile_rows, per_tile_adc=per_tile_adc)
            for k, n in kn]


def _weights(dtype):
    return [torch.empty(16, dtype=dtype) for _ in range(8)]


def test_every_tinyllama_projection_takes_the_tensor_core_item_in_bf16():
    items = df.mvm_items(_plans(TINYLLAMA), _weights(torch.bfloat16), torch.bfloat16)
    assert items == ("tensor_core",) * 8


def test_fp32_keeps_the_cuda_core_item():
    items = df.mvm_items(_plans(TINYLLAMA), _weights(torch.float32), torch.float32)
    assert items == ("cuda_core",) * 8


@pytest.mark.parametrize("tile_rows,per_tile,item", [
    (32, True, "cuda_core"),     # three-way split K: crossbar tiles not whole sub-chunks
    (32, False, "tensor_core"),  # ... unless the ADC runs once over K
    (1024, True, "tensor_core"),  # one tile, shorter than a sub-chunk
])
def test_smoke_shapes_by_what_tc_shape_ok_takes(tile_rows, per_tile, item):
    cfg = get_smoke("tinyllama-1.1b")
    items = df.mvm_items(_plans(cfg, tile_rows, per_tile), _weights(torch.bfloat16),
                         torch.bfloat16)
    assert items == (item,) * 8


def test_misaligned_weights_take_the_cuda_core_item():
    ws = _weights(torch.bfloat16)
    ws[3] = torch.empty(17, dtype=torch.bfloat16)[1:]  # 2 bytes past a 16-byte boundary
    assert ws[3].data_ptr() % 16
    items = df.mvm_items(_plans(TINYLLAMA), ws, torch.bfloat16)
    assert items[3] == "cuda_core" and items.count("tensor_core") == 7


def test_tinyllama_layout_fits_one_block_an_sm():
    lay = df.fused_layout(("tensor_core",) * 8, TINYLLAMA, 8, 512)
    assert lay.stages == 11 and lay.x_rows == 8 and lay.heads_per_pass == 2
    # 16 KB TMA boxes from a 1024-byte boundary
    assert lay.smem_x == 11 * df.SLOT_BYTES + df.RING_ALIGN == 181248
    assert lay.smem_work == lay.smem_x + 8 * df.X_ROW_BYTES
    # the work area: the 8 chains x 8 rows x 64 columns of a tensor-core
    # piece, more than an attention pass's q rows and scores (2 heads x
    # (512 positions + 64 dims) floats) and AV sums (8 floats a thread)
    assert 2 * (512 + 64) * 4 + 256 * 8 * 4 < 8 * 8 * 64 * 4
    assert lay.smem_bytes == lay.smem_work + 8 * 8 * 64 * 4 == 214144
    assert lay.smem_bytes + df.STATIC_SMEM + df.BLOCK_RESERVED <= df.SM_SMEM
    assert lay.smem_bytes <= 227 * 1024  # the most one block may take
    assert lay.tc == (1,) * 8


@pytest.mark.parametrize("slots,s_max,stages,x_rows,hp", [
    (16, 512, 9, 16, 2),    # 16 slots: rows 8-15 of the mma tile staged too
    (8, 8192, 10, 8, 1),    # a long cache: one query head per pass
    (32, 8192, 9, 16, 1),
])
def test_layout_shrinks_the_ring_for_larger_x_and_scores(slots, s_max, stages, x_rows, hp):
    lay = df.fused_layout(("tensor_core",) * 8, TINYLLAMA, slots, s_max)
    assert (lay.stages, lay.x_rows, lay.heads_per_pass) == (stages, x_rows, hp)
    assert lay.smem_bytes + df.STATIC_SMEM + df.BLOCK_RESERVED <= df.SM_SMEM


def test_a_ring_shorter_than_a_tile_is_refused():
    """A tensor-core item takes a staged piece's 8 sub-chunks at once: a
    cache so long that 8 stages no longer fit beside its scores is refused,
    not run with a shorter ring."""
    cfg = dataclasses.replace(TINYLLAMA, n_heads=8, n_kv_heads=8, head_dim=256)
    with pytest.raises(ValueError, match="8 weight-ring stages"):
        df.fused_layout(("tensor_core",) * 8, cfg, 16, 16384)


def test_fp32_layout_has_no_ring_and_room_for_the_cuda_core_item():
    lay = df.fused_layout(("cuda_core",) * 8, TINYLLAMA, 8, 512)
    assert lay.stages == 0 and lay.smem_x == 0
    assert lay.smem_bytes - lay.smem_work >= df.CC_SMEM
    assert lay.tc == (0,) * 8


def test_mixed_items_keep_both_work_areas():
    items = ("tensor_core",) * 3 + ("cuda_core",) + ("tensor_core",) * 4
    lay = df.fused_layout(items, TINYLLAMA, 8, 512)
    assert lay.stages >= 1 and lay.smem_bytes - lay.smem_work >= df.CC_SMEM


def test_tinyllama_items_per_phase():
    plans = _plans(TINYLLAMA)
    span = df.spans(plans)
    assert span == [1024] * 8
    tc = df.phase_items(("tensor_core",) * 8, plans, 8, span)
    # strips of 64 columns x crossbar tiles x one 16-slot block
    assert tc == {"qkv": 32 * 2 + 2 * 4 * 2, "wo": 32 * 2, "w13": 2 * 88 * 2,
                  "w2": 32 * 6, "lm_head": 500 * 2}
    cc = df.phase_items(("cuda_core",) * 8, plans, 8, span)
    # strips of 32 columns x crossbar tiles x one 8-slot block
    assert cc == {"qkv": 64 * 2 + 2 * 8 * 2, "wo": 64 * 2, "w13": 2 * 176 * 2,
                  "w2": 64 * 6, "lm_head": 1000 * 2}


def test_tinyllama_workspace_strides():
    xq, part = df.workspace_strides(_plans(TINYLLAMA), 8, TINYLLAMA)
    assert xq == 8 * 5632
    assert part == 2 * 8 * 32000  # the lm_head: 2 tiles x 8 slots x 32000 columns
    xq1, part1 = df.workspace_strides(_plans(TINYLLAMA, per_tile_adc=False), 8, TINYLLAMA)
    assert (xq1, part1) == (xq, 8 * 32000)


def _dealt(items, plans, span, slots, layers, grid):
    """Each block's rows, by plain loops: phase by phase, projection by
    projection, item ``it`` (strip fastest, then tile, then slot block) to
    block ``it % grid``."""
    kinds = [(0, 1, 2), (3,), (4, 5), (6,)] * layers + [(7,)]
    blocks = [[] for _ in range(grid)]
    for mp, projs in enumerate(kinds):
        it = 0
        for j, i in enumerate(projs):
            tc = items[i] == "tensor_core"
            cols, rows = (64, 16) if tc else (32, 8)
            strips, tiles = -(-plans[i].n // cols), -(-plans[i].k // span[i])
            for rb in range(-(-slots // rows)):
                for tile in range(tiles):
                    for strip in range(strips):
                        blocks[it % grid].append(
                            [strip * cols, tile * span[i], i | j << 3 | tc << 5 | rb << 6,
                             mp | tile << 16])
                        it += 1
    return blocks


@pytest.mark.parametrize("items,slots", [
    (("tensor_core",) * 8, 8), (("cuda_core",) * 8, 8),
    (("tensor_core",) * 3 + ("cuda_core",) + ("tensor_core",) * 4, 20),
])
def test_item_table_deals_every_item_once_in_phase_order(items, slots):
    plans, layers, grid = _plans(TINYLLAMA), 2, 264
    span = df.spans(plans)
    tab = df.item_table(items, plans, slots, span, layers, grid)
    want = _dealt(items, plans, span, slots, layers, grid)
    assert tab.shape == (grid, max(len(w) for w in want) + 1, 4)
    for b in range(grid):
        n = len(want[b])
        assert tab[b, :n].tolist() == want[b]
        assert (tab[b, n:, 3] & 0xFFFF).eq(df.END).all()


def test_tinyllama_item_table_rows_per_block():
    plans = _plans(TINYLLAMA)
    tab = df.item_table(("tensor_core",) * 8, plans, 8, df.spans(plans), 22, 264)
    # per layer at most 1 + 1 + 2 + 1 items a block, then 4 of the lm_head's 1000
    assert tab.shape == (264, 22 * 5 + 4 + 1, 4)


def test_attn_heads_give_every_block_an_item():
    assert df.attn_heads(8, 8, 32, 264) == 1   # 256 (slot, head) items on 264 blocks
    assert df.attn_heads(8, 8, 32, 132) == 2
    assert df.attn_heads(8, 16, 32, 16) == 8   # at most what the work area holds
    assert df.attn_heads(2, 8, 32, 16) == 2


@pytest.mark.parametrize("grid,slots,d,slices", [
    (264, 8, 2048, 8), (132, 8, 2048, 8), (16, 8, 2048, 2), (4, 8, 2048, 1),
    (264, 3, 64, 1),
])
def test_row_slices(grid, slots, d, slices):
    assert df.row_slices(grid, slots, d) == slices


def test_fused_bound_by_hand():
    """chip_smoke.py's bound of one step: weights, the K/V rows attended to
    (not the new one), new rows, tokens, logits, norm scales and the table
    read or written once, over 3.35 TB/s."""
    cs = _chip_smoke()
    cfg = TINYLLAMA
    meta = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="meta")
    plans = _plans(cfg)
    dec = types.SimpleNamespace(
        cfg=cfg, n_slots=8, s_max=512,
        stacks=[meta(22, p.k, p.n) for p in plans[:7]], w_head=meta(2048, 32000),
        tab=torch.empty(23, 7, 3, device="meta"), n1=torch.empty(22, 2048, device="meta"),
        n2=torch.empty(22, 2048, device="meta"), fin=torch.empty(2048, device="meta"),
        plan=types.SimpleNamespace(n_groups=22))
    lens = torch.tensor([16, 32, 64, 128, 256, 300, 40, 511])
    bound, by, nbytes = cs.fused_bound(dec, lens)
    weights = 22 * (2 * 2048 * 2048 + 2 * 2048 * 256 + 3 * 2048 * 5632) + 2048 * 32000
    assert weights == 1_034_420_224
    nv = [17, 33, 65, 129, 257, 301, 41, 512]
    kv_read = 22 * sum(n - 1 for n in nv) * 256 * 2
    expect = ((weights + kv_read + 22 * 8 * 256 * 2 + 8 * 2048 + 8 * 32000) * 2
              + (23 * 7 * 3 + 2 * 22 * 2048 + 2048) * 4 + 2 * 8 * 4)
    assert nbytes == expect and by == "bytes"
    assert bound == pytest.approx(expect / 3.35e12 * 1e3)


def test_b2_breakdown_by_difference():
    cs = _chip_smoke()
    per, layers = df.PHASES_PER_LAYER, 22
    # a launch ended after n phases: n ms for layers 0 and 1, then the rest
    best = {n: float(n) for n in range(1, 2 * per + 1)}
    best.update({per * layers: 200.0, per * layers + 1: 203.0, per * layers + 2: 210.0,
                 0: 210.5})
    r = cs.b2_breakdown(best, layers, per)
    assert list(r["phase_ms"])[:per] == list(cs.B2_PHASE_KINDS)
    assert all(r["phase_ms"][k] == 1.0 for k in cs.B2_PHASE_KINDS)
    assert (r["phase_ms"]["row_final"], r["phase_ms"]["mvm_lm_head"],
            r["phase_ms"]["logits"]) == (3.0, 7.0, 0.5)
    assert r["barriers_per_step"] == 8 * 22 + 2 == 178
    assert (r["layer0_ms"], r["layer1_ms"], r["step_ms"]) == (8.0, 8.0, 210.5)
    assert r["mvm_share"] == 0.5  # qkv, wo, w13, w2 of the eight


def test_decoder_records_the_item_choice_on_the_cpu():
    """The plain version runs here; the item choice is made all the same."""
    from repro_torch import prng
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), dtype=torch.bfloat16, n_layers=1)
    params = lm.lm_init(prng.PRNGKey(0), cfg, device="cpu")
    program = engine.compile_program(params, AnalogConfig().infer(b_adc=8),
                                     prng.PRNGKey(1), device="cpu")
    dec = df.FusedDecoder(engine.cast_weights(program.params, cfg.dtype),
                          engine.build_fused_plan(program), cfg, program.cfg, 2, 16)
    assert dec.items == ("tensor_core",) * 8 and dec.grid is None
