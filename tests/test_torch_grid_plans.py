"""The grid plans of the forward kernels, on the CPU.

``attn_plan`` (ops/swin_block_v3.py) gives the windows and head groups of
``window_attn_kernel_fused`` (csrc/swin_attn.cu); ``window_core_plan`` the
windows per block of ``window_attn_kernel`` (csrc/swin_window.cuh, window
attention alone) and of the backward core; ``attn_bwd_fused_plan`` the
windows each block of ``window_attn_bwd_kernel_fused`` (csrc/swin_attn_bwd.cu)
walks; ``mlp_fwd_plan``
(ops/mlp_block_kernel.py) the hidden split of ``token_mlp_kernel``
(csrc/token_mlp.cu); ``gemm_plan`` (ops/cuda_build.py) the column split of
the Hopper GEMM (csrc/hopper_gemm.cuh) that runs patch_merge's product,
patch_breakup's two products and the backward's; ``readout_plan``
(ops/readout_kernel.py) the persistent grid of ``readout_kernel``
(csrc/readout.cu); ``kernel_plan`` (ops/mm_microbench.py) the persistent
grid of ``mm_accumulate_wgmma`` (csrc/mm_microbench.cu) over its work items.  The partitions below repeat the kernels' index
math: every window, hidden chunk and column tile must be covered exactly once
by a block that has work, and the grid must aim at one wave of resident
blocks.  On the card the wrappers read the blocks an SM holds, and the tiles,
from the built library; here the plans get the H100 build's values, the
GEMM tiles through a stub of the library's queries.
"""
import ast
import collections
import json
import os
import re
import sys

import pytest
import torch

from diffusesg_torch.ops import cuda_build
from diffusesg_torch.ops import mm_microbench as mm
from diffusesg_torch.ops import patch_resample as pr
from diffusesg_torch.ops import readout_kernel as rk
from diffusesg_torch.ops import swin_block_v3 as sw
from diffusesg_torch.ops import mlp_block_kernel as mk
from diffusesg_torch.ops.mlp_block_kernel import mlp_fwd_plan
from diffusesg_torch.ops.cuda_build import gemm_plan
from diffusesg_torch.ops.swin_block_v3 import window_core_plan

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import h100_tiles  # noqa: E402

H100_SMS = 132
DEV = h100_tiles.DEVICE  # the device the plans are asked about, an H100 to the stub
# blocks of the window core an SM holds on the H100, by window length
CORE_PER_SM = {64: 4, 100: 2}
MLP_TILE = h100_tiles.MLP_TILE


def window_runs(n_windows: int, classes: int, wpb: int):
    """The windows each block of one head walks, as window_attn_kernel reads
    its block index: class x % classes, run x / classes of wpb windows."""
    per_class = n_windows // classes
    runs = []
    for x in range(classes * -(-per_class // wpb)):
        cls, first = x % classes, x // classes * wpb
        count = min(wpb, per_class - first)
        runs.append([cls + classes * (first + j) for j in range(count)])
    return runs


# (windows, heads, mask classes, L): the window-core launches of one VG and
# one COCO eval at batch 16 and 64, K11's entry cases, and the ragged ends
# (a run that is not a multiple of the windows per block, within classes
# too; one window; as many classes as windows)
WINDOW_CASES = [
    (16 * 64, 3, 1, 64), (16 * 16, 6, 1, 64), (16 * 4, 12, 1, 64), (16 * 4, 12, 4, 64),
    (16, 24, 1, 64), (64 * 64, 3, 1, 64), (64 * 4, 12, 4, 64),
    (16 * 16, 3, 1, 100), (16 * 4, 6, 1, 100), (16 * 4, 6, 4, 100), (16, 12, 1, 100),
    (64 * 16, 3, 1, 100), (64 * 4, 6, 4, 100), (64, 12, 1, 100),
    (7 * 64, 3, 1, 64), (23 * 4, 12, 4, 64), (1000, 3, 1, 64), (100, 6, 4, 100),
    (1, 3, 1, 64), (1, 2, 1, 100), (4, 12, 4, 100), (3, 1, 1, 100),
]


@pytest.mark.parametrize("n_windows,heads,classes,L", WINDOW_CASES)
def test_window_core_plan_covers_every_window_once(n_windows, heads, classes, L):
    wpb = window_core_plan(n_windows, heads, classes, CORE_PER_SM[L], H100_SMS)
    assert wpb >= 1
    runs = window_runs(n_windows, classes, wpb)
    assert all(runs), "a block without a window"
    assert all(len(r) <= wpb for r in runs)
    assert all(w % classes == r[0] % classes for r in runs for w in r), "a run mixes classes"
    covered = sorted(w for r in runs for w in r)
    assert covered == list(range(n_windows))


@pytest.mark.parametrize("n_windows,heads,classes,L", WINDOW_CASES)
def test_window_core_plan_aims_at_one_wave(n_windows, heads, classes, L):
    slots = H100_SMS * CORE_PER_SM[L]
    wpb = window_core_plan(n_windows, heads, classes, CORE_PER_SM[L], H100_SMS)
    blocks = heads * len(window_runs(n_windows, classes, wpb))
    assert blocks <= max(slots, heads * classes)  # never a second wave ...
    if n_windows * heads <= slots:
        assert wpb == 1  # ... and one window a block when they all fit
    else:
        assert 2 * blocks > slots - 2 * heads * classes  # ... yet most of the first


def test_window_core_plan_follows_the_sm_count():
    """Fewer SMs, longer runs; the same work on twice the SMs, half the run;
    and the same for the blocks an SM holds."""
    assert window_core_plan(1024, 3, 1, 4, 66) > window_core_plan(1024, 3, 1, 4, 132)
    assert window_core_plan(4096, 3, 1, 4, 264) * 2 == window_core_plan(4096, 3, 1, 4, 132)
    assert window_core_plan(4096, 3, 1, 2, 132) > window_core_plan(4096, 3, 1, 4, 132)


# (tokens, C): the token_mlp launches of one VG and one COCO eval at batch 16
# and 64, and token counts that are not a multiple of the row tile
MLP_CASES = [(16 * 4096, 96), (16 * 1024, 192), (16 * 256, 384), (16 * 64, 768),
             (16 * 1600, 96), (16 * 400, 192), (16 * 100, 384), (66 * 64, 384),
             (64 * 1024, 192), (64 * 256, 384), (64 * 64, 768), (64 * 100, 384),
             (200, 64), (300, 96), (1000, 192), (520, 384), (100, 768), (1, 96), (33, 768),
             (40000, 96), (20000, 192), (9000, 384), (5000, 768),
             # 540 tiles: 0.82 of 5 waves, so the plan cuts them
             (540 * 128 - 37, 64), (540 * 128 - 37, 96), (540 * 128 - 37, 192),
             (540 * 64 - 37, 384), (270 * 64 - 37, 768)]
# (tokens, C): the benchmark's shapes, every MLP launch of a sampling
# evaluation at batch 64 (VG, then COCO) and of a training forward at 1000
# graphs (VG)
MLP_BENCH_CASES = [(64 * 4096, 96), (64 * 1024, 192), (64 * 256, 384), (64 * 64, 768),
                   (64 * 1600, 96), (64 * 400, 192), (64 * 100, 384),
                   (1000 * 4096, 96), (1000 * 1024, 192), (1000 * 256, 384), (1000 * 64, 768)]


def mlp_segments(m, c):
    """The units of each block of token_mlp's plan, as the kernels read their
    block index (csrc/token_mlp.cu, Units): [(tile, first chunk, end
    chunk, partial slot or None)] a block, a slot for a part of a tile:
    2b for the tile block b begins in, 2b + 1 for the next."""
    plan = mlp_fwd_plan(m, 4 * c, MLP_TILE[c], H100_SMS)
    n, units = plan["chunks"], plan["tiles"] * plan["chunks"]
    blocks = []
    for b in range(plan["blocks"]):
        u0, u1 = b * units // plan["blocks"], (b + 1) * units // plan["blocks"]  # Units::start
        segs = []
        for t in range(u0 // n, -(-u1 // n)):
            lo, hi = max(u0, t * n) - t * n, min(u1, (t + 1) * n) - t * n
            whole = (lo, hi) == (0, n)
            segs.append((t, lo, hi, None if whole else 2 * b + (t != u0 // n)))
        blocks.append(segs)
    return plan, blocks


def mlp_closes(plan):
    """The row tiles the closing pass adds, as mlp_close_kernel reads its block
    index: {row tile: the main launch's blocks whose partials it adds, in
    order}."""
    n, units, g = plan["chunks"], plan["tiles"] * plan["chunks"], plan["blocks"]
    out = {}
    for i in range(g):
        u0, u1 = i * units // g, (i + 1) * units // g
        t = (u1 - 1) // n
        if t * n < u0 or (t + 1) * n <= u1:
            continue
        last = -(-((t + 1) * n) * g // units) - 1  # Units::block_of((t + 1) n - 1)
        out[t] = list(range(i, last + 1))
    return out


@pytest.mark.parametrize("m,c", MLP_CASES + MLP_BENCH_CASES)
def test_mlp_fwd_plan_covers_every_hidden_chunk_once(m, c):
    """Every (tile, hidden chunk) is taken by exactly one block, no block is
    empty, and the tiles are every row tile's column groups (C768: two)."""
    plan, blocks = mlp_segments(m, c)
    rows, chunk, _, groups = MLP_TILE[c]
    assert plan["tiles"] == -(-m // rows) * groups and plan["chunks"] == 4 * c // chunk
    assert all(any(hi > lo for _, lo, hi, _ in segs) for segs in blocks), "an empty block"
    seen = collections.Counter((t, j) for segs in blocks for t, lo, hi, _ in segs
                               for j in range(lo, hi))
    assert len(seen) == plan["tiles"] * plan["chunks"] and set(seen.values()) == {1}
    # every row tile's fc2 columns: its column groups are tiles t // groups
    assert {t // groups for t, _ in seen} == set(range(-(-m // rows)))


@pytest.mark.parametrize("m,c", MLP_CASES + MLP_BENCH_CASES)
def test_mlp_fwd_plan_reduces_partials_in_a_fixed_order(m, c):
    """A row tile cut between blocks is added by exactly one block of the
    closing pass, from each block's own slot, in block order, which is the
    order of its hidden chunks; a whole row tile is written by its one block
    and never closed.  ``split`` says whether partials exist at all."""
    plan, blocks = mlp_segments(m, c)
    parts = collections.defaultdict(list)
    for b, segs in enumerate(blocks):
        for t, lo, hi, slot in segs:
            if slot is not None:
                parts[t].append((b, lo, hi, slot))
    closes = mlp_closes(plan)
    assert set(closes) == set(parts)
    assert plan["split"] == int(bool(parts))
    slots = [slot for pieces in parts.values() for _, _, _, slot in pieces]
    assert len(set(slots)) == len(slots) and all(0 <= s < 2 * plan["blocks"] for s in slots)
    for t, pieces in parts.items():
        assert closes[t] == [b for b, _, _, _ in pieces]
        chunks = [j for _, lo, hi, _ in pieces for j in range(lo, hi)]
        assert chunks == list(range(plan["chunks"]))  # ascending: a fixed order of the sums


def whole_tiles_chosen(plan, slots):
    """mlp_fwd_plan's choice: whole tiles where they fill their waves to
    WHOLE_TILE_FILL, or cost no more than cut ones (mlp_plan_costs)."""
    tiles, chunks = plan["tiles"], plan["chunks"]
    whole, cut = mk.mlp_plan_costs(tiles, chunks, slots)
    return tiles >= mk.WHOLE_TILE_FILL * -(-tiles // slots) * slots or whole <= cut


@pytest.mark.parametrize("m,c", MLP_CASES + MLP_BENCH_CASES)
def test_mlp_fwd_plan_aims_at_one_wave(m, c):
    """Whole tiles, one block each, where they fill their waves or cost no
    more; else the blocks take even shares of every unit, one a slot."""
    slots = H100_SMS * MLP_TILE[c][2]
    plan, blocks = mlp_segments(m, c)
    if whole_tiles_chosen(plan, slots):
        assert plan["blocks"] == plan["tiles"] and not plan["split"]
    else:
        assert plan["blocks"] == min(slots, plan["tiles"] * plan["chunks"])
        shares = [sum(hi - lo for _, lo, hi, _ in segs) for segs in blocks]
        assert max(shares) - min(shares) <= 1


@pytest.mark.parametrize("m,c", MLP_BENCH_CASES)
def test_mlp_fwd_plan_fills_the_card_at_the_benchmark_shapes(m, c):
    """At the benchmark's shapes the grid keeps at least 128 of the 132 SMs
    busy in its last wave, or says why it cannot (mlp_fwd_plan's docstring):
    its whole tiles fill their waves to WHOLE_TILE_FILL, or cutting them
    would cost more than the idle SMs (mlp_plan_costs)."""
    slots = H100_SMS * MLP_TILE[c][2]
    plan, blocks = mlp_segments(m, c)
    if plan["split"]:
        assert plan["blocks"] == slots  # every SM until its share is done
    else:
        last = plan["tiles"] % slots or slots
        assert last >= 128 or whole_tiles_chosen(plan, slots)


def test_mlp_fwd_plan_splits_where_the_rows_do_not_fill_the_card():
    """The plan cuts tiles where whole ones leave the card idle and the cut
    costs less: COCO's C96 at batch 64 (800 row tiles, 0.87 of 7 waves,
    become 132 even shares), VG's C384 and C768 at batch 16 (64 and 32
    tiles).  It keeps whole tiles where the cut costs more than the idle SMs
    (COCO's C192 and C384 at batch 64: 200 and 100 tiles) and where they
    fill their waves (VG at batch 64, C768's 64 row tiles in two column
    groups each; training at 1000 graphs)."""
    assert mlp_fwd_plan(64 * 1600, 384, MLP_TILE[96]) == dict(blocks=132, tiles=800, chunks=6,
                                                              split=1)
    assert mlp_fwd_plan(64 * 100, 1536, MLP_TILE[384]) == dict(blocks=100, tiles=100, chunks=24,
                                                               split=0)
    assert mlp_fwd_plan(64 * 400, 768, MLP_TILE[192])["blocks"] == 200
    assert mlp_fwd_plan(16 * 256, 1536, MLP_TILE[384])["blocks"] == 132
    assert mlp_fwd_plan(16 * 64, 3072, MLP_TILE[768]) == dict(blocks=132, tiles=32, chunks=48,
                                                              split=1)
    for m, c in ((64 * 4096, 96), (64 * 1024, 192), (64 * 256, 384), (64 * 64, 768),
                 (1000 * 4096, 96), (1000 * 256, 384), (1000 * 64, 768)):
        plan = mlp_fwd_plan(m, 4 * c, MLP_TILE[c])
        assert plan["split"] == 0 and plan["blocks"] == plan["tiles"]


# ------------------------------------------------- the names the profile reads

def test_token_mlp_kernels_keep_the_names_the_profile_attributes():
    """Every __global__ function of csrc/token_mlp.cu is named with a fragment
    that chip_smoke.py's KERNEL_OF and the benchmark's device-time tables
    (benchmark/metrics/*.json) attribute to token_mlp: token_mlp_kernel (the
    fused kernels, the design in the template arguments) or mlp_close_kernel
    (the closing pass).  Reads the sources; builds nothing."""
    root = os.path.join(os.path.dirname(__file__), "..")
    src = open(os.path.join(root, "diffusesg_torch", "csrc", "token_mlp.cu")).read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert set(names) == {"token_mlp_kernel_wg", "mlp_close_kernel"}
    fragments = ("token_mlp_kernel", "mlp_close_kernel")
    assert all(any(f in name for f in fragments) for name in names)
    tree = ast.parse(open(os.path.join(root, "chip_smoke.py")).read())
    kernel_of = next(ast.literal_eval(node.value) for node in tree.body
                     if isinstance(node, ast.Assign)
                     and any(getattr(t, "id", None) == "KERNEL_OF" for t in node.targets))
    tables = [dict(kernel_of)] + [
        dict(json.load(open(os.path.join(root, "benchmark", "metrics", f)))["table"])
        for f in ("swin_fwd_roofline.json", "torch_ops_pct.train.json")]
    for table in tables:
        assert all(table.get(f) == "token_mlp" for f in fragments)
        # the first fragment a name holds decides: none of the others is in them
        for name in names:
            assert next(f for f in table if f in name) in fragments


# ------------------------------------------------------------ the Hopper GEMM

@pytest.fixture
def stub_lib(monkeypatch):
    stub = h100_tiles.install(monkeypatch)
    yield stub
    for query in (cuda_build.tile_of, cuda_build.blocks_per_sm, cuda_build.sm_count):
        query.cache_clear()


def test_library_queries_are_cached_per_device(stub_lib):
    """A query runs under the device it is asked about, and each device has
    its own entry: a card's occupancy answers for that card alone.  The
    MLP's tile is one of these queries."""
    cards = [DEV, torch.device("cuda", 1)]
    for _ in range(2):
        for card in cards:
            assert mk.mlp_tile(card, 96) == MLP_TILE[96]
            assert pr.merge_tile(card, 96) == h100_tiles.merge_tile(96)
            assert cuda_build.blocks_per_sm(card, "dsg_swin_attn_bwd_core_per_sm", 64) == 2
            assert cuda_build.sm_count(card) == H100_SMS
    assert stub_lib.calls == [("mlp", 96), ("merge", 96, 0), ("attn_bwd_core", 64)] * 2
    assert stub_lib.under == [cards[0]] * 3 + [cards[1]] * 3
    assert cuda_build.tile_of.cache_info().currsize == 4
    assert cuda_build.blocks_per_sm.cache_info().currsize == 2
    assert cuda_build.sm_count.cache_info().currsize == 2
    with pytest.raises(ValueError, match="dsg_token_mlp_tile"):
        mk.mlp_tile(cards[0], 80)


ATTN_STAGES = [(64, 96), (32, 192), (16, 384), (8, 768), (40, 96), (20, 192), (10, 384)]
BREAKUP_STAGES = [(8, 1536, 1536), (16, 768, 768), (32, 384, 384), (10, 768, 768), (20, 384, 384)]
MERGE_STAGES = [(64, 96), (32, 192), (16, 384), (40, 96), (20, 192)]


def _gemms(b):
    """(rows, columns, tile) of every Hopper GEMM launch of one VG and one
    COCO eval at batch b, the tiles through the wrappers' library queries."""
    out = []
    for hw, cin, dim in BREAKUP_STAGES:
        m = b * hw * hw
        out += [(m, dim, pr.breakup_tile(DEV, cin, dim, "in")),
                (4 * m, dim // 4, pr.breakup_tile(DEV, cin, dim, "out"))]
    for hw, c in MERGE_STAGES:
        m = b * (hw // 2) ** 2
        out.append((m, 2 * c, pr.merge_tile(DEV, c, bool(pr.merge_plan(m, c, 2 * c, DEV)["wide"]))))
    return out


def test_gemm_tiles_come_from_the_library(stub_lib):
    assert sw.attn_bwd_tile(DEV, 768, "qkv") == (64, 192, 1, 0)
    assert sw.attn_bwd_tile(DEV, 384, "qkv", True) == (64, 192, 1, 0)
    assert pr.breakup_tile(DEV, 384, 384, "in") == (64, 384, 1, 1)
    assert pr.breakup_tile(DEV, 768, 768, "out") == (128, 96, 2, 0)
    assert stub_lib.calls == [("attn_bwd", 768, 0, 0), ("attn_bwd", 384, 0, 1),
                              ("breakup", 384, 384, 0), ("breakup", 768, 768, 1)]


# (grid, C, batch, 64-row tiles) of the backward's qkv recompute: the
# default tile where its N splits are no more than the blocks an SM holds,
# 64-row panels where they are more: VG's C384-C768 and COCO's C192-C384
# stages at batch 16, COCO's 10x10 at 64 too
@pytest.mark.parametrize("hw,c,b,wide", [(64, 96, 16, False), (32, 192, 16, False),
                                         (16, 384, 16, True), (16, 384, 64, False),
                                         (8, 768, 16, True), (40, 96, 16, False),
                                         (20, 192, 16, True), (10, 384, 16, True),
                                         (10, 384, 64, True), (40, 96, 1, True),
                                         (64, 96, 64, False), (32, 192, 64, False)])
def test_attn_bwd_gemm_plan_takes_64_row_panels_where_rows_are_few(stub_lib, hw, c, b, wide):
    plan = sw.attn_bwd_gemm_plan(b * hw * hw, c, DEV)
    assert bool(plan["wide"]) == wide
    tile = sw.attn_bwd_tile(DEV, c, "qkv", bool(plan["wide"]))
    assert plan["qkv"] == gemm_plan(b * hw * hw, 3 * c, tile, H100_SMS)["tiles"]


# (windows, heads, mask classes, C, L): every swin_attn launch of a VG and a
# COCO evaluation at batch 64, 16 and 1, of a VG training forward at batch
# 1000, and ragged counts (a class run that is not a whole number of
# tiles, heads that do not divide into the groups)
ATTN_PLAN_CASES = [
    (64 * 64, 3, 1, 96, 64), (64 * 16, 6, 1, 192, 64), (64 * 4, 12, 1, 384, 64),
    (64 * 4, 12, 4, 384, 64), (64, 24, 1, 768, 64),
    (64 * 16, 3, 1, 96, 100), (64 * 4, 6, 1, 192, 100), (64 * 4, 6, 4, 192, 100),
    (64, 12, 1, 384, 100),
    (16 * 64, 3, 1, 96, 64), (16 * 16, 6, 1, 192, 64), (16 * 4, 12, 4, 384, 64),
    (16, 24, 1, 768, 64), (16 * 16, 3, 1, 96, 100), (16 * 4, 6, 4, 192, 100),
    (16, 12, 1, 384, 100),
    (64, 3, 1, 96, 64), (16, 6, 1, 192, 64), (4, 12, 4, 384, 64), (1, 24, 1, 768, 64),
    (16, 3, 1, 96, 100), (4, 6, 4, 192, 100), (1, 12, 1, 384, 100),
    (1000 * 64, 3, 1, 96, 64), (1000 * 16, 6, 1, 192, 64), (1000 * 4, 12, 4, 384, 64),
    (1000, 24, 1, 768, 64),
    (7 * 64, 2, 1, 64, 64), (23 * 4, 12, 4, 384, 64), (3 * 4, 2, 4, 64, 100),
    (5, 24, 1, 768, 64), (3, 12, 1, 384, 100),
]


def _attn_blocks(n_windows, heads, classes, wpb, plan):
    """The (window, head) pairs of each block of the plan's grid, as
    window_attn_kernel_fused reads its block index: x -> class x % classes
    and windows cls + classes (x / classes wpb + j), j < wpb, clipped to the
    class's windows; y -> heads [y per, min((y + 1) per, heads))."""
    per_class, per = n_windows // classes, plan["heads"]
    blocks = []
    for x in range(plan["tiles"]):
        cls, first = x % classes, x // classes * wpb
        windows = [cls + classes * (first + j) for j in range(min(wpb, per_class - first))]
        for y in range(plan["groups"]):
            blocks.append([(w, h) for w in windows for h in range(y * per, min((y + 1) * per,
                                                                              heads))])
    return blocks


@pytest.mark.parametrize("n_windows,heads,classes,c,L", ATTN_PLAN_CASES)
def test_attn_plan_covers_every_window_and_head_once(stub_lib, n_windows, heads, classes, c, L):
    tile = sw.attn_tile(DEV, c, L)
    plan = sw.attn_plan(n_windows, heads, classes, tile, H100_SMS)
    blocks = _attn_blocks(n_windows, heads, classes, tile[1], plan)
    assert all(blocks), "a block without a window or a head"
    assert all(len({w % classes for w, _ in b}) == 1 for b in blocks), "a block mixes classes"
    assert plan["heads"] <= tile[3], "more heads than a block holds"
    pairs = sorted(p for b in blocks for p in b)
    assert pairs == [(w, h) for w in range(n_windows) for h in range(heads)]


@pytest.mark.parametrize("n_windows,heads,classes,c,L", ATTN_PLAN_CASES)
def test_attn_plan_splits_heads_only_where_windows_cannot_fill_a_wave(stub_lib, n_windows, heads,
                                                                     classes, c, L):
    """One group of every head where a block holds them all and the tiles
    fill a wave of resident blocks; else the fewest groups a block needs, or
    as many more as fill the wave without passing it."""
    tile = sw.attn_tile(DEV, c, L)
    plan = sw.attn_plan(n_windows, heads, classes, tile, H100_SMS)
    slots, least = H100_SMS * tile[2], -(-heads // tile[3])
    if plan["tiles"] >= slots:
        assert plan["groups"] == least
    if plan["groups"] > least:
        assert plan["tiles"] * plan["groups"] <= slots
        assert plan["heads"] == 1 or 2 * plan["tiles"] * plan["groups"] > slots
    if heads <= tile[3] and plan["tiles"] < slots // 2:
        assert plan["groups"] > 1 or heads == 1


def test_attn_plan_follows_the_sm_count_and_occupancy():
    """The head groups follow the SMs and the blocks an SM holds: VG's 8x8
    C768 at batch 64 takes two groups of 12 on 132 SMs, four of 6 on 264,
    and the same four where an SM holds two blocks; with every window
    filling the wave it takes the block's fewest."""
    tile = (64, 1, 1, 12)
    assert sw.attn_plan(64, 24, 1, tile, 132) == dict(tiles=64, groups=2, heads=12)
    assert sw.attn_plan(64, 24, 1, tile, 264) == dict(tiles=64, groups=4, heads=6)
    assert sw.attn_plan(64, 24, 1, (64, 1, 2, 12), 132) == dict(tiles=64, groups=4, heads=6)
    assert sw.attn_plan(64, 24, 1, tile, 66)["groups"] == 2
    assert sw.attn_plan(4096, 3, 1, (64, 1, 3, 3), 132) == dict(tiles=4096, groups=1, heads=3)
    assert sw.attn_plan(64, 3, 1, (64, 1, 3, 3), 132)["groups"] == 3
    assert sw.attn_plan(64, 3, 1, (64, 1, 3, 3), 33)["groups"] == 1


def test_attn_tile_comes_from_the_library(stub_lib):
    assert sw.attn_tile(DEV, 96, 64) == h100_tiles.SWIN_ATTN_TILE[(96, 64)]
    assert sw.attn_tile(DEV, 384, 100) == h100_tiles.SWIN_ATTN_TILE[(384, 100)]
    assert stub_lib.calls == [("attn", 96, 64), ("attn", 384, 100)]
    with pytest.raises(ValueError, match="dsg_swin_attn_tile"):
        sw.attn_tile(DEV, 768, 100)


@pytest.mark.parametrize("b", [1, 16, 64])
def test_gemm_plan_covers_every_column_tile_once(stub_lib, b):
    for m, n, tile in _gemms(b):
        n_tiles = -(-n // tile[1])
        plan = gemm_plan(m, n, tile, H100_SMS)
        per = plan["tiles"]
        # hgemm_kernel: block y walks column tiles [y per, min((y + 1) per, n_tiles))
        parts = [range(y * per, min((y + 1) * per, n_tiles)) for y in range(-(-n_tiles // per))]
        assert len(parts) == plan["splits"]
        assert all(len(p) > 0 for p in parts), "a block without a column tile"
        assert sorted(t for p in parts for t in p) == list(range(n_tiles))
        if tile[3]:  # whole rows: one block holds every column of its rows
            assert n_tiles == 1 and plan["splits"] == 1


@pytest.mark.parametrize("b", [1, 16, 64])
def test_gemm_plan_aims_at_one_wave(stub_lib, b):
    for m, n, tile in _gemms(b):
        rows, cols, per_sm = tile[:3]
        slots = H100_SMS * per_sm
        row_tiles, n_tiles = -(-m // rows), -(-n // cols)
        splits = gemm_plan(m, n, tile, H100_SMS)["splits"]
        if row_tiles > slots // 2 or n_tiles == 1:
            assert splits == 1, (m, n, tile)  # the row tiles alone fill the card
        else:
            assert splits > 1 and row_tiles * splits <= slots, (m, n, tile)
            assert splits == n_tiles or 2 * row_tiles * splits > slots, (m, n, tile)


def test_gemm_plan_splits_where_the_rows_do_not_fill_the_card(stub_lib):
    """At batch 16, VG's C768 and COCO's 10x10 C384 stages split the
    backward's qkv recompute and its streamed products (each split of the
    recompute redoes its rows' LayerNorm), VG's C96 does not; the fused
    breakup never splits."""
    def splits(m, n, tile):
        return gemm_plan(m, n, tile, H100_SMS)["splits"]
    assert splits(16 * 64, 3 * 768, sw.attn_bwd_tile(DEV, 768, "qkv")) > 1
    assert splits(16 * 64, 768, sw.attn_bwd_tile(DEV, 768, "stream")) > 1
    assert splits(16 * 100, 3 * 384, sw.attn_bwd_tile(DEV, 384, "qkv")) > 1
    assert splits(16 * 4096, 3 * 96, sw.attn_bwd_tile(DEV, 96, "qkv")) == 1
    assert splits(16 * 1024, 384, pr.breakup_tile(DEV, 384, 384, "in")) == 1
    assert splits(16 * 64, 1536, pr.breakup_tile(DEV, 1536, 1536, "in")) > 1


# (grid, C, batch, 64-row tiles) of patch_merge: the 128-row panel at K = 384
# where its row tiles fill the card (VG 64x64), 64 rows where it would split N
# beyond the blocks an SM holds (COCO 40x40, few rows), and always above K = 384
@pytest.mark.parametrize("hw,c,b,wide", [(64, 96, 16, False), (64, 96, 64, False),
                                         (40, 96, 16, True), (40, 96, 64, False),
                                         (40, 96, 1, True), (16, 48, 2, False)])
def test_merge_plan_takes_64_row_panels_where_rows_are_few(stub_lib, hw, c, b, wide):
    m = b * (hw // 2) ** 2
    plan = pr.merge_plan(m, c, 2 * c, DEV)
    assert bool(plan["wide"]) == wide
    assert plan["tiles"] == gemm_plan(m, 2 * c, pr.merge_tile(DEV, c, wide), H100_SMS)["tiles"]
    assert pr.merge_tile(DEV, c, wide)[0] == (64 if wide else 128)


def test_merge_tiles_come_from_the_library(stub_lib):
    assert pr.merge_tile(DEV, 384) == (64, 96, 1, 0)
    assert pr.merge_tile(DEV, 192) == (64, 192, 1, 0)
    assert pr.merge_tile(DEV, 96, True) == (64, 192, 1, 0)
    assert stub_lib.calls == [("merge", 384, 0), ("merge", 192, 0), ("merge", 96, 1)]


def _token_split_covers(splits, chunk, tokens):
    """launch_wgrad: block z covers tokens [z chunk, min((z + 1) chunk, T))."""
    parts = [range(z * chunk, min((z + 1) * chunk, tokens)) for z in range(splits)]
    assert all(len(p) > 0 for p in parts), "an empty split"
    assert sum(len(p) for p in parts) == tokens and parts[-1].stop == tokens
    assert chunk % cuda_build.TOKEN_BOX == 0


# (tiles, tokens): the weight gradients of the resampling backwards at batch
# 1000 and 1 (VG's breakup 8x8 dW_in: 144 tiles over 64,000 tokens, one
# split would leave 120 of 132 SMs idle in a second wave), and few tokens
@pytest.mark.parametrize("tiles,tokens", [(144, 64000), (9, 1024000), (1, 4096000), (4, 1024000),
                                          (6, 256000), (144, 64), (2, 100), (40, 300 * 64 + 5),
                                          (300, 10 ** 6)])
def test_wgrad_split_fills_the_card_and_covers_every_token(tiles, tokens):
    splits, chunk = pr.wgrad_split(tiles, tokens, 1, H100_SMS)
    _token_split_covers(splits, chunk, tokens)
    most = max(1, tokens // cuda_build.TOKEN_SPLIT_MIN)
    assert splits <= most
    fill = lambda s: tiles * s / (-(-tiles * s // H100_SMS) * H100_SMS)  # noqa: E731
    if fill(splits) < pr.WAVE_FILL:  # none fills: the fullest
        assert all(fill(s) <= fill(splits) for s in range(1, most + 1))
    else:  # the fewest that fill
        assert all(fill(s) < pr.WAVE_FILL for s in range(1, splits))
    if tiles == 144 and tokens == 64000:
        assert splits == 5


@pytest.mark.parametrize("hw,c,b", [(hw, c, b) for hw, c in MERGE_STAGES for b in (1, 16, 1000)]
                         + [(16, 48, 2), (62, 96, 3)])
def test_merge_bwd_plan(stub_lib, hw, c, b):
    m = b * (hw // 2) ** 2
    plan = pr.merge_bwd_plan(m, c, 2 * c, DEV)
    tile = pr.bwd_tile(DEV, "merge_dhn", 2 * c)
    assert plan["dhn"] == gemm_plan(m, 4 * c, tile, H100_SMS)["tiles"]
    assert tile[:2] == (128, 192)
    assert pr.bwd_tile(DEV, "merge_dw", 4 * c) == h100_tiles.tokens_tile(4 * c)
    _token_split_covers(plan["w"], plan["kchunk"], m)
    # one wave of the row pass's resident blocks, four rows a block at a time
    assert plan["rows"] == min(H100_SMS * h100_tiles.resample_rows_per_sm(0, 4 * c), -(-m // 4))


def test_merge_bwd_plan_pads_k_to_16(stub_lib):
    """dhn = dy W takes K in steps of 16: c_out = 24 plans at K = 32."""
    pr.merge_bwd_plan(64, 48, 24, DEV)
    assert ("resample_bwd", 0, 32) in stub_lib.calls


@pytest.mark.parametrize("hw,cin,dim,b,skip", [(hw, cin, dim, b, skip)
                                               for hw, cin, dim in BREAKUP_STAGES
                                               for b in (1, 1000) for skip in (True, False)]
                         + [(8, 128, 128, 5, True)])
def test_breakup_bwd_plan(stub_lib, hw, cin, dim, b, skip):
    m, c = b * hw * hw, dim // 4
    c1 = cin // 2 if skip else cin
    plan = pr.breakup_bwd_plan(m, c1, cin - c1, dim, DEV)
    assert plan["y"] == gemm_plan(m, dim, pr.bwd_tile(DEV, "breakup_y", cin), H100_SMS)["tiles"]
    assert plan["dh"] == gemm_plan(4 * m, c, pr.bwd_tile(DEV, "breakup_dh", c), H100_SMS)["tiles"]
    assert plan["dx"] == gemm_plan(m, cin, pr.bwd_tile(DEV, "breakup_dx", 3 * dim), H100_SMS)["tiles"]
    _token_split_covers(plan["w_out"], plan["kchunk_out"], 4 * m)
    _token_split_covers(plan["w_in"], plan["kchunk_in"], m)
    assert plan["rows"] == min(H100_SMS * h100_tiles.resample_rows_per_sm(1, c), -(-m // 4))


def test_resample_bwd_tiles_come_from_the_library(stub_lib):
    assert pr.bwd_tile(DEV, "breakup_dx", 4608) == (128, 192, 1, 0)
    assert pr.bwd_tile(DEV, "breakup_dh", 96) == (128, 96, 1, 0)
    assert pr.bwd_tile(DEV, "breakup_dw_out", 96) == (128, 96, 1, 0)
    assert stub_lib.calls == [("resample_bwd", 4, 4608), ("resample_bwd", 3, 96),
                              ("resample_bwd", 5, 96)]


# the readout heads of one VG and one COCO eval at batch 1, 16 and 64, and
# ragged row counts
@pytest.mark.parametrize("m", [1, 64, 65, 300, 16 * 64, 16 * 40, 16 * 4096, 16 * 1600,
                               64 * 4096, 64 * 1600])
def test_readout_plan_covers_every_tile_once(stub_lib, m):
    tile = rk.readout_tile(DEV)
    rows, groups, per_sm = tile[:3]
    blocks = rk.readout_plan(m, tile, H100_SMS)
    # readout_kernel: warpgroup g of block x is worker w = x groups + g of W =
    # blocks groups and walks tiles w, w + W, ...
    workers = blocks * groups
    tiles = -(-m // rows)
    walked = [t for w in range(workers) for t in range(w, tiles, workers)]
    assert sorted(walked) == list(range(tiles))
    assert blocks <= H100_SMS * per_sm  # one wave of resident blocks at most ...
    assert all(range(x * groups, tiles, workers) for x in range(blocks)), "a block without work"
    if tiles >= H100_SMS * per_sm * groups:
        assert blocks == H100_SMS * per_sm  # ... and all of it where the tiles fill it


# ------------------------------------------------------ the backward kernels

def _weight_gradients(b):
    """(tokens, plan) of every weight-gradient launch pair of one VG and one
    COCO training step at batch b: swin_attn_bwd's dWqkv / dWproj and
    token_mlp_bwd's dW1 / dW2 at each stage, the tiles through the wrappers'
    library queries."""
    out = []
    for hw, c in ATTN_STAGES:
        m = b * hw * hw
        out += [(m, sw.attn_bwd_gemm_plan(m, c, DEV)),
                (m, mk.mlp_bwd_plan(m, c, 4 * c, DEV))]
    return out


@pytest.mark.parametrize("b", [16, 64])
def test_token_split_covers_every_token_once(stub_lib, b):
    """The weight gradients' K split (hgemm_kernel: block z covers tokens
    [z kchunk, min((z + 1) kchunk, T))): every token once, no split empty,
    chunks of whole 64-token boxes."""
    for m, plan in _weight_gradients(b):
        splits, chunk = plan["w"], plan["kchunk"]
        parts = [range(z * chunk, min((z + 1) * chunk, m)) for z in range(splits)]
        assert all(len(p) > 0 for p in parts), (m, plan)
        assert sorted(t for p in parts for t in p) == list(range(m))
        assert splits == 1 or chunk % 64 == 0


@pytest.mark.parametrize("b", [16, 64])
def test_token_split_aims_at_one_wave(stub_lib, b):
    """The output tiles times the splits stay within one wave of resident
    blocks (or the tiles alone where they pass it), and each split takes at
    least cuda_build.TOKEN_SPLIT_MIN tokens where it can."""
    for hw, c in ATTN_STAGES:
        m = b * hw * hw
        wt = sw.attn_bwd_tile(DEV, c, "wgrad")
        tiles = -(-3 * c // wt[0]) * -(-c // wt[1])
        splits, chunk = cuda_build.token_split(tiles, m, wt[2], H100_SMS)
        assert (splits, chunk) == tuple(sw.attn_bwd_gemm_plan(m, c, DEV)[k]
                                        for k in ("w", "kchunk"))
        assert tiles * splits <= max(H100_SMS * wt[2], tiles), (m, c)
        assert splits == 1 or chunk >= cuda_build.TOKEN_SPLIT_MIN


# (tokens, C): the fused MLP backward at every VG and COCO width it covers,
# batch 16 and 64, and ragged token counts
FUSED_CASES = [(16 * 4096, 96), (16 * 1024, 192), (16 * 1600, 96), (16 * 400, 192),
               (64 * 4096, 96), (64 * 1024, 192), (64 * 1600, 96), (64 * 400, 192),
               (1, 96), (300, 96), (1000, 192), (129, 192)]


@pytest.mark.parametrize("m,c", FUSED_CASES)
def test_fused_mlp_bwd_plan_covers_every_row_tile_and_hidden_chunk_once(stub_lib, m, c):
    """mlp_bwd_kernel: block x owns rows [x BM, min((x + 1) BM, M)) and walks
    every hidden chunk of BH once; its column sums are rows 2x and 2x + 1 of
    the partials the wrapper allocates (2 * blocks)."""
    hidden = 4 * c
    plan = mk.mlp_bwd_plan(m, c, hidden, DEV)
    rows, chunk = mk.mlp_bwd_tile(DEV, c, "fused")[:2]
    assert plan["fused"] == 1 and hidden % chunk == 0
    blocks = plan["blocks"]
    row_parts = [range(x * rows, min((x + 1) * rows, m)) for x in range(blocks)]
    assert all(len(p) > 0 for p in row_parts), "a block without rows"
    assert sorted(r for p in row_parts for r in p) == list(range(m))
    pairs = [(x, j) for x in range(blocks) for j in range(hidden // chunk)]
    assert len(set(pairs)) == blocks * (hidden // chunk)


def test_backward_tiles_come_from_the_library(stub_lib):
    assert mk.mlp_bwd_fused_tile(DEV, 96) == h100_tiles.FUSED_MLP_BWD_TILE
    assert mk.mlp_bwd_fused_tile(DEV, 384) is None  # the chain takes C384 and C768
    assert mk.mlp_bwd_tile(DEV, 3072, "wgrad") == (128, 192, 1, 0)
    assert sw.attn_bwd_tile(DEV, 96, "wgrad") == (128, 96, 1, 0)
    assert sw.attn_bwd_tile(DEV, 384, "qkv", True) == h100_tiles.attn_tile(384, 0, True)
    assert ("mlp_bwd", 96, 0, 0) in stub_lib.calls and ("attn_bwd", 96, 2, 0) in stub_lib.calls
    plan = mk.mlp_bwd_plan(16 * 256, 384, 1536, DEV)
    assert plan["fused"] == 0 and plan["fc1"] >= 1 and plan["dm"] >= 1 and plan["dhn"] >= 1
    # the chain's fc1 takes 64-row panels where 128-row ones would split N
    # beyond the blocks an SM holds, as swin_attn's qkv GEMM does
    assert plan["wide"] == 1 and ("mlp_bwd", 384, 1, 1) in stub_lib.calls


# (windows, heads, mask classes, L): the backward core's launches of one VG
# and one COCO training step at batch 64, on its own blocks an SM
BWD_WINDOW_CASES = [(64 * 64, 3, 1, 64), (64 * 16, 6, 1, 64), (64 * 4, 12, 1, 64),
                    (64 * 4, 12, 4, 64), (64, 24, 1, 64), (64 * 16, 3, 1, 100),
                    (64 * 4, 6, 1, 100), (64 * 4, 6, 4, 100), (64, 12, 1, 100), (1, 2, 1, 100)]


@pytest.mark.parametrize("n_windows,heads,classes,L", BWD_WINDOW_CASES)
def test_backward_core_plan_covers_every_window_once(stub_lib, n_windows, heads, classes, L):
    """The backward window core takes the forward core's plan on its own
    occupancy; its d(rel_bias) partials are one per block (core_blocks)."""
    per_sm = cuda_build.blocks_per_sm(DEV, "dsg_swin_attn_bwd_core_per_sm", L)
    wpb = window_core_plan(n_windows, heads, classes, per_sm, H100_SMS)
    runs = window_runs(n_windows, classes, wpb)
    assert len(runs) == sw.core_blocks(n_windows, classes, wpb)
    assert all(runs) and sorted(w for r in runs for w in r) == list(range(n_windows))


# every Swin stage of VG (window 8) and COCO (window 10) as (grid, C, L), and
# whether the fused attention backward holds its window in one block (C <=
# 192 at window 8); the chain of launches takes the others
ATTN_BWD_STAGES = [(64, 96, 64, True), (32, 192, 64, False), (16, 384, 64, False),
                   (8, 768, 64, False), (40, 96, 100, False), (20, 192, 100, False),
                   (10, 384, 100, False)]


@pytest.mark.parametrize("hw,c,L,fused", ATTN_BWD_STAGES)
def test_attn_bwd_streamed_products_take_the_wide_tile_from_c192(stub_lib, hw, c, L, fused):
    """The chain's dy Wproj and dqkv Wqkv (csrc/swin_attn_bwd.cu,
    with_stream_tile) run on 128 x 192 tiles from C192 and 128 x 96 below;
    the plan splits their columns on the tile the library reports."""
    tile = sw.attn_bwd_tile(DEV, c, "stream")
    assert tile[:2] == ((128, 192) if c >= 192 else (128, 96))
    m = 1000 * hw * hw
    plan = sw.attn_bwd_gemm_plan(m, c, DEV)
    assert plan["dattn"] == plan["dhn"] == gemm_plan(m, c, tile, H100_SMS)["tiles"]


@pytest.mark.parametrize("hw,c,L,fused", ATTN_BWD_STAGES)
def test_fused_attn_bwd_covers_the_stages_that_fit_a_block(stub_lib, hw, c, L, fused):
    tile = sw.attn_bwd_fused_tile(DEV, c, L)
    assert (tile is not None) == fused
    if fused:
        assert tile == h100_tiles.FUSED_ATTN_BWD_TILE[(c, L)]
    assert stub_lib.calls == [("attn_bwd_fused", c, L)]


@pytest.mark.parametrize("b", [1, 3, 64, 1000])
@pytest.mark.parametrize("hw,c,L,fused", ATTN_BWD_STAGES)
def test_attn_bwd_plans_cover_every_window_once(stub_lib, hw, c, L, fused, b):
    """Every stage of a training step at batch b: where the fused kernel
    runs, block x walks windows x, x + blocks, ... (window_attn_bwd_kernel_
    fused), one wave of resident blocks or one block a window, none idle,
    and one d(rel_bias) partial a block; elsewhere the chain's window core
    takes its runs of one mask class per head (core_blocks partials)."""
    window = 8 if L == 64 else 10
    n_windows = b * (hw // window) ** 2
    if fused:
        tile = sw.attn_bwd_fused_tile(DEV, c, L)
        blocks = sw.attn_bwd_fused_plan(n_windows, tile, H100_SMS)
        walked = [w for x in range(blocks) for w in range(x, n_windows, blocks)]
        assert sorted(walked) == list(range(n_windows))
        assert blocks == min(n_windows, H100_SMS * tile[2])
        return
    for classes in (1, (hw // window) ** 2):
        per_sm = cuda_build.blocks_per_sm(DEV, "dsg_swin_attn_bwd_core_per_sm", L)
        wpb = window_core_plan(n_windows, c // 32, classes, per_sm, H100_SMS)
        runs = window_runs(n_windows, classes, wpb)
        assert len(runs) == sw.core_blocks(n_windows, classes, wpb)
        assert all(runs) and sorted(w for r in runs for w in r) == list(range(n_windows))


# ----------------------------------------------- the micro-benchmark (K12)

MM_COPIES = {(512, 768, 768): 11, (1024, 96, 96): 33, (1024, 96, 288): 33, (2048, 128, 128): 33}
SMEM_PER_BLOCK = 232_448  # the H100's shared memory a block can use


@pytest.mark.parametrize("is_int8", [False, True])
@pytest.mark.parametrize("m,k,n", list(mm.SHAPES) + [(192, 96, 192), (64, 64, 64),
                                                    (128, 96, 48)])
def test_mm_plan_covers_every_item_once(stub_lib, m, k, n, is_int8):
    """mm_accumulate_wgmma: block x walks items x, x + grid, ...; item i is
    output tile i % tiles of copy i // tiles, and tile t covers rows
    [(t // tiles_n) rows, + rows) and columns [(t % tiles_n) cols, + cols).
    Every (tile, copy) once, every block with work, at most one wave; the
    tiles of a copy cover every output element once."""
    tile = mm.kernel_tile(DEV, n, k, is_int8)
    rows, cols, per_sm = tile[:3]
    plan = mm.kernel_plan(m, n, tile, H100_SMS)
    tiles, items, grid = plan["tiles"], plan["items"], plan["grid"]
    walked = [i for x in range(grid) for i in range(x, items, grid)]
    assert sorted(walked) == list(range(items)) and items == tiles * plan["copies"]
    assert 0 < grid <= H100_SMS * per_sm and all(range(x, items, grid) for x in range(grid))
    assert sorted((i % tiles, i // tiles) for i in walked) == sorted(
        (t, c) for t in range(tiles) for c in range(plan["copies"]))
    tiles_n = n // cols
    cover = [(r, col) for t in range(tiles)
             for r in range(t // tiles_n * rows, min(t // tiles_n * rows + rows, m))
             for col in range(t % tiles_n * cols, t % tiles_n * cols + cols)]
    assert sorted(cover) == [(r, col) for r in range(m) for col in range(n)]


@pytest.mark.parametrize("tile", [None, (128, 64, 1, 0), (64, 96, 2, 0), (128, 256, 1, 0)])
@pytest.mark.parametrize("m,k,n", mm.SHAPES)
def test_mm_copies_keep_the_work_whatever_the_tile(stub_lib, m, k, n, tile):
    """The copies, hence mm.operations() and the bound, are the 64 x 64
    plan's at the four shapes (11 / 33 / 33 / 33), whatever tile the kernel
    runs (None: the library's)."""
    for is_int8 in (False, True):
        t = tile if tile is not None and n % tile[1] == 0 else mm.kernel_tile(DEV, n, k, is_int8)
        plan = mm.kernel_plan(m, n, t, H100_SMS)
        assert plan["copies"] == MM_COPIES[(m, k, n)] == mm.grid_plan(m, n, H100_SMS)[1]
        assert mm.operations(m, k, n, 64, plan["copies"]) == 2 * m * k * n * 64 * MM_COPIES[
            (m, k, n)]


@pytest.mark.parametrize("is_int8", [False, True])
@pytest.mark.parametrize("m,k,n", mm.SHAPES)
def test_mm_tile_divides_n_and_fits_shared_memory(stub_lib, m, k, n, is_int8):
    """No column is computed on padding, and a block's ring fits the card."""
    rows, cols, per_sm, smem = mm.kernel_tile(DEV, n, k, is_int8)
    assert n % cols == 0 and cols % 8 == 0 and cols <= 256 and rows == 128
    assert per_sm >= 1 and 0 < smem <= SMEM_PER_BLOCK
    assert ("mm", n, k, int(is_int8)) in stub_lib.calls


@pytest.mark.parametrize("n,k", [(40, 96), (8, 96), (96, 24), (96, 0)])
def test_mm_tile_refuses_what_no_tile_covers(stub_lib, n, k):
    with pytest.raises(ValueError, match="no tile covers"):
        mm.kernel_tile(DEV, n, k, True)
