"""The grid plans of the forward kernels, on the CPU.

``window_core_plan`` (ops/swin_block_v3.py) gives the windows per block of
``window_attn_kernel`` (csrc/swin_window.cuh); ``mlp_fwd_plan``
(ops/mlp_block_kernel.py) the hidden split of ``token_mlp_kernel``
(csrc/token_mlp.cu); ``gemm_plan`` (ops/cuda_build.py) the column split of
the Hopper GEMM (csrc/hopper_gemm.cuh) that runs swin_attn's qkv and proj,
patch_merge's product and patch_breakup's two products; ``readout_plan``
(ops/readout_kernel.py) the persistent grid of ``readout_kernel``
(csrc/readout.cu).  The partitions below repeat the kernels' index
math: every window, hidden chunk and column tile must be covered exactly once
by a block that has work, and the grid must aim at one wave of resident
blocks.  On the card the wrappers read the blocks an SM holds, and the tiles,
from the built library; here the plans get the H100 build's values, the
GEMM tiles through a stub of the library's queries.
"""
import os
import sys

import pytest

from diffusesg_torch.ops import cuda_build
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
# blocks of the window core an SM holds on the H100, by window length
CORE_PER_SM = {64: 4, 100: 2}
# the fused MLP's tile on the H100 by C: token rows, hidden chunk, blocks an SM
MLP_TILE = {64: (128, 64, 2), 96: (128, 64, 2), 192: (64, 64, 2), 384: (64, 64, 1),
            768: (32, 32, 1)}


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
             (40000, 96), (20000, 192), (9000, 384), (5000, 768)]


@pytest.mark.parametrize("m,c", MLP_CASES)
def test_mlp_fwd_plan_covers_every_hidden_chunk_once(m, c):
    hidden = 4 * c
    n_chunks = hidden // MLP_TILE[c][1]
    plan = mlp_fwd_plan(m, hidden, MLP_TILE[c], H100_SMS)
    splits, per = plan["splits"], plan["chunks"]
    parts = [range(s * per, min((s + 1) * per, n_chunks)) for s in range(splits)]
    assert all(len(p) > 0 for p in parts), "an empty split"
    assert sorted(i for p in parts for i in p) == list(range(n_chunks))


@pytest.mark.parametrize("m,c", MLP_CASES)
def test_mlp_fwd_plan_aims_at_one_wave(m, c):
    rows, _, per_sm = MLP_TILE[c]
    slots = H100_SMS * per_sm
    tiles = -(-m // rows)  # the last row tile is ragged when rows does not divide m
    splits = mlp_fwd_plan(m, 4 * c, MLP_TILE[c], H100_SMS)["splits"]
    if tiles > slots // 2:
        assert splits == 1  # the row tiles alone fill the card: no partials
    else:
        assert splits > 1 and tiles * splits <= slots
        n_chunks = 4 * c // MLP_TILE[c][1]
        assert splits == n_chunks or 2 * tiles * splits > slots


def test_mlp_fwd_plan_splits_where_the_rows_do_not_fill_the_card():
    """The shapes whose row tiles under-fill the card at batch 16 (VG's C384
    and C768, COCO's 10x10 stage) split the hidden dimension; VG's C96 does
    not."""
    assert mlp_fwd_plan(16 * 256, 1536, MLP_TILE[384])["splits"] > 1
    assert mlp_fwd_plan(16 * 64, 3072, MLP_TILE[768])["splits"] > 1
    assert mlp_fwd_plan(16 * 100, 1536, MLP_TILE[384])["splits"] > 1
    assert mlp_fwd_plan(16 * 4096, 384, MLP_TILE[96])["splits"] == 1


# ------------------------------------------------------------ the Hopper GEMM

@pytest.fixture
def stub_lib(monkeypatch):
    stub = h100_tiles.install(monkeypatch)
    yield stub
    cuda_build.tile_of.cache_clear()
    cuda_build.blocks_per_sm.cache_clear()


ATTN_STAGES = [(64, 96), (32, 192), (16, 384), (8, 768), (40, 96), (20, 192), (10, 384)]
BREAKUP_STAGES = [(8, 1536, 1536), (16, 768, 768), (32, 384, 384), (10, 768, 768), (20, 384, 384)]
MERGE_STAGES = [(64, 96), (32, 192), (16, 384), (40, 96), (20, 192)]


def _gemms(b):
    """(rows, columns, tile) of every Hopper GEMM launch of one VG and one
    COCO eval at batch b, the tiles through the wrappers' library queries."""
    out = []
    for hw, c in ATTN_STAGES:
        m = b * hw * hw
        wide = bool(sw.attn_gemm_plan(m, c, H100_SMS)["wide"])
        out += [(m, 3 * c, sw.attn_gemm_tile(c, "qkv", wide)),
                (m, c, sw.attn_gemm_tile(c, "proj", wide))]
    for hw, cin, dim in BREAKUP_STAGES:
        m = b * hw * hw
        out += [(m, dim, pr.breakup_tile(cin, dim, "in")),
                (4 * m, dim // 4, pr.breakup_tile(cin, dim, "out"))]
    for hw, c in MERGE_STAGES:
        m = b * (hw // 2) ** 2
        out.append((m, 2 * c, pr.merge_tile(c, bool(pr.merge_plan(m, c, 2 * c, H100_SMS)["wide"]))))
    return out


def test_gemm_tiles_come_from_the_library(stub_lib):
    assert sw.attn_gemm_tile(768, "qkv") == (64, 192, 1, 0)
    assert sw.attn_gemm_tile(384, "proj", True) == (64, 192, 1, 0)
    assert pr.breakup_tile(384, 384, "in") == (64, 384, 1, 1)
    assert pr.breakup_tile(768, 768, "out") == (128, 96, 2, 0)
    assert stub_lib.calls == [("attn", 768, 0, 0), ("attn", 384, 1, 1),
                              ("breakup", 384, 384, 0), ("breakup", 768, 768, 1)]


# (grid, C, batch, 64-row tiles): the default tile where its N splits are no
# more than the blocks an SM holds, 64-row panels where they are more: VG's
# C384-C768 and COCO's C192-C384 stages at batch 16, COCO's 10x10 at 64 too
@pytest.mark.parametrize("hw,c,b,wide", [(64, 96, 16, False), (32, 192, 16, False),
                                         (16, 384, 16, True), (16, 384, 64, False),
                                         (8, 768, 16, True), (40, 96, 16, False),
                                         (20, 192, 16, True), (10, 384, 16, True),
                                         (10, 384, 64, True), (40, 96, 1, True),
                                         (64, 96, 64, False), (32, 192, 64, False)])
def test_attn_gemm_plan_takes_64_row_panels_where_rows_are_few(stub_lib, hw, c, b, wide):
    plan = sw.attn_gemm_plan(b * hw * hw, c, H100_SMS)
    assert bool(plan["wide"]) == wide
    tile = sw.attn_gemm_tile(c, "qkv", bool(plan["wide"]))
    assert plan["qkv"] == gemm_plan(b * hw * hw, 3 * c, tile, H100_SMS)["tiles"]


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
    """At batch 16, VG's C768 and COCO's 10x10 C384 stages split the qkv
    columns (each split redoes its rows' LayerNorm), VG's C96 does not; the
    fused breakup never splits."""
    def splits(m, n, tile):
        return gemm_plan(m, n, tile, H100_SMS)["splits"]
    assert splits(16 * 64, 3 * 768, sw.attn_gemm_tile(768, "qkv")) > 1
    assert splits(16 * 64, 768, sw.attn_gemm_tile(768, "proj")) > 1
    assert splits(16 * 100, 3 * 384, sw.attn_gemm_tile(384, "qkv")) > 1
    assert splits(16 * 4096, 3 * 96, sw.attn_gemm_tile(96, "qkv")) == 1
    assert splits(16 * 1024, 384, pr.breakup_tile(384, 384, "in")) == 1
    assert splits(16 * 64, 1536, pr.breakup_tile(1536, 1536, "in")) > 1


# (grid, C, batch, 64-row tiles) of patch_merge: the 128-row panel at K = 384
# where its row tiles fill the card (VG 64x64), 64 rows where it would split N
# beyond the blocks an SM holds (COCO 40x40, few rows), and always above K = 384
@pytest.mark.parametrize("hw,c,b,wide", [(64, 96, 16, False), (64, 96, 64, False),
                                         (40, 96, 16, True), (40, 96, 64, False),
                                         (40, 96, 1, True), (16, 48, 2, False)])
def test_merge_plan_takes_64_row_panels_where_rows_are_few(stub_lib, hw, c, b, wide):
    m = b * (hw // 2) ** 2
    plan = pr.merge_plan(m, c, 2 * c, H100_SMS)
    assert bool(plan["wide"]) == wide
    assert plan["tiles"] == gemm_plan(m, 2 * c, pr.merge_tile(c, wide), H100_SMS)["tiles"]
    assert pr.merge_tile(c, wide)[0] == (64 if wide else 128)


def test_merge_tiles_come_from_the_library(stub_lib):
    assert pr.merge_tile(384) == (64, 96, 1, 0)
    assert pr.merge_tile(192) == (64, 192, 1, 0)
    assert pr.merge_tile(96, True) == (64, 192, 1, 0)
    assert stub_lib.calls == [("merge", 384, 0), ("merge", 192, 0), ("merge", 96, 1)]


# the readout heads of one VG and one COCO eval at batch 1, 16 and 64, and
# ragged row counts
@pytest.mark.parametrize("m", [1, 64, 65, 300, 16 * 64, 16 * 40, 16 * 4096, 16 * 1600,
                               64 * 4096, 64 * 1600])
def test_readout_plan_covers_every_tile_once(stub_lib, m):
    tile = rk.readout_tile()
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
        out += [(m, sw.attn_bwd_gemm_plan(m, c, H100_SMS)),
                (m, mk.mlp_bwd_plan(m, c, 4 * c, H100_SMS))]
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
        wt = sw.attn_bwd_tile(c, "wgrad")
        tiles = -(-3 * c // wt[0]) * -(-c // wt[1])
        splits, chunk = cuda_build.token_split(tiles, m, wt[2], H100_SMS)
        assert (splits, chunk) == tuple(sw.attn_bwd_gemm_plan(m, c, H100_SMS)[k]
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
    plan = mk.mlp_bwd_plan(m, c, hidden, H100_SMS)
    rows, chunk = mk.mlp_bwd_tile(c, "fused")[:2]
    assert plan["fused"] == 1 and hidden % chunk == 0
    blocks = plan["blocks"]
    row_parts = [range(x * rows, min((x + 1) * rows, m)) for x in range(blocks)]
    assert all(len(p) > 0 for p in row_parts), "a block without rows"
    assert sorted(r for p in row_parts for r in p) == list(range(m))
    pairs = [(x, j) for x in range(blocks) for j in range(hidden // chunk)]
    assert len(set(pairs)) == blocks * (hidden // chunk)


def test_backward_tiles_come_from_the_library(stub_lib):
    assert mk.mlp_bwd_fused_tile(96) == h100_tiles.FUSED_MLP_BWD_TILE
    assert mk.mlp_bwd_fused_tile(384) is None  # the chain takes C384 and C768
    assert mk.mlp_bwd_tile(3072, "wgrad") == (128, 192, 1, 0)
    assert sw.attn_bwd_tile(96, "wgrad") == (128, 96, 1, 0)
    assert sw.attn_bwd_tile(384, "qkv", True) == sw.attn_gemm_tile(384, "qkv", True)
    assert ("mlp_bwd", 96, 0, 0) in stub_lib.calls and ("attn_bwd", 96, 2, 0) in stub_lib.calls
    plan = mk.mlp_bwd_plan(16 * 256, 384, 1536, H100_SMS)
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
    per_sm = cuda_build.blocks_per_sm("dsg_swin_attn_bwd_core_per_sm", L)
    wpb = window_core_plan(n_windows, heads, classes, per_sm, H100_SMS)
    runs = window_runs(n_windows, classes, wpb)
    assert len(runs) == sw.core_blocks(n_windows, classes, wpb)
    assert all(runs) and sorted(w for r in runs for w in r) == list(range(n_windows))
