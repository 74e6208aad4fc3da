"""The grid plans of the forward window core and of the fused MLP, on the CPU.

``window_core_plan`` (ops/swin_block_v3.py) gives the windows per block of
``window_attn_kernel`` (csrc/swin_window.cuh); ``mlp_fwd_plan``
(ops/mlp_block_kernel.py) the hidden split of ``token_mlp_kernel``
(csrc/token_mlp.cu).  The partitions below repeat the kernels' index math:
every window, and every hidden chunk, must be covered exactly once by a
block that has work, and the grid must aim at one wave of resident blocks.
On the card the wrappers read the blocks an SM holds, and the MLP's tile,
from the built library; here the plans get the H100 build's values.
"""
import pytest

from diffusesg_torch.ops.mlp_block_kernel import mlp_fwd_plan
from diffusesg_torch.ops.swin_block_v3 import window_core_plan

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
