"""A stub of the kernel library's tile queries (diffusesg_torch/csrc,
``dsg_*_tile`` and ``dsg_*_per_sm``), answering as the H100 build does, so
that the grid plans of the wrappers can be checked on the CPU.  Install it
with ``install(monkeypatch)``; the plans are asked about ``DEVICE``, which
the stub takes for one H100 as it takes any other device."""
import contextlib
import types

import torch

from diffusesg_torch.ops import cuda_build

DEVICE = torch.device("cuda", 0)
H100_PROPERTIES = types.SimpleNamespace(multi_processor_count=132)


def attn_tile(c, which, wide=0):
    """What the H100 build reports for a panel GEMM over C (rows, columns,
    blocks an SM, 0): swin_window.cuh's ``with_tile``, the backward's qkv
    recompute, takes 128-row panels up to C384 (two blocks an SM while the
    panel is at most 48 KB), 64-row panels at C768 or where asked for;
    patch_breakup's second product takes the 128-row one."""
    if c <= 384 and not wide:
        return (128, 96, 2 if c <= 192 else 1, 0)
    return (64, 192, 1, 0)


def breakup_tile(cin, dim, which):
    """The same for patch_breakup: the first product holds whole rows up to
    4c = 384 (the fused path), else 128 x 96 tiles; the second is a panel GEMM
    over c."""
    if which == 1:
        return attn_tile(dim // 4, 0)
    return (64, 384, 1, 1) if dim <= 384 else (128, 96, 2, 0)


def merge_tile(c, wide=0):
    """The same for patch_merge (K = 4C): 128-row panels up to K = 384 unless
    asked for 64, 64-row panels up to 768, the one-warpgroup 64 x 96 tile up
    to 1536; one block an SM (the panel takes most of the shared memory)."""
    if 4 * c > 768:
        return (64, 96, 1, 0)
    if 4 * c > 384 or wide:
        return (64, 192, 1, 0)
    return (128, 96, 1, 0)


# swin_attn's kernel by (C, L): rows, windows a block, blocks an SM, the most
# heads a block holds (csrc/swin_attn.cu, with_attn_tile)
SWIN_ATTN_TILE = {(64, 64): (64, 1, 2, 2), (96, 64): (64, 1, 2, 3), (192, 64): (64, 1, 1, 6),
                  (384, 64): (64, 1, 1, 12), (768, 64): (64, 1, 1, 12),
                  (64, 100): (112, 1, 1, 2), (96, 100): (112, 1, 1, 3),
                  (192, 100): (112, 1, 1, 6), (384, 100): (112, 1, 1, 6)}
READOUT_TILE = (64, 2, 2, 0)  # rows a tile, warpgroups a block, blocks an SM
# the fused MLP's tile by C: token rows, hidden chunk, blocks an SM, and the
# column groups a row tile's fc2 columns are cut into (a block each)
MLP_TILE = {64: (128, 64, 1, 1), 96: (128, 64, 1, 1), 192: (128, 64, 1, 1), 384: (64, 64, 1, 1),
            768: (64, 64, 1, 2)}


class StubLib:
    """The library's tile queries, answering as the H100 build.  ``calls``
    are the queries asked, ``under`` the device current at each."""

    def __init__(self):
        self.calls, self.under = [], []
        self.current = None

    @contextlib.contextmanager
    def device(self, device):
        """``torch.cuda.device``: ``device`` current inside."""
        prev, self.current = self.current, device
        try:
            yield
        finally:
            self.current = prev

    def _record(self, *call):
        self.calls.append(call)
        self.under.append(self.current)

    def _fill(self, geom, values):
        for i, v in enumerate(values):
            geom[i] = v
        return 0

    def dsg_swin_attn_tile(self, c, L, geom):
        self._record("attn", c, L)
        tile = SWIN_ATTN_TILE.get((c, L))
        return -1 if tile is None else self._fill(geom, tile)

    def dsg_patch_breakup_tile(self, cin, dim, which, geom):
        self._record("breakup", cin, dim, which)
        return self._fill(geom, breakup_tile(cin, dim, which))

    def dsg_patch_merge_tile(self, c, wide, geom):
        self._record("merge", c, wide)
        return self._fill(geom, merge_tile(c, wide))

    def dsg_token_mlp_tile(self, c, geom):
        self._record("mlp", c)
        return self._fill(geom, MLP_TILE[c]) if c in MLP_TILE else -1

    def dsg_readout_tile(self, geom):
        self._record("readout")
        return self._fill(geom, READOUT_TILE)

    # the backward kernels' (csrc/swin_attn_bwd.cu, csrc/token_mlp_bwd.cu)
    def dsg_swin_attn_bwd_tile(self, c, which, wide, geom):
        self._record("attn_bwd", c, which, wide)
        if c % 32 or c <= 0 or c > 768:
            return -1
        stream = WIDE_STREAM_TILE if c >= 192 else STREAM_TILE  # with_stream_tile
        return self._fill(geom, (attn_tile(c, 0, wide), stream, tokens_tile(c))[which])

    def dsg_token_mlp_bwd_tile(self, c, which, wide, geom):
        self._record("mlp_bwd", c, which, wide)
        if which == 0:
            return self._fill(geom, FUSED_MLP_BWD_TILE) if c in (96, 192) else -1
        if which == 3:
            return self._fill(geom, tokens_tile(c))
        if c % 32 or c <= 0 or c > 768:
            return -1
        return self._fill(geom, attn_tile(c, 0, wide) if which == 1 else WIDE_STREAM_TILE)

    # the resampling layers' backwards' (csrc/patch_resample.cu): the wide
    # products (merge's dhn, the breakup's y and [dx | dskip]) on 128 x 192,
    # the breakup's dh2 on the streamed 128 x 96, the weight gradients on
    # the token-axis tile
    def dsg_patch_resample_bwd_tile(self, which, k, geom):
        self._record("resample_bwd", which, k)
        if k <= 0 or k % 8 or which not in range(7):
            return -1
        if which in (1, 5, 6):
            return self._fill(geom, tokens_tile(k))
        return self._fill(geom, STREAM_TILE if which == 3 else WIDE_STREAM_TILE)

    def dsg_patch_resample_bwd_rows_per_sm(self, which, width):
        self._record("resample_rows", which, width)
        return resample_rows_per_sm(which, width)

    def dsg_swin_attn_bwd_fused_tile(self, c, L, geom):
        self._record("attn_bwd_fused", c, L)
        tile = FUSED_ATTN_BWD_TILE.get((c, L))
        return -1 if tile is None else self._fill(geom, tile)

    def dsg_swin_attn_bwd_core_per_sm(self, L):
        self._record("attn_bwd_core", L)
        return BWD_CORE_PER_SM.get(L, -1)

    # the int8 / bf16 micro-benchmark's (csrc/mm_microbench.cu)
    def dsg_mm_accumulate_tile(self, n, k, is_int8, geom):
        self._record("mm", n, k, is_int8)
        if n <= 0 or k <= 0 or k % 32:
            return -1
        tile = mm_tile(n, is_int8)
        return -1 if tile is None else self._fill(geom, tile)


# the backward's tiles: the streamed products (dy Wproj and dqkv Wqkv on the
# wide tile from C192; the MLP chain's dout W2 and du W1 on it at every C it
# takes), the fused MLP row tile (rows, hidden chunk, blocks an SM, 1), the
# weight gradients' token-axis tile (192 columns where they divide the
# output's, else 96), the backward window core's blocks an SM by L
STREAM_TILE = (128, 96, 1, 0)
WIDE_STREAM_TILE = (128, 192, 1, 0)


def resample_rows_per_sm(which, width):
    """Blocks of the resampling backwards' row passes an SM holds (their
    registers): merge (which 0) by K = 4C, breakup (1) by c; -1 outside."""
    if which == 0:
        if width <= 0 or width % 8 or width > 1536:
            return -1
        return 9 if width <= 256 else 7 if width <= 512 else 5 if width <= 768 else 3
    if width <= 0 or width > 384:
        return -1
    return 8 if width <= 32 else 5 if width <= 96 else 3 if width <= 192 else 2
FUSED_MLP_BWD_TILE = (128, 64, 1, 1)
# the fused attention backward's tile by (C, L): rows, 0, blocks an SM, 0
# (csrc/swin_attn_bwd.cu, with_bwd_tile); the chain takes every other shape
FUSED_ATTN_BWD_TILE = {(96, 64): (64, 0, 1, 0)}
BWD_CORE_PER_SM = {64: 2, 100: 1}


def tokens_tile(j):
    return (128, 192 if j % 192 == 0 else 96, 1, 0)


def mm_tile(n, is_int8):
    """What the H100 build reports for mm_accumulate (rows, columns, blocks
    an SM, dynamic shared memory bytes): 128 rows, the widest of 256, 128,
    96, 64, 32 and 16 columns that divides n, a ring of four 128-byte K slots of A
    (128 rows) and B (int8: n rows transposed; bf16: 64-column boxes of 64
    K rows), one block an SM; None where no tile divides n."""
    cols = next((c for c in (256, 128, 96, 64, 32, 16) if n % c == 0), None)
    if cols is None:
        return None
    b_bytes = cols * 128 if is_int8 else -(-cols // 64) * 64 * 128
    return (128, cols, 1, 1024 + 4 * (128 * 128 + b_bytes))


def install(monkeypatch):
    """Route cuda_build.lib() to a fresh StubLib, ``torch.cuda.device`` to
    its stand-in (the CPU build has no devices to make current), and the
    device's properties to the H100's, and clear the cached queries; returns
    the stub."""
    stub = StubLib()
    for query in (cuda_build.tile_of, cuda_build.blocks_per_sm, cuda_build.sm_count):
        query.cache_clear()
    monkeypatch.setattr(cuda_build, "lib", lambda: stub)
    monkeypatch.setattr(torch.cuda, "device", stub.device)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: H100_PROPERTIES)
    return stub
