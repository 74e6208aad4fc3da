"""A stub of the kernel library's tile queries (diffusesg_torch/csrc,
``dsg_*_tile`` and ``dsg_*_per_sm``), answering as the H100 build does, so
that the grid plans of the wrappers can be checked on the CPU.  Install it
with ``install(monkeypatch)``."""
from diffusesg_torch.ops import cuda_build


def attn_tile(c, which, wide=0):
    """What the H100 build reports for swin_attn's GEMMs (rows, columns,
    blocks an SM, 0): 128-row panels up to C384 (two blocks an SM while the
    panel is at most 48 KB), 64-row panels at C768 or where asked for."""
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


READOUT_TILE = (64, 2, 2, 0)  # rows a tile, warpgroups a block, blocks an SM


class StubLib:
    """The library's tile queries, answering as the H100 build."""

    def __init__(self):
        self.calls = []

    def _fill(self, geom, values):
        for i, v in enumerate(values):
            geom[i] = v
        return 0

    def dsg_swin_attn_gemm_tile(self, c, which, wide, geom):
        self.calls.append(("attn", c, which, wide))
        return self._fill(geom, attn_tile(c, which, wide))

    def dsg_patch_breakup_tile(self, cin, dim, which, geom):
        self.calls.append(("breakup", cin, dim, which))
        return self._fill(geom, breakup_tile(cin, dim, which))

    def dsg_patch_merge_tile(self, c, wide, geom):
        self.calls.append(("merge", c, wide))
        return self._fill(geom, merge_tile(c, wide))

    def dsg_readout_tile(self, geom):
        self.calls.append(("readout",))
        return self._fill(geom, READOUT_TILE)

    # the backward kernels' (csrc/swin_attn_bwd.cu, csrc/token_mlp_bwd.cu)
    def dsg_swin_attn_bwd_tile(self, c, which, wide, geom):
        self.calls.append(("attn_bwd", c, which, wide))
        if c % 32 or c <= 0 or c > 768:
            return -1
        return self._fill(geom, (attn_tile(c, 0, wide), STREAM_TILE, tokens_tile(c))[which])

    def dsg_token_mlp_bwd_tile(self, c, which, wide, geom):
        self.calls.append(("mlp_bwd", c, which, wide))
        if which == 0:
            return self._fill(geom, FUSED_MLP_BWD_TILE) if c in (96, 192) else -1
        if which == 3:
            return self._fill(geom, tokens_tile(c))
        if c % 32 or c <= 0 or c > 768:
            return -1
        return self._fill(geom, attn_tile(c, 0, wide) if which == 1 else STREAM_TILE)

    # the resampling layers' backwards' (csrc/patch_resample.cu): the wide
    # products (merge's dhn, the breakup's y and [dx | dskip]) on 128 x 192,
    # the breakup's dh2 on the streamed 128 x 96, the weight gradients on
    # the token-axis tile
    def dsg_patch_resample_bwd_tile(self, which, k, geom):
        self.calls.append(("resample_bwd", which, k))
        if k <= 0 or k % 8 or which not in range(7):
            return -1
        if which in (1, 5, 6):
            return self._fill(geom, tokens_tile(k))
        return self._fill(geom, STREAM_TILE if which == 3 else WIDE_STREAM_TILE)

    def dsg_patch_resample_bwd_rows_per_sm(self, which, width):
        return resample_rows_per_sm(which, width)

    def dsg_swin_attn_bwd_core_per_sm(self, L):
        return BWD_CORE_PER_SM.get(L, -1)

    # the int8 / bf16 micro-benchmark's (csrc/mm_microbench.cu)
    def dsg_mm_accumulate_tile(self, n, k, is_int8, geom):
        self.calls.append(("mm", n, k, is_int8))
        if n <= 0 or k <= 0 or k % 32:
            return -1
        tile = mm_tile(n, is_int8)
        return -1 if tile is None else self._fill(geom, tile)


# the backward's tiles: the streamed products (dy Wproj, dqkv Wqkv, dout W2,
# du W1), the fused MLP row tile (rows, hidden chunk, blocks an SM, 1), the
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
    """Route cuda_build.lib() to a fresh StubLib (and clear the cached
    queries); returns the stub."""
    stub = StubLib()
    cuda_build.tile_of.cache_clear()
    cuda_build.blocks_per_sm.cache_clear()
    monkeypatch.setattr(cuda_build, "lib", lambda: stub)
    return stub
