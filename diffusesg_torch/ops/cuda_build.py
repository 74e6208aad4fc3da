"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``diffusesg_torch/csrc`` are compiled at first use with
``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all started together,
then one link) into a shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``build/kernels/<hash>/`` beside the
package, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.

``LAUNCHES`` counts kernel launches per kernel name and shape; each wrapper
adds one where it launches its kernel and nowhere else.  A launch made
while a CUDA graph is captured (``capturing``) is counted in the graph's
own record instead, and whoever replays the graph adds that record to
``LAUNCHES`` at each replay (``utils/cuda_graphs.py``): the counts are the
kernels that ran.  Every launch goes
through ``launch``, which makes the operands' card current: the library
launches on the calling thread's current device and opts each kernel in to
its shared memory once on each device.

Helpers of the wrappers live here too: ``split_count`` plans the grids of
the backward kernels' reductions and ``token_split`` the token split of
their weight gradients (the wrapper allocates their partials),
``wave_split`` the column splits of the forward kernels whose row tiles are
too few to fill the card (``gemm_plan`` and ``wide_panels`` apply it to the
Hopper GEMM of csrc/hopper_gemm.cuh), ``sm_count`` and ``blocks_per_sm`` give the
grid plans a card's SM count and a kernel's occupancy on it, ``tile_of``
reads a kernel's tile on a card from the library, ``records`` says whether a
kernel with no backward may run, and ``plain_vjp`` is the backward of the
kernels that differentiate their plain version.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: pointers and the stream as c_void_p
_SIGNATURES = {
    "dsg_swin_attn": [_P] * 12 + [_I] * 8 + [_P],
    "dsg_token_mlp": [_P] * 9 + [_I] * 4 + [_P],
    "dsg_swin_attn_bwd": [_P] * 28 + [_I] * 17 + [_P],
    "dsg_swin_attn_bwd_fused": [_P] * 23 + [_I] * 10 + [_P],
    "dsg_token_mlp_bwd": [_P] * 20 + [_I] * 13 + [_P],
    "dsg_readout": [_P] * 6 + [_I] * 5 + [_P],
    "dsg_readout_head": [_P] * 16 + [_I] * 4 + [_P],
    "dsg_patch_embed": [_P] * 11 + [_I] * 7 + [_P],
    "dsg_patch_merge": [_P] * 5 + [_I] * 7 + [_P],
    "dsg_patch_breakup": [_P, _P, _I, _I] + [_P] * 9 + [_I] * 6 + [_P],
    "dsg_patch_merge_bwd": [_P] * 6 + [_I] + [_P] * 7 + [_I] * 9 + [_P],
    "dsg_patch_breakup_bwd": [_P, _P, _I, _I] + [_P] * 19 + [_I] * 12 + [_P],
    "dsg_window_attention": [_P] * 6 + [_I] * 6 + [_F, _P],
    "dsg_mm_accumulate": [_P] * 3 + [_I] * 6 + [_P],
    # the forward grid plans' queries: a kernel's tile and its occupancy
    "dsg_token_mlp_tile": [_I, ctypes.POINTER(_I)],
    "dsg_swin_attn_tile": [_I, _I, ctypes.POINTER(_I)],
    "dsg_swin_attn_bwd_tile": [_I, _I, _I, ctypes.POINTER(_I)],
    "dsg_swin_attn_bwd_fused_tile": [_I, _I, ctypes.POINTER(_I)],
    "dsg_token_mlp_bwd_tile": [_I, _I, _I, ctypes.POINTER(_I)],
    "dsg_patch_breakup_tile": [_I, _I, _I, ctypes.POINTER(_I)],
    "dsg_patch_merge_tile": [_I, _I, ctypes.POINTER(_I)],
    "dsg_patch_resample_bwd_tile": [_I, _I, ctypes.POINTER(_I)],
    "dsg_readout_tile": [ctypes.POINTER(_I)],
    "dsg_readout_head_tile": [ctypes.POINTER(_I)],
    "dsg_patch_embed_tile": [ctypes.POINTER(_I)],
    "dsg_mm_accumulate_tile": [_I, _I, _I, ctypes.POINTER(_I)],
    "dsg_patch_resample_bwd_rows_per_sm": [_I, _I],
    "dsg_swin_attn_bwd_core_per_sm": [_I],
    "dsg_window_attention_per_sm": [_I],
}

LAUNCHES: collections.Counter = collections.Counter()

# blocks a split reduction aims for: four per SM of the H100's 132
TARGET_BLOCKS = 528
# tokens of a box of the token-axis contraction (csrc/backward.cuh), and the
# fewest a split of it takes unless there are fewer
TOKEN_BOX, TOKEN_SPLIT_MIN = 64, 512

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# capture stream -> the record of the graph captured on it
_stream_records: dict[int, collections.Counter] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def launches_by_kernel() -> dict[str, int]:
    out: dict[str, int] = collections.Counter()
    for (name, _shape), n in LAUNCHES.items():
        out[name] += n
    return dict(out)


def count_launch(name: str, shape: str) -> None:
    record = _stream_records.get(torch.cuda.current_stream().cuda_stream) \
        if _stream_records else None
    (LAUNCHES if record is None else record)[(name, shape)] += 1


@contextlib.contextmanager
def capturing(record: collections.Counter, stream):
    """Count the launches into ``stream`` in ``record`` rather than
    ``LAUNCHES`` while a CUDA graph is captured on it: a captured launch
    runs only when the graph is replayed.  Keyed by the stream, not the
    thread: the autograd engine runs a backward's CUDA nodes on a thread of
    its own, on the capture stream."""
    key = stream.cuda_stream
    _stream_records[key] = record
    try:
        yield record
    finally:
        _stream_records.pop(key, None)


def split_count(parallel: int, length: int, min_len: int, align: int = 1) -> int:
    """Into how many parts to split a reduction over ``length`` rows that
    already runs as ``parallel`` independent blocks, so that the grid reaches
    about ``TARGET_BLOCKS``: every part is at least ``min_len`` rows (unless
    ``length`` is shorter), a multiple of ``align``, and none is empty."""
    want = max(1, min(-(-TARGET_BLOCKS // max(parallel, 1)), length // min_len))
    chunk = -(-length // want)
    chunk = -(-chunk // align) * align
    return -(-length // chunk)


def token_split(tiles: int, tokens: int, per_sm: int, sms: int = 132) -> tuple[int, int]:
    """(splits, chunk) of a token-axis contraction (the weight gradients of
    csrc/backward.cuh) whose output is ``tiles`` blocks: the ``tokens`` cut
    into chunks of whole 64-token boxes, at least ``TOKEN_SPLIT_MIN`` tokens
    each, so that tiles x splits fill about one wave of resident blocks
    (``sms`` x ``per_sm``); block z covers [z chunk, (z + 1) chunk), and no
    split is empty."""
    want = max(1, min(sms * per_sm // max(tiles, 1), tokens // TOKEN_SPLIT_MIN))
    chunk = -(-(-(-tokens // want)) // TOKEN_BOX) * TOKEN_BOX
    return -(-tokens // chunk), chunk


def wave_split(row_tiles: int, col_tiles: int, per_sm: int, sms: int) -> tuple[int, int]:
    """Into how many splits of how many column tiles each to cut
    ``col_tiles``, so that ``row_tiles`` x splits fills about one wave of
    resident blocks (``sms`` x ``per_sm``, the blocks an SM holds) without
    passing it: (splits, tiles per split).  Every split gets at least one
    tile; one split when the row tiles alone fill the wave."""
    want = max(1, min(col_tiles, sms * per_sm // row_tiles))
    per = -(-col_tiles // want)
    return -(-col_tiles // per), per


def gemm_plan(m: int, n: int, tile: tuple[int, ...], sms: int = 132) -> dict[str, int]:
    """Grid plan of a Hopper GEMM (csrc/hopper_gemm.cuh) over ``m`` rows and
    ``n`` output columns: a block owns ``tile[0]`` rows and walks ``tiles``
    column tiles of ``tile[1]``; where the row tiles alone cannot fill one
    wave of resident blocks (``sms`` x ``tile[2]``, the blocks an SM holds)
    the columns are cut into ``splits`` (each split redoes its rows'
    prologue).  ``tile`` is what the library reports for the launch
    (``swin_block_v3.attn_bwd_tile``, ``patch_resample.merge_tile``,
    ``patch_resample.breakup_tile``)."""
    rows, cols, per_sm = tile[:3]
    splits, per = wave_split(-(-m // rows), -(-n // cols), per_sm, sms)
    return dict(splits=splits, tiles=per)


def wide_panels(m: int, n: int, tile_for, sms: int = 132) -> bool:
    """Whether a panel GEMM (mode (a) of csrc/hopper_gemm.cuh) over ``m``
    rows and ``n`` columns takes 64-row panels: where the default tile's
    (``tile_for(False)``) N splits outnumber the blocks an SM holds.  Every
    split redoes its rows' prologue (a LayerNorm); up to that count
    co-resident blocks overlap one another's prologue with their products,
    beyond it the repeated prologue sets the pace, and halving the rows a
    block normalizes halves it."""
    tile = tile_for(False)
    return gemm_plan(m, n, tile, sms)["splits"] > tile[2]


@functools.lru_cache(maxsize=None)
def tile_of(device: torch.device, query: str, *args: int) -> tuple[int, ...]:
    """A kernel's tile on ``device`` from the library's ``query`` entry, run
    under it (the library answers for the current card), which fills four
    ints (rows, columns, blocks an SM holds at these widths, a flag); raises
    ValueError for widths the kernel is not built for."""
    geom = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = getattr(lib(), query)(*args, geom)
    if rc == -1:
        raise ValueError(f"{query}{args}: no tile covers these widths")
    check(rc, query)
    if geom[2] <= 0:
        raise RuntimeError(f"{query}{args}: no occupancy")
    return tuple(geom)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on the H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device: torch.device, query: str, *args: int) -> int:
    """Blocks of a kernel an SM of ``device`` holds, from the library's
    ``query`` entry run under it (the card's occupancy for the kernel)."""
    with torch.cuda.device(device):
        n = getattr(lib(), query)(*args)
    if n <= 0:
        raise RuntimeError(f"{query}{args}: no occupancy (error {n})")
    return n


def records(*tensors) -> bool:
    """Whether autograd records a graph through any of ``tensors`` (None
    skipped), where a kernel with no backward may not run."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def plain_vjp(plain_fn, tensors, grad_out):
    """Gradients of ``plain_fn(*tensors)`` w.r.t. every tensor (None stays
    None), by recomputing it under ``torch.enable_grad()`` and differentiating:
    the backward of the kernels whose TPU counterpart differentiates its XLA
    composition instead of running a backward kernel."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(True) for t in tensors]
        out = plain_fn(*leaves)
        grads = iter(torch.autograd.grad(out, [t for t in leaves if t is not None],
                                         grad_out.to(out.dtype)))
    return tuple(None if t is None else next(grads) for t in leaves)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def build_dir() -> Path:
    return CSRC.parent.parent / "build" / "kernels" / source_hash()


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this source hash is already built; returns
    the library path.  Raises with nvcc's output when a source fails."""
    out_dir = build_dir()
    lib_path = out_dir / "libdsg_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir.parent) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, _obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
            elif verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = os.path.join(tmp, lib_path.name)
        link = subprocess.run([nvcc, "-shared", "-o", tmp_lib] + [o for _, o, _ in procs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib_path)
    return lib_path


def nvcc_version() -> str | None:
    """The last line of ``nvcc --version`` (its release), None without nvcc."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[-1] if out.returncode == 0 and lines else None


def install(lib_file, built_hash: str) -> Path:
    """Adopt ``lib_file``, a library built from sources of hash
    ``built_hash``, as this tree's build: copied to where ``build`` looks
    unless a library of the hash is there already.  Raises when the hash is
    not the tree's sources': the library would launch other kernels."""
    if built_hash != source_hash():
        raise RuntimeError(f"the kernel library {lib_file} was built from sources of hash "
                           f"{built_hash}, and these sources hash to {source_hash()}")
    lib_path = build_dir() / "libdsg_kernels.so"
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
            tmp_lib = os.path.join(tmp, lib_path.name)
            shutil.copyfile(lib_file, tmp_lib)
            os.replace(tmp_lib, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device: torch.device, entry: str, *args) -> None:
    """Call the library's ``entry`` with ``args`` and ``device``'s current
    stream, with ``device`` the current one: the library launches on the
    calling thread's current device and opts each kernel in to its shared
    memory once on each device, so the operands' card must be current.
    Raises when the launch fails (``name`` the kernel's)."""
    with torch.cuda.device(device):
        rc = getattr(lib(), entry)(*args, stream_ptr(device))
    check(rc, name)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (error {rc})")


def require(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """Device, type and contiguity check of a kernel operand."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    return t.contiguous()
