"""Native (C++) batch assembly: built with ``g++`` at first use, loaded with
``ctypes``.

Counterpart of diffusesg_tpu/data/native/__init__.py with the port's own
copy of ``batcher.cc``: the row gather of ``data/loader.Batches`` in
GIL-free C++ threads with a bounded ring of pre-assembled batches, so the
next batches are gathered while the current one is consumed.  The numpy
gather of ``Batches`` is the oracle and what runs when the library does not
build; both take the same permutation, so their batches are bit-equal.
``DSG_NATIVE_LOADER=0`` turns it off.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ...utils.native_build import load_native_lib

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "batcher.cc")
DEPTH, THREADS = 3, 2
_LIB = None
_TRIED = False


def get_lib():
    """The loaded library (built on the first call), or None when it is
    turned off or does not build."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        if os.environ.get("DSG_NATIVE_LOADER", "1") == "0":
            return None
        lib = load_native_lib(SRC, extra_flags=("-pthread",))
        if lib is not None:
            lib.batcher_create.restype = ctypes.c_void_p
            lib.batcher_create.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int]
            lib.batcher_next.restype = ctypes.c_int64
            lib.batcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
            lib.batcher_destroy.restype = None
            lib.batcher_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def iter_batches_native(arrays: list[np.ndarray], perm: np.ndarray, batch_size: int):
    """Yield ``tuple(a[perm[s:s + batch_size]] for a in arrays)`` for each
    batch start ``s``, gathered by the native engine (one engine per call;
    leaving the generator early destroys it).  The caller checks
    ``get_lib()`` first.  The engine keeps ``DEPTH`` batches ready,
    gathered by ``THREADS`` threads (the JAX package's defaults)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native batcher is not available")
    arrays = [np.ascontiguousarray(a) for a in arrays]
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if len(perm) and (perm.min() < 0 or perm.max() >= arrays[0].shape[0]):
        raise ValueError(f"permutation indexes outside the dataset: [{perm.min()}, "
                         f"{perm.max()}] against {arrays[0].shape[0]} rows")
    n_arr = len(arrays)
    bases = (ctypes.c_void_p * n_arr)(*[a.ctypes.data_as(ctypes.c_void_p).value
                                        for a in arrays])
    row_bytes = (ctypes.c_int64 * n_arr)(
        *[int(a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))) for a in arrays])
    handle = lib.batcher_create(n_arr, bases, row_bytes, int(arrays[0].shape[0]),
                                perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(perm),
                                int(batch_size), DEPTH, THREADS)
    if not handle:
        raise ValueError("the native batcher refused the permutation")
    try:
        while True:
            outs = [np.empty((batch_size,) + a.shape[1:], dtype=a.dtype) for a in arrays]
            ptrs = (ctypes.c_void_p * n_arr)(*[o.ctypes.data_as(ctypes.c_void_p).value
                                               for o in outs])
            rows = lib.batcher_next(handle, ptrs)
            if rows == 0:
                break
            yield tuple(o[:rows] for o in outs)
    finally:
        lib.batcher_destroy(handle)
