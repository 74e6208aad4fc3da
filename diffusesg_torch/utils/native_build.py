"""Build and load the port's host C++ engines (``g++``, ``ctypes``).

Counterpart of diffusesg_tpu/utils/native_build.py, used by
``eval/native`` (the VOC F1 matcher) and ``data/native`` (the batch
assembler).  The library lands in the port's
``build/native/<hash>/`` beside the package (as the CUDA kernels land in
``build/kernels/``), keyed by a hash of the source and flags, so an edited
source rebuilds and an unchanged one loads at once.  The build is atomic:
``g++`` writes a per-process temporary file that is renamed into place, so
a concurrent process never loads a half-written library.  A missing
compiler or a failed build or load returns None, and the caller runs its
numpy version.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "native"


def native_lib_path(src: str | os.PathLike, extra_flags=()) -> Path:
    """Where the library of ``src`` is built: keyed by its text and the flags."""
    src = Path(src)
    flags = " ".join([*GXX_FLAGS, *extra_flags]).encode()
    digest = hashlib.sha256(src.read_bytes() + flags).hexdigest()[:16]
    return BUILD_ROOT / digest / f"lib{src.stem}.so"


def load_native_lib(src: str | os.PathLike, extra_flags=()) -> ctypes.CDLL | None:
    """Build ``src`` (with ``extra_flags`` after the common ones) unless
    built, and load it; None (logged) on any failure."""
    try:
        so = native_lib_path(src, extra_flags)
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = f"{so}.build.{os.getpid()}"
            subprocess.run(["g++", *GXX_FLAGS, *extra_flags, str(src), "-o", tmp], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, so)
        return ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or e
        logging.warning("native library of %s unavailable (%s); using numpy",
                        os.path.basename(str(src)), detail)
        return None
