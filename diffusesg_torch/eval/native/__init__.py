"""Native (C++) VOC F1 engine: built with ``g++`` at first use, loaded with
``ctypes``.

Counterpart of diffusesg_tpu/eval/native/__init__.py with the port's own
copy of ``voc_f1.cc``.  The Pascal-VOC F1 matrix over every generated x
reference scene pair is the one hot host metric; ``eval/voc_f1.py`` is its
numpy version, the oracle, and what runs when the library does not build.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ...utils.native_build import load_native_lib

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "voc_f1.cc")
_LIB = None
_TRIED = False
# the kernel's stack buffers hold at most this many class weightings
MAX_WEIGHTINGS = 16

_D = ctypes.POINTER(ctypes.c_double)
_L = ctypes.POINTER(ctypes.c_int64)
_U = ctypes.POINTER(ctypes.c_uint8)
_I = ctypes.c_int


def get_lib():
    """The loaded library (built on the first call), or None."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        lib = load_native_lib(SRC)
        if lib is not None:
            lib.compute_f1_matrix.restype = None
            lib.compute_f1_matrix.argtypes = [_D, _L, _U, _D, _L, _U, _I, _I, _I, _D, _I, _D,
                                              _I, _I, _D]
            _LIB = lib
    return _LIB


def compute_bbox_f1_native(node_bbox_gen, node_types_gen, node_flags_gen,
                           node_bbox_ref, node_types_ref, node_flags_ref,
                           class_weight_ls=None, iou_range=None):
    """The native ``eval.voc_f1.compute_bbox_f1``; None when the library is
    unavailable or there are more class weightings than it holds."""
    from ..voc_f1 import DEFAULT_IOU_RANGE, _valid_boxes
    lib = get_lib()
    if lib is None:
        return None
    iou_range = DEFAULT_IOU_RANGE if iou_range is None else iou_range

    bg = np.ascontiguousarray(node_bbox_gen, np.float64)
    br = np.ascontiguousarray(node_bbox_ref, np.float64)
    tg = np.ascontiguousarray(node_types_gen, np.int64)
    tr = np.ascontiguousarray(node_types_ref, np.int64)
    fg = np.ascontiguousarray(_valid_boxes(bg, np.asarray(node_flags_gen)), np.uint8)
    fr = np.ascontiguousarray(_valid_boxes(br, np.asarray(node_flags_ref)), np.uint8)
    b_gen, n = tg.shape
    b_ref = tr.shape[0]
    num_classes = int(max(tg.max(initial=0), tr.max(initial=0))) + 1
    if class_weight_ls is None:
        warr = [np.ones(num_classes)]
    else:
        warr = [np.asarray(w, np.float64) for w in class_weight_ls]
        num_classes = max(num_classes, *(len(w) for w in warr))
        warr = [np.pad(w, (0, num_classes - len(w))) for w in warr]
    if len(warr) > MAX_WEIGHTINGS:
        return None
    weights = np.ascontiguousarray(np.stack(warr), np.float64)
    thr = np.ascontiguousarray(np.asarray(iou_range, np.float64))
    out = np.zeros((b_gen, b_ref, len(warr)), np.float64)

    def ptr(a, kind):
        return a.ctypes.data_as(kind)
    lib.compute_f1_matrix(ptr(bg, _D), ptr(tg, _L), ptr(fg, _U), ptr(br, _D), ptr(tr, _L),
                          ptr(fr, _U), b_gen, b_ref, n, ptr(thr, _D), len(thr),
                          ptr(weights, _D), len(warr), num_classes, ptr(out, _D))
    return out
