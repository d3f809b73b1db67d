"""The input pipeline's host fast paths (``fastops.c``, the port's copy of
``tvqaplus_tpu/native``), loaded with ctypes.

The library is built at first use with the system's C compiler (``cc``)
into ``build/tvqaplus_tpu_torch/`` beside the package, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
never does.  There is no numpy fallback: a missing compiler raises.  The
tests hold every entry against the numpy code it replaces and against the
JAX package.

Each entry validates shapes, types and contiguity before it hands pointers
to C.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastops.c")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tvqaplus_tpu_torch")
CFLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_I32 = ctypes.c_int32


def lib_path():
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"fastops-{h.hexdigest()[:16]}.so")


def _build(out):
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        raise RuntimeError("no C compiler (cc, gcc or clang) to build the "
                           "pipeline's fast paths (tvqaplus_tpu_torch/"
                           "native/fastops.c)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cc, *CFLAGS, _SRC, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building fastops.c failed:\n{proc.stderr}")
    os.replace(tmp, out)     # atomic: a concurrent build never sees half


def get_lib():
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.pad_batch_f32.argtypes = [
                ctypes.POINTER(_P), ctypes.POINTER(_I32), _I32, _I32, _I32,
                _P, _P]
            lib.pad_batch_f32.restype = None
            lib.pad_batch_2d_f32.argtypes = [
                ctypes.POINTER(_P), ctypes.POINTER(_I32),
                ctypes.POINTER(_I32)] + [_I32] * 4 + [_P, _P]
            lib.pad_batch_2d_f32.restype = None
            lib.pairwise_iou_plus1.argtypes = [_P, _I32, _P, _I32, _P]
            lib.pairwise_iou_plus1.restype = None
            lib.iou_xyxy_plus1.argtypes = [_P, _P, _I32, _P]
            lib.iou_xyxy_plus1.restype = None
            lib.att_entries_f32.argtypes = [_P, _P] + [_I32] * 7 + [_P] * 5
            lib.att_entries_f32.restype = _I32
            lib.fill_sub_windows.argtypes = [_P, _I32, _I32, _I32, _P, _P]
            lib.fill_sub_windows.restype = _I32
            _lib = lib
    return _lib


def _out(a, dtype, shape, name):
    if a.dtype != dtype or a.shape != shape or not a.flags.c_contiguous:
        raise ValueError(f"{name}: needs a C-contiguous {np.dtype(dtype)} "
                         f"{shape} array, got {a.dtype} {a.shape}")


def pad_batch(arrays, max_len, out, mask=None):
    """Copy the ragged (len_i, dim) float32 ``arrays`` into the pre-zeroed
    (n, max_len, dim) ``out`` and set ``mask`` (n, max_len) to 1 on their
    rows, clipping at ``max_len`` (``batching.pad_into``)."""
    n = len(arrays)
    if n == 0:
        return
    dim = out.shape[-1]
    _out(out, np.float32, (n, max_len, dim), "out")
    if mask is not None:
        _out(mask, np.float32, (n, max_len), "mask")
    srcs = [np.ascontiguousarray(a, np.float32) for a in arrays]
    for a in srcs:
        if a.ndim != 2 or a.shape[1] != dim:
            raise ValueError(f"a row array of shape {a.shape}; the batch "
                             f"takes (len, {dim})")
    ptrs = (_P * n)(*[a.ctypes.data for a in srcs])
    lens = np.asarray([len(a) for a in srcs], np.int32)
    get_lib().pad_batch_f32(ptrs, lens.ctypes.data_as(ctypes.POINTER(_I32)),
                            n, max_len, dim, out.ctypes.data,
                            None if mask is None else mask.ctypes.data)


def pad_batch_2d(items, max_outer, max_inner, out, mask):
    """Copy a doubly ragged batch (``items[i]`` a list of (len_ij, dim)
    float32 arrays) into the pre-zeroed (n, max_outer, max_inner, dim)
    ``out`` and set ``mask`` (n, max_outer, max_inner) to 1 on their rows,
    clipping items past ``max_outer`` and rows past ``max_inner``."""
    n, dim = len(items), out.shape[-1]
    _out(out, np.float32, (n, max_outer, max_inner, dim), "out")
    _out(mask, np.float32, (n, max_outer, max_inner), "mask")
    srcs = [np.ascontiguousarray(a, np.float32) for ex in items for a in ex]
    for a in srcs:
        if a.ndim != 2 or a.shape[1] != dim:
            raise ValueError(f"an item of shape {a.shape}; the batch takes "
                             f"(len, {dim})")
    if not srcs:
        return
    ptrs = (_P * len(srcs))(*[a.ctypes.data for a in srcs])
    outer = np.asarray([len(ex) for ex in items], np.int32)
    inner = np.asarray([len(a) for a in srcs], np.int32)
    as_i32 = ctypes.POINTER(_I32)
    get_lib().pad_batch_2d_f32(
        ptrs, outer.ctypes.data_as(as_i32), inner.ctypes.data_as(as_i32), n,
        max_outer, max_inner, dim, out.ctypes.data, mask.ctypes.data)


def pairwise_iou(a, b):
    """(n, m) IoUs of xyxy boxes with the +1-pixel convention on areas and
    intersection (the detection evaluator's, evaluation/boxes.py), float64."""
    a = np.ascontiguousarray(a, np.float64).reshape(-1, 4)
    b = np.ascontiguousarray(b, np.float64).reshape(-1, 4)
    out = np.empty((len(a), len(b)), np.float64)
    get_lib().pairwise_iou_plus1(a.ctypes.data, len(a), b.ctypes.data,
                                 len(b), out.ctypes.data)
    return out


def iou_one_vs_many(gt_box, det_boxes):
    """IoUs (intersection +1 per side, raw areas; reference
    utils.py:506-522) of one xyxy box against (n, 4) xyxy boxes, float64."""
    gt = np.ascontiguousarray(gt_box, np.float64).reshape(4)
    dets = np.ascontiguousarray(det_boxes, np.float64).reshape(-1, 4)
    out = np.empty(len(dets), np.float64)
    get_lib().iou_xyxy_plus1(gt.ctypes.data, dets.ctypes.data, len(dets),
                             out.ctypes.data)
    return out


def att_entries(labels, defined, spec_dims, cap, entry_idx, entry_valid,
                neg_rows, rank, group_npos):
    """An example's dense att labels and defined mask (Li, Lw, Lr) -> the
    att loss's entry rows, clipped to ``spec_dims`` (li, lw, lr), written
    into the pre-zeroed rows of the batch (``labels.att_entries_from_dense``
    on the clipped dense copies).  Returns the positives before the cap."""
    labels = np.ascontiguousarray(labels, np.float32)
    defined = np.ascontiguousarray(defined, np.float32)
    if labels.ndim != 3 or labels.shape != defined.shape:
        raise ValueError(f"labels {labels.shape} / defined {defined.shape}")
    li, lw, lr = spec_dims
    for name, a, dt, shape in (
            ("entry_idx", entry_idx, np.int32, (cap,)),
            ("entry_valid", entry_valid, np.float32, (cap,)),
            ("neg_rows", neg_rows, np.float32, (cap, lr)),
            ("rank", rank, np.int32, (cap,)),
            ("group_npos", group_npos, np.float32, (cap,))):
        _out(a, dt, shape, name)
    return get_lib().att_entries_f32(
        labels.ctypes.data, defined.ctypes.data, *labels.shape, li, lw, lr,
        cap, entry_idx.ctypes.data, entry_valid.ctypes.data,
        neg_rows.ctypes.data, rank.ctypes.data, group_npos.ctypes.data)


def fill_sub_windows(spans, ls, n_tok, win_idx, mask):
    """Per-frame (start, len) token spans (n, 2) -> window gather indices
    and mask in the pre-zeroed (n, ls) rows ``win_idx`` / ``mask``; returns
    the tokens past ``n_tok`` (``batching._collate_sub_dedup``)."""
    spans = np.ascontiguousarray(spans, np.int64).reshape(-1, 2)
    n = len(spans)
    _out(win_idx, np.int32, (n, ls), "win_idx")
    _out(mask, np.float32, (n, ls), "mask")
    return get_lib().fill_sub_windows(spans.ctypes.data, n, ls, n_tok,
                                      win_idx.ctypes.data, mask.ctypes.data)
