"""ctypes binding of the host C++ library of the KITTI AP harness
(csrc/ws3d_host.cpp, built by ``make -C csrc`` into csrc/libws3d_host.so):
the rotated BEV overlap and the per-frame statistics. A copy of the parts of
ws3d_tpu/native/__init__.py that eval.kitti_ap uses, loading the same
library. The library is built at first use when it is absent (without
OpenMP where the compiler has none); where it cannot be built or loaded,
``available()`` is False and the harness takes its NumPy path, which
computes the same numbers.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
LIB_PATH = os.path.join(_CSRC, "libws3d_host.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


# csrc/Makefile's flags without -fopenmp, for a compiler that has no OpenMP
# runtime (the library's only OpenMP use is two `omp parallel for` pragmas,
# whose loops give the same results serially)
_SERIAL_FLAGS = "CXXFLAGS=-O3 -march=native -fPIC -shared -Wall"


def _build() -> bool:
    """make -C csrc, then, if that fails, the same without OpenMP."""
    for extra in ([], [_SERIAL_FLAGS]):
        try:
            subprocess.run(["make", "-C", _CSRC, *extra], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        if os.path.exists(LIB_PATH):
            return True
    return False


def load() -> Optional[ctypes.CDLL]:
    """The library with its signatures declared, or None where it cannot be
    built or loaded (tried once a process)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ws3d_rotate_iou_eval.argtypes = [dp, ctypes.c_int64, dp,
                                         ctypes.c_int64, ctypes.c_int, dp]
    lib.ws3d_compute_statistics.argtypes = [
        dp, dp, ctypes.c_int64, dp, ctypes.c_int64, i64p, i64p, dp,
        ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, dp, dp, i64p]
    lib.ws3d_fused_statistics.argtypes = [
        dp, dp, ctypes.c_int64, dp, ctypes.c_int64, i64p, i64p, dp,
        ctypes.c_int64, ctypes.c_int, ctypes.c_double, dp, ctypes.c_int64,
        ctypes.c_int, dp]
    for fn in (lib.ws3d_rotate_iou_eval, lib.ws3d_compute_statistics,
               lib.ws3d_fused_statistics):
        fn.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _frame(overlaps, gt_data, dt_data, ignored_gt, ignored_det, dc_bboxes):
    """The arrays of one frame, contiguous in the library's types."""
    dc = dc_bboxes if len(dc_bboxes) else np.zeros((0, 4))
    return (np.ascontiguousarray(overlaps, np.float64),
            np.ascontiguousarray(gt_data, np.float64),
            np.ascontiguousarray(dt_data, np.float64),
            np.ascontiguousarray(ignored_gt, np.int64),
            np.ascontiguousarray(ignored_det, np.int64),
            np.ascontiguousarray(dc, np.float64))


def rotate_iou_eval(boxes: np.ndarray, qboxes: np.ndarray,
                    criterion: int = -1) -> np.ndarray:
    """The contract of eval.rotate_iou_np.rotate_iou_eval."""
    lib = load()
    boxes = np.ascontiguousarray(boxes, np.float64)
    qboxes = np.ascontiguousarray(qboxes, np.float64)
    n, k = boxes.shape[0], qboxes.shape[0]
    out = np.zeros((n, k), np.float64)
    if n and k:
        lib.ws3d_rotate_iou_eval(_dptr(boxes), n, _dptr(qboxes), k,
                                 criterion, _dptr(out))
    return out


def compute_statistics(overlaps, gt_data, dt_data, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """The contract of eval.kitti_ap.compute_statistics."""
    lib = load()
    ov, gt, dt, ig, idt, dc = _frame(overlaps, gt_data, dt_data, ignored_gt,
                                     ignored_det, dc_bboxes)
    out4 = np.zeros(4, np.float64)
    thr = np.zeros(max(gt.shape[0], 1), np.float64)
    n_thr = np.zeros(1, np.int64)
    lib.ws3d_compute_statistics(
        _dptr(ov), _dptr(gt), gt.shape[0], _dptr(dt), dt.shape[0],
        _i64ptr(ig), _i64ptr(idt), _dptr(dc), dc.shape[0], metric,
        min_overlap, thresh, int(compute_fp), int(compute_aos), _dptr(out4),
        _dptr(thr), _i64ptr(n_thr))
    return (int(out4[0]), int(out4[1]), int(out4[2]), float(out4[3]),
            thr[: int(n_thr[0])])


def fused_statistics(overlaps, gt_data, dt_data, ignored_gt, ignored_det,
                     dc_bboxes, metric, min_overlap, thresholds,
                     compute_aos, pr):
    """Add one frame's tp / fp / fn / similarity at every threshold into
    pr, a C-contiguous float64 (len(thresholds), 4) array."""
    if not (pr.flags["C_CONTIGUOUS"] and pr.dtype == np.float64
            and pr.shape == (len(thresholds), 4)):
        raise ValueError("pr must be a C-contiguous float64 "
                         "(len(thresholds), 4) array")
    lib = load()
    ov, gt, dt, ig, idt, dc = _frame(overlaps, gt_data, dt_data, ignored_gt,
                                     ignored_det, dc_bboxes)
    thresholds = np.ascontiguousarray(thresholds, np.float64)
    lib.ws3d_fused_statistics(
        _dptr(ov), _dptr(gt), gt.shape[0], _dptr(dt), dt.shape[0],
        _i64ptr(ig), _i64ptr(idt), _dptr(dc), dc.shape[0], metric,
        min_overlap, _dptr(thresholds), thresholds.shape[0],
        int(compute_aos), _dptr(pr))
