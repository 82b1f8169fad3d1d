"""The native C++ matching kernels of the mAP evaluators, via ctypes.

The port's own loader of native/det_eval.cpp (the source the JAX
package's native path builds too): ``g++`` compiles it at first use into
``build/native/libnsgp_det_eval_<hash>.so`` at the repository root, keyed
by a hash of the source and flags, so an edited source rebuilds. A failed
build raises; nothing falls back to numpy. The evaluators match through
it; their numpy matchers (voc_map.py::_tpfp_numpy,
coco_map.py::_match_numpy) are the references the tests hold it to.
Boxes cross as float64: float32 rounding flips the area-range class of
boundary boxes against the COCO protocol.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "det_eval.cpp"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's flags, with no contraction of a*b+c into one rounding,
# so the float64 IoUs round as numpy's do
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """Compile the source (if it or the flags changed) and return the .so path."""
    digest = hashlib.sha256((" ".join(CXXFLAGS)).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libnsgp_det_eval_{digest}.so"
    if path.is_file():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build native/det_eval.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)], stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True, timeout=300)
    if p.returncode != 0:
        raise RuntimeError(f"building native/det_eval.cpp failed:\n{p.stdout}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded library (built on first use). Arrays cross as raw
    pointers (``ndarray.ctypes.data``): the wrappers below make them
    contiguous and of the right dtype, and argument checks by ctypes cost
    more than most of the calls."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            handle.coco_match.argtypes = [ptr, i32, ptr, ptr, i32, ptr, i32, f64, f64, ptr, ptr,
                                          ptr]
            handle.coco_match.restype = None
            handle.voc_tpfp.argtypes = [ptr, i32, ptr, ptr, i32, f64, ptr, ptr]
            handle.voc_tpfp.restype = None
            _lib = handle
    return _lib


def coco_match(det_boxes, gt_boxes, gt_crowd, iou_thrs, area_lo: float,
               area_hi: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COCOeval's greedy match of one image and class over all IoU
    thresholds (dets sorted by score): (dt_matched (T, D), dt_ignore
    (T, D), gt_ignore (G,), in the given gt order), bool."""
    D, G, T = len(det_boxes), len(gt_boxes), len(iou_thrs)
    if D == 0 and G == 0:  # most of an evaluation's (image, class) pairs
        return np.zeros((T, 0), bool), np.zeros((T, 0), bool), np.zeros(0, bool)
    det_boxes = np.ascontiguousarray(det_boxes, np.float64)
    gt_boxes = np.ascontiguousarray(gt_boxes, np.float64)
    gt_crowd = np.ascontiguousarray(gt_crowd, np.uint8)
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64)
    dt = np.empty((2, T, max(D, 1)), np.uint8)  # the kernel writes every slot
    gti = np.empty(max(G, 1), np.uint8)
    lib().coco_match(det_boxes.ctypes.data, D, gt_boxes.ctypes.data, gt_crowd.ctypes.data, G,
                     iou_thrs.ctypes.data, T, float(area_lo), float(area_hi), dt[0].ctypes.data,
                     dt[1].ctypes.data, gti.ctypes.data)
    dt = dt[:, :, :D].astype(bool)
    return dt[0], dt[1], gti[:G].astype(bool)


def voc_tpfp(det_boxes, gt_boxes, gt_ignore, iou_thr: float) -> Tuple[np.ndarray, np.ndarray]:
    """VOC TP/FP flags of one image and class (dets sorted by score), f32."""
    D, G = len(det_boxes), len(gt_boxes)
    if D == 0 or G == 0:  # nothing to match: every det is a false positive
        return np.zeros(D, np.float32), np.ones(D, np.float32)
    det_boxes = np.ascontiguousarray(det_boxes, np.float64)
    gt_boxes = np.ascontiguousarray(gt_boxes, np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, np.uint8)
    out = np.empty((2, D), np.float32)  # the kernel writes every slot
    lib().voc_tpfp(det_boxes.ctypes.data, D, gt_boxes.ctypes.data, gt_ignore.ctypes.data, G,
                   float(iou_thr), out[0].ctypes.data, out[1].ctypes.data)
    return out[0], out[1]
