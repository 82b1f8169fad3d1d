"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
(one ``nvcc`` process per source, all started together), and the objects
are linked into ONE shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use (the first wrapper call on a CUDA
tensor, or :func:`build`), writes to ``build/kernels/`` at the repository
root, and is keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that it
went through the kernels (``reset_launches`` zeroes the counts).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
]
# NMS, RoIAlign and the anchor assignment keep every multiply and add
# separately rounded, so a box pair at the IoU threshold, an anchor tying
# a gt's best IoU and every sample coordinate round exactly as in the
# plain versions
EXTRA_FLAGS = {"nms.cu": ["-fmad=false"], "roi_align.cu": ["-fmad=false"],
               "assign.cu": ["-fmad=false"]}

LAUNCHES: Dict[str, int] = {"conv3x3": 0, "rpn_head": 0, "nms": 0, "roi_align": 0,
                            "roi_align_bwd": 0, "assign": 0, "gather": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "nsgp_conv3x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "nsgp_nms": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "nsgp_roi_align": [
        _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P,
    ],
    "nsgp_roi_align_bwd": [
        _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _F, _I, _P,
    ],
    "nsgp_roi_footprints": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _I, _P],
    "nsgp_assign": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
    "nsgp_gather": [_P, _P, _P, _L, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a host with the "
            "CUDA toolkit (set CUDA_HOME)"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(" ".join(EXTRA_FLAGS.get(src.name, [])).encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if the sources changed) and return the .so path."""
    lib_path = BUILD_DIR / f"libnsgp_kernels_{_digest()}.so"
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + f"_{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(src.name, []), "-c", str(src),
               "-o", str(obj)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(out, flush=True)
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
            str(tmp), *[str(o) for _, o, _ in procs]]
    p = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if p.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + p.stdout)
    os.replace(tmp, lib_path)
    for _, o, _ in procs:
        o.unlink(missing_ok=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
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


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a nonzero cudaGetLastError code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def require_cuda(t: torch.Tensor, name: str, dtypes=(torch.float32, torch.bfloat16)):
    """Check one CUDA kernel argument (device, dtype, contiguity)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
