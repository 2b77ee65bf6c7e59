"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Pointers and
the CUDA stream go over as ``c_void_p``; every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on a
non-zero code.

Libraries land in ``build/roadvision_tpu_torch/`` at the repo root,
named by a hash of the source and flags, so an edited source rebuilds
and an unchanged one is reused. Nothing builds at import: the first
kernel call (or :func:`build_all`) does it. :func:`build_all` starts one
``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "roadvision_tpu_torch"

BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# the "cv2" CLAHE blend needs every float multiply and add rounded on its
# own; the source uses __fmul_rn/__fadd_rn, and --fmad=false keeps any
# other expression from contracting as well; the auction's prices, and the
# boxes modes' x_to_bbox and IoU (csrc/box_iou.cuh: cx - 0.5 * w,
# cls * 7680 + x, area + area - inter), and the deformable sampling's
# locations, corner weights and sums (ctr + off * wh * 0.5, x * W - 0.5,
# acc + v * w) are bit-equal to the plain versions only without
# contraction too (its backward recomputes them the same way)
EXTRA_FLAGS: Dict[str, List[str]] = {"clahe": ["--fmad=false"],
                                     "median": [],
                                     "assoc": ["--fmad=false"],
                                     "nms": ["--fmad=false"],
                                     "deform": ["--fmad=false"]}

# kernel name -> launches since the last reset; each wrapper adds one
# where it launches its kernel, and nowhere else (a replayed CUDA graph
# adds the launches captured in it: runtime/graph.py)
launch_counts: Dict[str, int] = {"clahe_tile_luts": 0, "clahe_apply": 0,
                                 "median_k": 0, "assoc_greedy": 0,
                                 "assoc_auction": 0, "nms_keep": 0,
                                 "deform_sample": 0, "deform_sample_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points: (library, symbol) -> argtypes
SIGNATURES = {
    ("clahe", "rvt_clahe_tile_luts"): [_P, _P] + [_I] * 8 + [_F, _P],
    ("clahe", "rvt_clahe_apply"): [_P] * 10 + [_I] * 9 + [_P],
    ("median", "rvt_median_k"): [_P, _P, _I, _I, _I, _I, _P],
    ("assoc", "rvt_assoc_greedy"): [_P] * 4 + [_I] * 3 + [_F, _P],
    ("assoc", "rvt_assoc_greedy_boxes"): [_P] * 6 + [_I] * 3 + [_F, _P],
    ("assoc", "rvt_assoc_auction"): [_P] * 5 + [_I] * 3 + [_F, _F, _I, _P],
    ("assoc", "rvt_assoc_auction_boxes"): [_P] * 7 + [_I] * 3
    + [_F, _F, _I, _P],
    ("assoc", "rvt_auction_match"): [_P] * 4 + [_I] * 3 + [_F, _I, _P],
    ("assoc", "rvt_auction_workspace"): [_I] * 3,
    ("nms", "rvt_nms_keep"): [_P] * 4 + [_I] * 2 + [_P],
    ("nms", "rvt_nms_keep_boxes"): [_P] * 4 + [_I] * 2 + [_F, _P],
    ("deform", "rvt_deform_sample"): [_P] * 5 + [_I] * 15 + [_P],
    ("deform", "rvt_deform_sample_backward"): [_P] * 9 + [_I] * 14 + [_P],
}

# entry points that return something else than a CUDA error code
RESTYPES = {("assoc", "rvt_auction_workspace"): ctypes.c_longlong}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


NVCC_CANDIDATES = ("/usr/local/cuda/bin/nvcc",)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in NVCC_CANDIDATES:
        if Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "roadvision_tpu_torch build only where the CUDA "
                       "toolkit is installed")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(BASE_FLAGS + EXTRA_FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all started together. Returns name -> path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in EXTRA_FLAGS}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *BASE_FLAGS, *EXTRA_FLAGS[name],
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for (lname, sym), argtypes in SIGNATURES.items():
                if lname == name:
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = RESTYPES.get((lname, sym), ctypes.c_int)
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(t) -> int:
    """The current PyTorch CUDA stream of ``t``'s device, as an int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
