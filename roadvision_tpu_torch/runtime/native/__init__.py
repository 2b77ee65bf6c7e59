"""ctypes bindings for the native host ops — the port of
``roadvision_tpu/runtime/native/__init__.py``, with the same functions
and the same contract: ``RVT_NATIVE=0`` opts out, and ``get_lib`` /
``get_jpeg_lib`` / ``get_jdec_lib`` give ``None`` / ``False`` where the
toolchain (``g++``, ``-ljpeg``) is missing or the build fails, so the
callers keep their numpy / PIL paths.

The build differs from the JAX package's on purpose. Nothing builds at
import: the first call builds. Each library is compiled with ``g++`` into
``native/`` under the port's build directory (``kernels/_build.py``'s
``BUILD_DIR``, ``build/roadvision_tpu_torch/native/`` unless
:func:`roadvision_tpu_torch.utils.cache.enable_compilation_cache` moved
it), named by a hash of its source and flags, written under a name of
its own and ``os.replace``d into place: a process never loads a
half-written library, however many build at once. ``build_errors``
keeps why a library is unavailable.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

_HERE = Path(__file__).resolve().parent
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
# library -> (source, link flags)
SOURCES = {"hostops": ("host_ops.cpp", []),
           "jpegenc": ("jpeg_enc.cpp", ["-ljpeg"]),
           "jpegdec": ("jpeg_dec.cpp", ["-ljpeg"])}

# library -> loaded CDLL, or False once a build or load failed
_libs: Dict[str, Union[ctypes.CDLL, bool]] = {}
# library -> why it is unavailable
build_errors: Dict[str, str] = {}
_lock = threading.Lock()
_U8P = ctypes.POINTER(ctypes.c_uint8)


def build_dir() -> Path:
    from ...kernels import _build
    return Path(_build.BUILD_DIR) / "native"


def lib_path(name: str) -> Path:
    """Where library ``name`` is built: hashed on source and flags."""
    src, link = SOURCES[name]
    h = hashlib.sha256((_HERE / src).read_bytes())
    h.update(" ".join(CXX_FLAGS + link).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _compile(name: str) -> Optional[ctypes.CDLL]:
    if os.environ.get("RVT_NATIVE", "1") == "0":
        build_errors[name] = "RVT_NATIVE=0"
        return None
    out = lib_path(name)
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            build_errors[name] = "g++ not found"
            return None
        src, link = SOURCES[name]
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, str(_HERE / src), "-o", str(tmp), *link],
                capture_output=True, text=True, timeout=120)
        except subprocess.TimeoutExpired:
            build_errors[name] = "g++ timed out"
            return None
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            lines = (proc.stderr or proc.stdout).strip().splitlines()
            build_errors[name] = "g++ failed: " + \
                (lines[0] if lines else f"rc {proc.returncode}")
            return None
        os.replace(tmp, out)
    try:
        return ctypes.CDLL(str(out))
    except OSError as e:
        build_errors[name] = f"load failed: {e}"
        return None


def _get(name: str, declare) -> Union[ctypes.CDLL, bool]:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _compile(name)
            if lib is not None:
                declare(lib)
            _libs[name] = lib if lib is not None else False
            lib = _libs[name]
        return lib


def _declare_hostops(lib: ctypes.CDLL) -> None:
    i, u8 = ctypes.c_int, ctypes.c_uint8
    lib.rvt_fill_rect.argtypes = [_U8P] + [i] * 6 + [u8] * 3
    lib.rvt_draw_rect.argtypes = [_U8P] + [i] * 7 + [u8] * 3
    lib.rvt_blit_mask.argtypes = [_U8P, i, i, _U8P, i, i, i, i] + [u8] * 3
    lib.rvt_canvas_h.argtypes = [_U8P, _U8P, _U8P] + [i] * 3
    lib.rvt_canvas_v.argtypes = [_U8P, _U8P, _U8P] + [i] * 3
    for fn in (lib.rvt_fill_rect, lib.rvt_draw_rect, lib.rvt_blit_mask,
               lib.rvt_canvas_h, lib.rvt_canvas_v):
        fn.restype = None


def _declare_jpegenc(lib: ctypes.CDLL) -> None:
    lib.rvt_jpeg_encode_bgr.restype = ctypes.c_long
    lib.rvt_jpeg_encode_bgr.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(_U8P)]
    lib.rvt_jpeg_free.argtypes = [_U8P]
    lib.rvt_jpeg_free.restype = None


def _declare_jpegdec(lib: ctypes.CDLL) -> None:
    lib.rvt_jpeg_decode_bgr.restype = ctypes.c_long
    lib.rvt_jpeg_decode_bgr.argtypes = [
        _U8P, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(_U8P)]
    lib.rvt_jpeg_free_dec.argtypes = [_U8P]
    lib.rvt_jpeg_free_dec.restype = None


def get_lib() -> Optional[ctypes.CDLL]:
    """The overlay / canvas library; None where it cannot be built."""
    return _get("hostops", _declare_hostops) or None


def available() -> bool:
    return get_lib() is not None


def get_jpeg_lib():
    """The libjpeg encode tail; False where ``-ljpeg`` is unavailable."""
    return _get("jpegenc", _declare_jpegenc)


def get_jdec_lib():
    """The libjpeg decode path; False where ``-ljpeg`` is unavailable."""
    return _get("jpegdec", _declare_jpegdec)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _check_bgr(img: np.ndarray, what: str) -> None:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 \
            or not img.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{what}: needs a C-contiguous (h, w, 3) uint8 "
                         f"image, got {img.dtype} {img.shape}")


def _need_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native host ops unavailable: "
                           + build_errors.get("hostops", "unknown"))
    return lib


def jpeg_encode_bgr(frame: np.ndarray, quality: int = 90,
                    fast_dct: bool = True) -> Optional[bytes]:
    """JPEG-encode an (h, w, 3) uint8 BGR frame; None if unavailable."""
    lib = get_jpeg_lib()
    if not lib:
        return None
    arr = np.ascontiguousarray(frame)
    _check_bgr(arr, "jpeg_encode_bgr")
    h, w = arr.shape[:2]
    out = _U8P()
    n = lib.rvt_jpeg_encode_bgr(_ptr(arr), h, w, arr.strides[0],
                                int(quality), int(bool(fast_dct)),
                                ctypes.byref(out))
    if n < 0:
        return None
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.rvt_jpeg_free(out)


def jpeg_decode_bgr(data: bytes) -> Optional[np.ndarray]:
    """Decode a JPEG byte stream to (h, w, 3) uint8 BGR; None when the
    native path is unavailable or the stream does not decode."""
    lib = get_jdec_lib()
    if not lib:
        return None
    src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    h = ctypes.c_int()
    w = ctypes.c_int()
    out = _U8P()
    n = lib.rvt_jpeg_decode_bgr(src, len(data), ctypes.byref(h),
                                ctypes.byref(w), ctypes.byref(out))
    if n < 0:
        return None
    try:
        view = np.ctypeslib.as_array(out, shape=(h.value, w.value, 3))
        return view.copy()  # own the memory before freeing the C buffer
    finally:
        lib.rvt_jpeg_free_dec(out)


def fill_rect(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color):
    lib = _need_lib()
    _check_bgr(img, "fill_rect")
    h, w = img.shape[:2]
    b, g, r = (int(c) & 0xFF for c in color)
    lib.rvt_fill_rect(_ptr(img), h, w, int(x1), int(y1), int(x2), int(y2),
                      b, g, r)


def draw_rect(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
              color, thickness: int = 2):
    lib = _need_lib()
    _check_bgr(img, "draw_rect")
    h, w = img.shape[:2]
    b, g, r = (int(c) & 0xFF for c in color)
    lib.rvt_draw_rect(_ptr(img), h, w, int(x1), int(y1), int(x2), int(y2),
                      int(thickness), b, g, r)


def blit_mask(img: np.ndarray, mask: np.ndarray, x: int, y: int, color):
    lib = _need_lib()
    _check_bgr(img, "blit_mask")
    h, w = img.shape[:2]
    m = np.ascontiguousarray(mask.astype(np.uint8))
    if m.ndim != 2:
        raise ValueError(f"blit_mask: needs a 2-D mask, got {m.shape}")
    b, g, r = (int(c) & 0xFF for c in color)
    lib.rvt_blit_mask(_ptr(img), h, w, _ptr(m), m.shape[0], m.shape[1],
                      int(x), int(y), b, g, r)


def canvas(raw: np.ndarray, proc: np.ndarray, layout: str = "h",
           divider: int = 4) -> np.ndarray:
    """The RAW / PROC compare canvas, side by side ("h") or stacked
    ("v"), with a ``divider``-pixel band of (40, 40, 40) between."""
    lib = _need_lib()
    raw = np.ascontiguousarray(raw)
    proc = np.ascontiguousarray(proc)
    _check_bgr(raw, "canvas")
    if proc.shape != raw.shape or proc.dtype != raw.dtype:
        raise ValueError(f"canvas: raw {raw.shape} and proc {proc.shape} "
                         "differ")
    h, w = raw.shape[:2]
    if layout == "v":
        out = np.empty((2 * h + divider, w, 3), np.uint8)
        lib.rvt_canvas_v(_ptr(raw), _ptr(proc), _ptr(out), h, w, divider)
    else:
        out = np.empty((h, 2 * w + divider, 3), np.uint8)
        lib.rvt_canvas_h(_ptr(raw), _ptr(proc), _ptr(out), h, w, divider)
    return out
