"""YUV4MPEG2 (.y4m) reader/writer — codec-free standard video interchange
(a copy of ``roadvision_tpu/io_video/y4m.py``).

Complements the MJPEG-AVI recorder: .y4m is the canonical uncompressed
video container (ffplay/mpv/ffmpeg all read it), so clips move between
this framework and standard tooling without any codec dependency.

Supported: C444 and C420jpeg/C420 chroma (the common defaults). Color math
uses BT.601 limited range (the y4m convention): Y ∈ [16,235],
C ∈ [16,240].
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np


def _bgr_to_yuv_limited(bgr: np.ndarray):
    b = bgr[..., 0].astype(np.float32)
    g = bgr[..., 1].astype(np.float32)
    r = bgr[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = (b - y) * 0.564
    v = (r - y) * 0.713
    yq = np.clip(np.rint(y * (219.0 / 255.0) + 16.0), 16, 235).astype(np.uint8)
    uq = np.clip(np.rint(u * (224.0 / 255.0) + 128.0), 16, 240).astype(np.uint8)
    vq = np.clip(np.rint(v * (224.0 / 255.0) + 128.0), 16, 240).astype(np.uint8)
    return yq, uq, vq


def _yuv_limited_to_bgr(yq: np.ndarray, uq: np.ndarray, vq: np.ndarray):
    y = (yq.astype(np.float32) - 16.0) * (255.0 / 219.0)
    u = (uq.astype(np.float32) - 128.0) * (255.0 / 224.0)
    v = (vq.astype(np.float32) - 128.0) * (255.0 / 224.0)
    r = y + v / 0.713
    b = y + u / 0.564
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    out = np.stack([b, g, r], axis=-1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class Y4MWriter:
    """cv2.VideoWriter-style API writing YUV4MPEG2 C444."""

    def __init__(self, path: str, fps: float = 30.0):
        self.path = Path(path)
        self.fps = max(1, int(round(fps)))
        self._fh = None
        self._size: Optional[Tuple[int, int]] = None

    def write(self, frame_bgr: np.ndarray) -> None:
        h, w = frame_bgr.shape[:2]
        if self._fh is None:
            self._size = (w, h)
            self._fh = open(self.path, "wb")
            self._fh.write(
                f"YUV4MPEG2 W{w} H{h} F{self.fps}:1 Ip A1:1 C444\n"
                .encode("ascii"))
        elif self._size != (w, h):
            raise ValueError("frame size changed mid-stream")
        y, u, v = _bgr_to_yuv_limited(frame_bgr)
        self._fh.write(b"FRAME\n")
        self._fh.write(y.tobytes())
        self._fh.write(u.tobytes())
        self._fh.write(v.tobytes())

    def release(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class Y4MReader:
    """Iterate BGR frames from a .y4m file (C444 / C420-family)."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        header = self._fh.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"not a y4m file: {path}")
        self.width = self.height = None
        self.fps = 30.0
        self.chroma = "420jpeg"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "F":
                num, den = tok[1:].split(":")
                self.fps = float(num) / float(den)
            elif tok[0] == "C":
                self.chroma = tok[1:]
        if not self.width or not self.height:
            raise ValueError("y4m header missing W/H")
        if not (self.chroma.startswith("420") or self.chroma == "444"):
            raise ValueError(f"unsupported chroma: {self.chroma}")

    def read_frame(self) -> Tuple[bool, Optional[np.ndarray]]:
        line = self._fh.readline()
        if not line:
            return False, None
        if not line.startswith(b"FRAME"):
            raise ValueError("corrupt y4m stream (missing FRAME marker)")
        w, h = self.width, self.height
        ysize = w * h
        if self.chroma == "444":
            csize = ysize
            cw, ch = w, h
        else:
            cw, ch = w // 2, h // 2
            csize = cw * ch
        buf = self._fh.read(ysize + 2 * csize)
        if len(buf) < ysize + 2 * csize:
            return False, None
        y = np.frombuffer(buf, np.uint8, ysize).reshape(h, w)
        u = np.frombuffer(buf, np.uint8, csize, ysize).reshape(ch, cw)
        v = np.frombuffer(buf, np.uint8, csize, ysize + csize).reshape(ch, cw)
        if self.chroma != "444":
            u = u.repeat(2, axis=0).repeat(2, axis=1)[:h, :w]
            v = v.repeat(2, axis=0).repeat(2, axis=1)[:h, :w]
        return True, _yuv_limited_to_bgr(y, u, v)

    def release(self) -> None:
        self._fh.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ok, frame = self.read_frame()
            if not ok:
                return
            yield frame
