"""Codec-free video recording — a copy of
``roadvision_tpu/io_video/writer.py`` with the PIL JPEG encode only (the
JAX package asks its C++ libjpeg-turbo helper first).

The reference's recorder is dead code (record.enable is read but no
cv2.VideoWriter is ever constructed — main_preview.py:81,130,137; SURVEY.md
§5 puts "actually implement the recorder" in scope). This writer works with
zero native codec dependencies:

  * ``.avi``  — Motion-JPEG in a standard RIFF AVI container, frames
    JPEG-encoded with PIL. Plays in VLC/ffplay/browsers.
  * ``.npy``  — raw (T, H, W, 3) uint8 stack (exact, for parity tooling).
  * ``.mp4``  — routed to cv2.VideoWriter when OpenCV is available,
    otherwise transparently falls back to MJPEG-AVI alongside the requested
    path (so the reference's default ``out_compare.mp4`` config still
    records something useful instead of silently dropping frames).

API mirrors cv2.VideoWriter: ``write(frame_bgr)``, ``release()``.
"""
from __future__ import annotations

import io
import os
import struct
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

try:
    import cv2  # type: ignore
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def encode_jpeg_bgr(frame_bgr: np.ndarray, quality: int = 90) -> bytes:
    """JPEG-encode a (H, W, 3) uint8 BGR frame without a channel-flip
    copy: PIL's raw "BGR" unpacker reads the rows as they are."""
    from PIL import Image

    h, w = frame_bgr.shape[:2]
    buf = np.ascontiguousarray(frame_bgr)
    img = Image.frombuffer("RGB", (w, h), buf, "raw", "BGR", 0, 1)
    out = io.BytesIO()
    img.save(out, format="JPEG", quality=quality)
    return out.getvalue()


def _fourcc(s: str) -> bytes:
    return s.encode("ascii")


def _chunk(tag: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) % 2 else b""
    return tag + struct.pack("<I", len(payload)) + payload + pad


def _lst(kind: bytes, payload: bytes) -> bytes:
    body = kind + payload
    pad = b"\0" if len(body) % 2 else b""
    return b"LIST" + struct.pack("<I", len(body)) + body + pad


class MJPEGAVIWriter:
    """Minimal single-stream MJPG AVI muxer (RIFF: hdrl, movi, idx1).

    Streams frame chunks straight to disk as they arrive (constant memory,
    only per-frame index entries are buffered) and back-patches the
    RIFF/movi sizes and headers at release() — long recordings neither
    balloon RAM nor vanish wholesale on a crash (the movi data up to the
    last flush is on disk).

    JPEG encoding goes through :func:`encode_jpeg_bgr` (raw-BGR unpack,
    no channel-flip copy) and, when >2 cores exist, is pipelined over a small
    thread pool (PIL's encoder releases the GIL in C): frames are
    snapshotted at ``write`` and the encoded chunks are muxed strictly
    in submission order, so the caller overlaps the next frame's overlay
    work with this frame's encode. ``workers=0`` forces the synchronous
    path (the auto default on 1-2 cores, where threading only adds
    overhead)."""

    _HDRL_SIZE = None  # computed lazily; header area is fixed-size

    def __init__(self, path: str, fps: float = 30.0, quality: int = 90,
                 workers: Optional[int] = None):
        self.path = Path(path)
        self.fps = max(1.0, float(fps))
        self.quality = int(quality)
        self._fh = None
        self._size = None           # (w, h)
        self._index: List[Tuple[int, int]] = []  # (offset-in-movi, length)
        self._movi_bytes = 4        # 'movi' fourcc
        self._max_chunk = 0
        if workers is None:
            # threading pays only when cores exist to encode behind the
            # caller; on 1-2 cores the snapshot+contention overhead loses
            ncpu = os.cpu_count() or 1
            workers = 0 if ncpu <= 2 else min(4, ncpu - 1)
        self._pool = ThreadPoolExecutor(workers) if workers > 0 else None
        self._pending: "deque[Future]" = deque()
        self._depth = 2 * max(workers, 1)

    def _headers(self, w: int, h: int, n: int, max_size: int) -> bytes:
        avih = struct.pack(
            "<14I",
            int(1e6 / self.fps), int(max(1, max_size) * self.fps), 0,
            0x10,                          # AVIF_HASINDEX
            n, 0, 1, max(1, max_size), w, h, 0, 0, 0, 0)
        strh = _fourcc("vids") + _fourcc("MJPG") + struct.pack(
            "<IHHIIIIIIiI4H",
            0, 0, 0, 0, 1, int(self.fps), 0, n, max(1, max_size), -1, 0,
            0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)
        return _lst(b"hdrl", _chunk(b"avih", avih)
                    + _lst(b"strl", _chunk(b"strh", strh)
                           + _chunk(b"strf", strf)))

    def _open(self, w: int, h: int) -> None:
        self._fh = open(self.path, "wb")
        hdrl = self._headers(w, h, 0, 0)
        self._hdrl_len = len(hdrl)
        self._fh.write(b"RIFF" + struct.pack("<I", 0) + b"AVI " + hdrl)
        self._movi_start = self._fh.tell()
        self._fh.write(b"LIST" + struct.pack("<I", 4) + b"movi")

    def _mux(self, data: bytes) -> None:
        self._index.append((self._movi_bytes, len(data)))
        chunk = _chunk(b"00dc", data)
        self._fh.write(chunk)
        self._movi_bytes += len(chunk)
        self._max_chunk = max(self._max_chunk, len(data))

    def _drain(self, block_all: bool = False) -> None:
        """Mux completed encodes in submission order; bound the queue."""
        while self._pending and (
                block_all or self._pending[0].done()
                or len(self._pending) >= self._depth):
            self._mux(self._pending.popleft().result())

    def write(self, frame_bgr: np.ndarray) -> None:
        h, w = frame_bgr.shape[:2]
        if self._size is None:
            self._size = (w, h)
            self._open(w, h)
        elif self._size != (w, h):
            raise ValueError("frame size changed mid-stream")
        if self._pool is None:
            self._mux(encode_jpeg_bgr(frame_bgr, self.quality))
            return
        # snapshot: the caller is free to reuse/mutate the buffer after
        # write() returns while the encode runs behind it
        snap = np.array(frame_bgr, dtype=np.uint8, order="C")
        self._pending.append(
            self._pool.submit(encode_jpeg_bgr, snap, self.quality))
        self._drain()

    def release(self) -> None:
        if self._fh is None:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            return
        self._drain(block_all=True)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        w, h = self._size
        n = len(self._index)
        idx1 = _chunk(b"idx1", b"".join(
            struct.pack("<4sIII", b"00dc", 0x10, off, length)
            for off, length in self._index))
        self._fh.write(idx1)
        riff_size = self._fh.tell() - 8
        # back-patch: RIFF size, headers (frame count etc.), movi size
        self._fh.seek(4)
        self._fh.write(struct.pack("<I", riff_size))
        self._fh.seek(12)
        self._fh.write(self._headers(w, h, n, self._max_chunk))
        self._fh.seek(self._movi_start + 4)
        self._fh.write(struct.pack("<I", self._movi_bytes))
        self._fh.close()
        self._fh = None
        self._index = []


class NpyWriter:
    def __init__(self, path: str, fps: float = 30.0):
        self.path = Path(path)
        self.frames: List[np.ndarray] = []

    def write(self, frame_bgr: np.ndarray) -> None:
        self.frames.append(np.asarray(frame_bgr, np.uint8))

    def release(self) -> None:
        if self.frames:
            np.save(self.path, np.stack(self.frames))
            self.frames = []


class _CV2Writer:
    def __init__(self, path: str, fps: float, size_hint=None):
        self.path = str(path)
        self.fps = fps
        self.writer = None

    def write(self, frame_bgr: np.ndarray) -> None:
        if self.writer is None:
            h, w = frame_bgr.shape[:2]
            four = cv2.VideoWriter_fourcc(*"mp4v")
            self.writer = cv2.VideoWriter(self.path, four, self.fps, (w, h))
        self.writer.write(frame_bgr)

    def release(self) -> None:
        if self.writer is not None:
            self.writer.release()


class EventGatedWriter:
    """Record only around activity: a pre-roll ring buffer + post-roll
    hold wrapped around any writer above.

    Beyond-reference deployment feature (the reference's recorder is
    dead code, main_preview.py:130-137; a road camera recording 24/7
    mostly stores empty asphalt). ``write(frame, triggered)`` buffers
    quiet frames in a ``pre_roll``-deep ring; on a trigger (detections
    present, an analytics event — the caller decides) it flushes the
    ring, writes through, and keeps writing for ``post_roll`` further
    frames after the LAST trigger, so one event yields one contiguous
    clip with context on both sides.
    """

    def __init__(self, writer, pre_roll: int = 30, post_roll: int = 60):
        from collections import deque

        self._w = writer
        self._ring = deque(maxlen=max(0, int(pre_roll))) \
            if int(pre_roll) > 0 else None
        self._post = max(0, int(post_roll))
        self._open = 0                 # post-roll frames still to write
        self.frames_seen = 0
        self.frames_written = 0
        self.segments = 0

    def write(self, frame) -> None:    # plain-writer compatibility
        self.write_gated(frame, True)

    def write_gated(self, frame, triggered: bool) -> None:
        self.frames_seen += 1
        if triggered:
            if self._open == 0:
                self.segments += 1
            if self._ring:
                for f in self._ring:
                    self._w.write(f)
                    self.frames_written += 1
                self._ring.clear()
            self._w.write(frame)
            self.frames_written += 1
            self._open = self._post
        elif self._open > 0:
            self._w.write(frame)
            self.frames_written += 1
            self._open -= 1
        elif self._ring is not None:
            self._ring.append(frame)

    def release(self) -> None:
        self._w.release()

    def summary(self) -> dict:
        return {"frames_seen": self.frames_seen,
                "frames_written": self.frames_written,
                "segments": self.segments}


def make_writer(path: str, fps: float = 30.0, quality: int = 90):
    """Pick a writer by extension (with graceful mp4 fallback).

    ``quality`` is the MJPEG JPEG quality (preview.record.quality); it is
    ignored by the exact (.npy/.y4m) and cv2 writers."""
    suffix = Path(path).suffix.lower()
    if suffix == ".npy":
        return NpyWriter(path, fps)
    if suffix == ".avi":
        return MJPEGAVIWriter(path, fps, quality=quality)
    if suffix == ".y4m":
        from .y4m import Y4MWriter
        return Y4MWriter(path, fps)
    if suffix == ".mp4":
        if _HAS_CV2:
            return _CV2Writer(path, fps)
        fallback = str(Path(path).with_suffix(".avi"))
        print(f"[roadvision] no mp4 codec available; recording MJPEG to {fallback}")
        return MJPEGAVIWriter(fallback, fps, quality=quality)
    raise ValueError(f"unsupported recording format: {suffix}")
