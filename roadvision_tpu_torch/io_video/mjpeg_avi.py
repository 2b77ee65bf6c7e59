"""MJPEG-AVI playback without codecs (the reader half of writer.py) — a
copy of ``roadvision_tpu/io_video/mjpeg_avi.py`` with the PIL decode
only (the JAX package asks its C++ libjpeg-turbo helper first).

The reference plays video through ``cv2.VideoCapture``'s native codecs
(src/io_video/capture.py:13). This build's recorder (io_video/writer.py)
emits Motion-JPEG in a RIFF AVI container; this module closes the
record→replay loop self-contained: a pure-Python RIFF demuxer walks the
container and each frame is decoded by PIL, so recordings play back
with zero cv2/ffmpeg dependency.

Container handling:
  * prefers the ``idx1`` index when present (both offset conventions —
    relative to the 'movi' fourcc and absolute-in-file — are detected);
  * falls back to a sequential chunk walk of the ``movi`` list when the
    index is missing or truncated (e.g. a recording cut off mid-run:
    the writer streams frames to disk and back-patches at release, so a
    crashed run still has playable movi data — SURVEY.md §5 failure
    semantics);
  * only ``00dc``/``00db`` video chunks are consumed; other streams
    (audio, text) are skipped.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


def decode_jpeg_bgr(data: bytes) -> np.ndarray:
    """JPEG bytes → (h, w, 3) uint8 BGR, decoded by PIL."""
    import io as _io

    from PIL import Image

    rgb = np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))
    return rgb[..., ::-1].copy()


class MJPEGAviReader:
    """Frame-accurate reader for MJPG AVI files (one video stream).

    Exposes ``fps`` (from the avih header) and ``__len__``; ``read_frame``
    matches the ``_BaseSource`` contract in capture.py so ``VideoSource``
    can front it.
    """

    def __init__(self, path: str):
        import mmap

        self.path = Path(path)
        self._fh = open(self.path, "rb")
        try:
            # mmap: long recordings stream from the page cache instead of
            # loading wholesale into RAM
            self._data = mmap.mmap(self._fh.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            self._fh.close()
            raise ValueError(f"{path}: not a RIFF AVI file")
        if len(self._data) < 12 or self._data[:4] != b"RIFF" \
                or self._data[8:12] != b"AVI ":
            self.release()
            raise ValueError(f"{path}: not a RIFF AVI file")
        self.fps: Optional[float] = None
        self._movi_start: Optional[int] = None  # offset of the 'movi' tag
        self._idx1_at: Optional[int] = None     # offset of the idx1 chunk
        self._frames: List[Tuple[int, int]] = []  # (payload off, length)
        try:
            self._parse()
        except ValueError:
            self.release()
            raise
        if not self._frames:
            self.release()
            raise ValueError(f"{path}: no MJPEG video frames found")
        self.idx = 0

    # -- container parsing -------------------------------------------------

    def _walk(self, start: int, end: int) -> None:
        """Walk sibling chunks in [start, end); record avih + movi."""
        d = self._data
        pos = start
        while pos + 8 <= end:
            tag = d[pos:pos + 4]
            (size,) = struct.unpack_from("<I", d, pos + 4)
            body, nxt = pos + 8, pos + 8 + size + (size & 1)
            if tag == b"LIST" and size >= 4:
                kind = d[body:body + 4]
                if kind == b"movi":
                    self._movi_start = body
                elif kind in (b"hdrl", b"strl"):
                    self._walk(body + 4, min(body + size, end))
            elif tag == b"avih" and size >= 4:
                (us_per_frame,) = struct.unpack_from("<I", d, body)
                if us_per_frame > 0:
                    self.fps = 1e6 / us_per_frame
            elif tag == b"idx1":
                # found structurally (a top-level sibling chunk) — a byte
                # search could false-positive inside JPEG payloads
                self._idx1_at = pos
            pos = nxt

    def _parse(self) -> None:
        d = self._data
        self._walk(12, len(d))
        if self._movi_start is None:
            raise ValueError(f"{self.path}: no movi list")
        if self._idx1_at is not None and self._load_index(self._idx1_at):
            return
        self._sequential_walk()

    def _load_index(self, at: int) -> bool:
        """Parse idx1; returns False when unusable (then walk movi)."""
        d = self._data
        if at + 8 > len(d):
            return False
        (size,) = struct.unpack_from("<I", d, at + 4)
        body = at + 8
        n = min(size, len(d) - body) // 16
        if n == 0:
            return False
        # offset convention probe: entries point either relative to the
        # 'movi' fourcc (the spec's common reading — our writer's choice)
        # or absolute in the file (some muxers). Check where the first
        # video entry's chunk tag actually lands.
        first = None
        for i in range(n):
            ckid = d[body + 16 * i: body + 16 * i + 4]
            if ckid[2:4] in (b"dc", b"db"):
                first = struct.unpack_from("<II", d, body + 16 * i + 8)
                break
        if first is None:
            return False
        off0 = first[0]
        rel = self._movi_start
        if d[rel + off0: rel + off0 + 2] == b"00":
            base = rel
        elif d[off0: off0 + 2] == b"00":
            base = 0
        else:
            return False
        frames: List[Tuple[int, int]] = []
        for i in range(n):
            e = body + 16 * i
            ckid = d[e:e + 4]
            if ckid[2:4] not in (b"dc", b"db"):
                continue  # non-video stream entry
            off, length = struct.unpack_from("<II", d, e + 8)
            payload = base + off + 8  # skip the chunk's own tag+size
            if payload + length <= len(d):
                frames.append((payload, length))
        if not frames:
            return False
        self._frames = frames
        return True

    def _sequential_walk(self) -> None:
        """No (usable) index: walk movi chunk by chunk. Tolerates a
        truncated tail (crash mid-recording) by stopping at the first
        chunk that runs past EOF."""
        d = self._data
        pos = self._movi_start + 4
        end = len(d)
        frames: List[Tuple[int, int]] = []
        while pos + 8 <= end:
            tag = d[pos:pos + 4]
            (size,) = struct.unpack_from("<I", d, pos + 4)
            body = pos + 8
            if body + size > end:
                break  # truncated tail
            if tag == b"idx1":
                break  # movi ended (unpatched movi size)
            if tag[2:4] in (b"dc", b"db"):
                frames.append((body, size))
            elif tag == b"LIST":  # 'rec ' grouping: descend
                pos = body + 4
                continue
            pos = body + size + (size & 1)
        self._frames = frames

    # -- source contract ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._frames)

    def read_frame(self):
        if self.idx >= len(self._frames):
            return False, None
        off, length = self._frames[self.idx]
        self.idx += 1
        return True, decode_jpeg_bgr(self._data[off:off + length])

    def release(self) -> None:
        self._frames = []
        if getattr(self, "_data", None) is not None \
                and not isinstance(self._data, bytes):
            try:
                self._data.close()
            except Exception:
                pass
        self._data = b""
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None
