"""Host-side video capture — a copy of
``roadvision_tpu/io_video/capture.py``.

Decode stays on the host; the host feeds frame batches to the card. The
``cv2.VideoCapture`` path is kept (gated on cv2 being importable) beside
codec-free sources, so the package runs without OpenCV:

  * ``SyntheticRoadSource`` — deterministic procedural road scene with
    moving vehicles and ground-truth boxes;
  * ``NpyVideoSource`` — ``.npy``/``.npz`` frame stacks (T, H, W, 3) u8;
  * ``ImageDirSource`` — a directory of images decoded via PIL;
  * ``FFmpegPipeSource`` — any codec through an ffmpeg rawvideo pipe;
  * ``OpenCVSource`` — cameras / video files when cv2 is available;
  * ``.y4m`` and MJPEG ``.avi`` files through their own readers.

  * ``FoggedSyntheticRoadSource`` — the synthetic scene through the fog
    synthesizer (``synthetic_fog:<level>[:<num_vehicles>]``), synthesized
    on the ``device`` the source is given (the card by default).

``VideoSource`` keeps the reference's constructor signature and ``read() ->
Frame(ok, image, ts)`` contract, and adds ``read_batch(n)``, which returns
a contiguous (n, H, W, 3) block plus per-frame timestamps for one
host→device transfer downstream.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:  # optional; absent in this environment
    import cv2  # type: ignore
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


class Frame:
    __slots__ = ("ok", "image", "ts")

    def __init__(self, ok: bool, image: Optional[np.ndarray], ts: float):
        self.ok = ok
        self.image = image
        self.ts = ts


class _BaseSource:
    def read_frame(self) -> Tuple[bool, Optional[np.ndarray]]:
        raise NotImplementedError

    def release(self) -> None:
        pass


class SyntheticRoadSource(_BaseSource):
    """Procedural road scene: gradient sky/road, dashed lane lines, and
    ``num_vehicles`` rectangles moving toward the camera with perspective
    growth. Deterministic in the frame index; exposes ground-truth boxes.
    """

    _PALETTE = np.array([
        (48, 48, 200), (200, 48, 48), (48, 180, 48), (32, 160, 220),
        (160, 64, 160), (64, 200, 200), (220, 160, 32), (96, 96, 96),
    ], dtype=np.uint8)

    def __init__(self, width: int = 640, height: int = 480,
                 num_vehicles: int = 4, num_frames: Optional[int] = None,
                 noise: float = 0.0, seed: int = 0):
        self.w, self.h = int(width), int(height)
        self.n_veh = int(num_vehicles)
        self.num_frames = num_frames
        self.noise = float(noise)
        self.seed = int(seed)
        self.idx = 0
        self._bg = self._background()

    def _background(self) -> np.ndarray:
        h, w = self.h, self.w
        horizon = int(0.40 * h)
        img = np.zeros((h, w, 3), np.uint8)
        sky = np.linspace(200, 150, horizon)[:, None]
        img[:horizon] = np.stack([sky * 1.0, sky * 0.92, sky * 0.85],
                                 axis=-1).astype(np.uint8)
        road = np.linspace(60, 110, h - horizon)[:, None]
        img[horizon:] = np.stack([road, road, road], axis=-1).astype(np.uint8)
        # dashed center lane line
        for y in range(horizon, h, 24):
            half = max(1, (y - horizon) // 40 + 1)
            img[y:y + 12, w // 2 - half:w // 2 + half] = (230, 230, 230)
        return img

    def gt_boxes(self, idx: int) -> List[Tuple[float, float, float, float, int]]:
        """Ground-truth (x1, y1, x2, y2, vehicle_id) at frame ``idx``."""
        horizon = 0.40 * self.h
        out = []
        for v in range(self.n_veh):
            # progress ∈ [0,1): distance travelled toward the camera
            speed = 0.006 + 0.003 * ((v * 7 + self.seed) % 5)
            prog = ((idx * speed) + v / max(1, self.n_veh)) % 1.0
            yc = horizon + prog * (self.h - horizon) * 0.95
            scale = 0.25 + 0.75 * prog
            bw = 0.11 * self.w * scale
            bh = 0.09 * self.h * scale
            lane = -1 if v % 2 == 0 else 1
            xc = self.w / 2 + lane * (0.12 + 0.10 * prog) * self.w \
                + 0.02 * self.w * np.sin(idx * 0.05 + v)
            x1, y1 = xc - bw / 2, yc - bh
            x2, y2 = xc + bw / 2, yc
            if x2 <= 0 or x1 >= self.w or y2 <= horizon * 0.5:
                continue
            out.append((float(max(0, x1)), float(max(0, y1)),
                        float(min(self.w - 1, x2)), float(min(self.h - 1, y2)), v))
        return out

    def render(self, idx: int) -> np.ndarray:
        img = self._bg.copy()
        for x1, y1, x2, y2, v in self.gt_boxes(idx):
            xi1, yi1, xi2, yi2 = map(int, (x1, y1, x2, y2))
            color = self._PALETTE[v % len(self._PALETTE)]
            img[yi1:yi2, xi1:xi2] = color
            # windshield highlight to give texture
            wy = yi1 + max(1, (yi2 - yi1) // 5)
            img[yi1:wy, xi1 + (xi2 - xi1) // 6: xi2 - (xi2 - xi1) // 6] = (210, 220, 225)
        if self.noise > 0:
            rng = np.random.RandomState((self.seed * 7919 + idx) & 0x7FFFFFFF)
            noise = rng.randn(self.h, self.w, 3) * (self.noise * 255)
            img = np.clip(img.astype(np.int16) + noise.astype(np.int16),
                          0, 255).astype(np.uint8)
        return img

    def read_frame(self):
        if self.num_frames is not None and self.idx >= self.num_frames:
            return False, None
        img = self.render(self.idx)
        self.idx += 1
        return True, img


class FoggedSyntheticRoadSource(SyntheticRoadSource):
    """The synthetic road scene degraded by the reference's fog model
    (``camera.source: "synthetic_fog:<level>[:<num_vehicles>]"``, level
    light / medium / heavy). The fog is frozen in time: one seed,
    re-applied to every frame, with the reference tool's constructor
    overrides (global_veil 0.5; tools/fog_batch.py). Each frame is
    synthesized on ``device`` (the card unless "cpu" is asked for)."""

    def __init__(self, level: str = "medium", width: int = 640,
                 height: int = 480, num_vehicles: int = 4,
                 num_frames: Optional[int] = None, seed: int = 0,
                 device=None):
        super().__init__(width, height, num_vehicles=num_vehicles,
                         num_frames=num_frames, seed=seed)
        if level not in ("light", "medium", "heavy"):
            raise ValueError(f"unknown fog level {level!r} "
                             f"(light/medium/heavy)")
        from ..utils.device import resolve_device
        self.level = level
        self.device = resolve_device(device)

    def render(self, idx: int) -> np.ndarray:
        from ..augment.fog import CLI_OVERRIDES, EnhancedFogSynthesizer
        clean = super().render(idx)
        synth = EnhancedFogSynthesizer(level=self.level, seed=self.seed,
                                       device=self.device, **CLI_OVERRIDES)
        return synth.synthesize(clean)[0]


class NpyVideoSource(_BaseSource):
    def __init__(self, path: str):
        p = Path(path)
        if p.suffix == ".npz":
            data = np.load(p)
            self.frames = data[list(data.keys())[0]]
        else:
            self.frames = np.load(p, mmap_mode="r")
        if self.frames.ndim != 4 or self.frames.shape[-1] != 3:
            raise ValueError(f"expected (T,H,W,3) array in {path}, "
                             f"got {self.frames.shape}")
        self.idx = 0

    def read_frame(self):
        if self.idx >= len(self.frames):
            return False, None
        img = np.ascontiguousarray(self.frames[self.idx])
        self.idx += 1
        return True, img


class ImageDirSource(_BaseSource):
    _EXTS = {".jpg", ".jpeg", ".png", ".bmp"}

    def __init__(self, path: str):
        from PIL import Image  # noqa: F401 (validated import)
        self.files = sorted(p for p in Path(path).rglob("*")
                            if p.suffix.lower() in self._EXTS)
        self.idx = 0

    def read_frame(self):
        if self.idx >= len(self.files):
            return False, None
        path = self.files[self.idx]
        self.idx += 1
        if path.suffix.lower() in (".jpg", ".jpeg"):
            from .mjpeg_avi import decode_jpeg_bgr
            return True, decode_jpeg_bgr(path.read_bytes())
        from PIL import Image
        img = np.asarray(Image.open(path).convert("RGB"))
        return True, img[..., ::-1].copy()  # RGB → BGR, the pipeline contract


class FFmpegPipeSource(_BaseSource):
    """Any-codec file decode through an ffmpeg rawvideo pipe.

    Covers codec playback in OpenCV-less environments where an ffmpeg
    binary exists: ``ffmpeg -i <file> -f rawvideo -pix_fmt bgr24 -``
    streamed over stdout, consumed frame by frame. Frame geometry comes
    from ffprobe (falls back to the requested width/height). Selected by
    giving ``camera.source`` an ``ffmpeg:`` prefix, or automatically for
    codec files when cv2 is absent but ffmpeg is on PATH.
    """

    def __init__(self, path: str, width: int = 0, height: int = 0,
                 ffmpeg: str = "ffmpeg", ffprobe: str = "ffprobe"):
        import shutil
        import subprocess
        if shutil.which(ffmpeg) is None:
            raise RuntimeError(f"'{ffmpeg}' not on PATH; cannot decode "
                               f"{path} without OpenCV or ffmpeg")
        self.w, self.h = int(width), int(height)
        self.fps = None
        if shutil.which(ffprobe):
            try:
                out = subprocess.run(
                    [ffprobe, "-v", "error", "-select_streams", "v:0",
                     "-show_entries", "stream=width,height,r_frame_rate",
                     "-of", "csv=p=0", str(path)],
                    capture_output=True, text=True, timeout=30).stdout
                w, h, rate = out.strip().split("\n")[0].split(",")[:3]
                self.w, self.h = int(w), int(h)
                num, _, den = rate.partition("/")
                self.fps = float(num) / float(den or 1)
            except Exception:
                pass
        if not (self.w and self.h):
            raise ValueError(f"frame size for {path} unknown; pass "
                             f"camera.width/height or install ffprobe")
        self._frame_bytes = self.w * self.h * 3
        self.proc = subprocess.Popen(
            [ffmpeg, "-v", "error", "-i", str(path),
             "-f", "rawvideo", "-pix_fmt", "bgr24", "-"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)

    def read_frame(self):
        buf = self.proc.stdout.read(self._frame_bytes) \
            if self.proc.stdout else b""
        if len(buf) < self._frame_bytes:
            return False, None
        img = np.frombuffer(buf, np.uint8).reshape(self.h, self.w, 3)
        return True, img.copy()

    def release(self):
        if self.proc:
            if self.proc.stdout:
                self.proc.stdout.close()
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2.0)
            except Exception:
                self.proc.kill()
                self.proc.wait(timeout=2.0)  # reap — no zombie child


class OpenCVSource(_BaseSource):
    def __init__(self, source, width, height, fps_request):
        if not _HAS_CV2:
            raise RuntimeError("OpenCV not available for camera/codec decode; "
                               "use a synthetic/npy/image-dir source")
        self.cap = cv2.VideoCapture(source)
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        self.cap.set(cv2.CAP_PROP_FPS, fps_request)

    def read_frame(self):
        ok, img = self.cap.read()
        return ok, img

    def release(self):
        if self.cap:
            self.cap.release()


def _resolve(source, width, height, fps_request, num_frames=None,
             device=None) -> _BaseSource:
    if isinstance(source, str):
        low = source.lower()
        # exactly "synthetic" or "synthetic:<num_vehicles>" — a real asset
        # named e.g. "synthetic_fog.npy" must NOT be hijacked
        if low == "synthetic" or (low.startswith("synthetic:")
                                  and low.split(":", 1)[1].isdigit()):
            n = int(low.split(":", 1)[1]) if ":" in low else 4
            return SyntheticRoadSource(width, height, num_vehicles=n,
                                       num_frames=num_frames)
        if low.startswith("synthetic_fog:"):
            parts = low.split(":")  # synthetic_fog:<level>[:<vehicles>]
            n = int(parts[2]) if len(parts) > 2 and parts[2].isdigit() \
                else 4
            return FoggedSyntheticRoadSource(parts[1], width, height,
                                             num_vehicles=n,
                                             num_frames=num_frames,
                                             device=device)
        if low.startswith("ffmpeg:"):
            return FFmpegPipeSource(source.split(":", 1)[1], width, height)
        p = Path(source)
        if p.suffix in (".npy", ".npz"):
            return NpyVideoSource(source)
        if p.suffix == ".y4m":
            from .y4m import Y4MReader
            return Y4MReader(source)
        if p.suffix.lower() == ".avi" and p.is_file():
            # codec-free MJPEG playback (the recorder's own output);
            # non-MJPG AVIs fall through to cv2/ffmpeg below
            try:
                from .mjpeg_avi import MJPEGAviReader
                return MJPEGAviReader(source)
            except ValueError:
                pass
        if p.is_dir():
            return ImageDirSource(source)
        if not _HAS_CV2:
            import shutil
            if shutil.which("ffmpeg"):
                return FFmpegPipeSource(source, width, height)
    return OpenCVSource(source, width, height, fps_request)


class VideoSource:
    """Reference-compatible facade (src/io_video/capture.py:10-24).
    ``read_batch`` is the batched entry the engine's reader thread calls.

    Timestamp semantics: live cameras keep the reference's wall-clock
    stamp-at-read (capture.py:18-21). Paced media (files, image dirs, the
    synthetic source) get frame-paced PTS — ``t0 + index / fps`` — because
    the batched prefetch decodes in bursts and decode-time stamps would
    corrupt every dt-derived quantity downstream (Kalman F/Q, speed
    windows, the FPS meter). The reference never hits this because its
    loop is processing-paced; PTS is what its math assumed.

    ``device`` is where a source that computes its frames (the fogged
    synthetic scene) computes them; the others ignore it.
    """

    def __init__(self, source=0, width=1280, height=720, fps_request=30,
                 backend: str = "auto", num_frames: Optional[int] = None,
                 device=None):
        del backend  # reserved, as in the reference
        self._src = _resolve(source, width, height, fps_request, num_frames,
                             device)
        self._is_camera = isinstance(self._src, OpenCVSource) \
            and isinstance(source, int)
        # a file's own frame rate (e.g. the y4m header) wins over the request
        self._fps = max(1e-3, float(getattr(self._src, "fps", None)
                                    or fps_request or 30))
        self._t0 = time.time()
        self._idx = 0

    def read(self) -> Frame:
        ok, img = self._src.read_frame()
        if self._is_camera:
            ts = time.time()
        else:
            ts = self._t0 + self._idx / self._fps
        if ok:
            self._idx += 1
        return Frame(ok, img, ts)

    def read_batch(self, n: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Read up to ``n`` frames into one contiguous block.

        Returns (frames (m,H,W,3) u8, timestamps (m,) f64, m). m < n only at
        end of stream; m == 0 means the stream ended.
        """
        frames, stamps = [], []
        for _ in range(n):
            fr = self.read()
            if not fr.ok:
                break
            frames.append(fr.image)
            stamps.append(fr.ts)
        if not frames:
            return (np.zeros((0, 0, 0, 3), np.uint8),
                    np.zeros((0,), np.float64), 0)
        return np.stack(frames), np.asarray(stamps, np.float64), len(frames)

    def release(self) -> None:
        self._src.release()
