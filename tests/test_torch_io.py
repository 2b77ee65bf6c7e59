"""roadvision_tpu_torch.io_video vs roadvision_tpu.io_video (CPU).

Frames come from seeded numpy. Exact containers (.npy, .y4m) written by
one package are read by the other and must come back bit for bit (.npy)
or equal to what the writing package's own reader gives (.y4m, whose
colour conversion is lossy by design). MJPEG AVI files are compared by
RIFF structure and by decoded frames, never by file bytes: the JAX
package encodes through its C++ libjpeg helper where that is built, the
port through PIL alone. The sources, the recorders' policies and the
device-side renderer are held to the JAX package's on the same inputs.
"""
import os
import stat
import struct

import numpy as np
import pytest
import torch

from roadvision_tpu.io_video import capture as jcap
from roadvision_tpu.io_video import fps_meter as jfps
from roadvision_tpu.io_video import mjpeg_avi as javi
from roadvision_tpu.io_video import synthetic_device as jdev
from roadvision_tpu.io_video import writer as jwr
from roadvision_tpu.io_video import y4m as jy4m
from roadvision_tpu_torch import io_video as tio
from roadvision_tpu_torch.io_video import capture as tcap
from roadvision_tpu_torch.io_video import mjpeg_avi as tavi
from roadvision_tpu_torch.io_video import writer as twr
from roadvision_tpu_torch.io_video import y4m as ty4m

H, W, N = 48, 64, 7


def _frames(seed=0, n=N, h=H, w=W):
    """Smooth content with texture: JPEG-friendly, every frame different."""
    rng = np.random.RandomState(seed)
    base = (np.linspace(0, 200, w)[None, None, :, None]
            + np.linspace(0, 55, h)[None, :, None, None]
            + 12 * np.arange(n)[:, None, None, None])
    return np.clip(base + rng.normal(0, 6, (n, h, w, 3)), 0,
                   255).astype(np.uint8)


def _read_all(src):
    out = []
    while True:
        ok, img = src.read_frame()
        if not ok:
            break
        out.append(np.array(img))
    src.release()
    return np.stack(out)


def _write(writer, frames):
    for f in frames:
        writer.write(f)
    writer.release()


@pytest.mark.parametrize("writer_pkg", ["jax", "torch"])
def test_npy_written_by_one_read_by_the_other(tmp_path, writer_pkg):
    frames = _frames(1)
    path = str(tmp_path / "clip.npy")
    wmod, rmod = (jwr, tcap) if writer_pkg == "jax" else (twr, jcap)
    _write(wmod.make_writer(path), frames)
    np.testing.assert_array_equal(_read_all(rmod.NpyVideoSource(path)),
                                  frames)
    np.savez(tmp_path / "clip.npz", frames=frames)
    np.testing.assert_array_equal(
        _read_all(tcap.NpyVideoSource(str(tmp_path / "clip.npz"))), frames)
    np.save(tmp_path / "bad.npy", frames[..., 0])
    with pytest.raises(ValueError, match=r"expected \(T,H,W,3\)"):
        tcap.NpyVideoSource(str(tmp_path / "bad.npy"))


@pytest.mark.parametrize("writer_pkg", ["jax", "torch"])
def test_y4m_written_by_one_read_by_the_other(tmp_path, writer_pkg):
    frames = _frames(2)
    jpath, tpath = str(tmp_path / "j.y4m"), str(tmp_path / "t.y4m")
    _write(jwr.make_writer(jpath, fps=25), frames)
    _write(twr.make_writer(tpath, fps=25), frames)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()          # an exact container
    path = jpath if writer_pkg == "jax" else tpath
    own = _read_all(jy4m.Y4MReader(path))
    other_reader = ty4m.Y4MReader(path)
    assert other_reader.fps == jy4m.Y4MReader(path).fps == 25.0
    np.testing.assert_array_equal(_read_all(other_reader), own)
    assert np.abs(own.astype(int) - frames.astype(int)).max() <= 3


def _riff_layout(path):
    """(top-level chunk tags, avih fields, strh fourccs, movi chunk tags,
    idx1 entries) of an AVI file."""
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack_from("<I", data, 4)[0] == len(data) - 8
    top, pos, movi, idx, avih, strh = [], 12, [], [], None, None
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = pos + 8
        kind = data[body:body + 4] if tag == b"LIST" else b""
        top.append((tag, kind))
        if kind == b"hdrl":
            at = data.index(b"avih", body)
            avih = struct.unpack_from("<14I", data, at + 8)
            at = data.index(b"strh", body)
            strh = (data[at + 8:at + 12], data[at + 12:at + 16])
        elif kind == b"movi":
            p = body + 4
            while p + 8 <= body + size:
                n = struct.unpack_from("<I", data, p + 4)[0]
                movi.append((data[p:p + 4], data[p + 8:p + 11]))
                p += 8 + n + (n & 1)
        elif tag == b"idx1":
            idx = [struct.unpack_from("<4sIII", data, body + 16 * i)
                   for i in range(size // 16)]
        pos = body + size + (size & 1)
    return top, avih, strh, movi, idx


@pytest.mark.parametrize("workers", [0, 3])
def test_mjpeg_avi_structure_and_decoded_frames(tmp_path, workers):
    frames = _frames(3)
    jpath, tpath = str(tmp_path / "j.avi"), str(tmp_path / "t.avi")
    _write(jwr.MJPEGAVIWriter(jpath, fps=25, quality=90, workers=workers),
           frames)
    _write(twr.MJPEGAVIWriter(tpath, fps=25, quality=90, workers=workers),
           frames)
    jl, tl = _riff_layout(jpath), _riff_layout(tpath)
    assert tl[0] == jl[0] == [(b"LIST", b"hdrl"), (b"LIST", b"movi"),
                              (b"idx1", b"")]
    # avih: µs/frame, flags, frame count, streams, width, height
    for i in (0, 3, 4, 6, 8, 9):
        assert tl[1][i] == jl[1][i], i
    assert tl[1][4] == N and tl[1][8:10] == (W, H)
    assert tl[2] == jl[2] == (b"vids", b"MJPG")
    assert tl[3] == jl[3] == [(b"00dc", b"\xff\xd8\xff")] * N
    assert [e[:2] for e in tl[4]] == [e[:2] for e in jl[4]] \
        == [(b"00dc", 0x10)] * N
    # every reader on every file: the same frames out of one file, and
    # close to the source out of both (JPEG, chroma halved, on
        # per-channel texture: a mean error under 6 levels)
    for path in (jpath, tpath):
        jr, tr = javi.MJPEGAviReader(path), tavi.MJPEGAviReader(path)
        assert len(tr) == len(jr) == N and tr.fps == jr.fps == 25.0
        got = _read_all(tr)
        np.testing.assert_array_equal(got, _read_all(jr))
        assert np.abs(got.astype(int) - frames.astype(int)).mean() < 6.0
    a = _read_all(tavi.MJPEGAviReader(jpath)).astype(int)
    b = _read_all(tavi.MJPEGAviReader(tpath)).astype(int)
    assert np.abs(a - b).max() <= 2      # two encoders, one libjpeg family


def test_jpeg_codec_pair():
    frame = _frames(4, n=1)[0]
    data = twr.encode_jpeg_bgr(frame, 85)
    assert data[:3] == b"\xff\xd8\xff"
    np.testing.assert_array_equal(tavi.decode_jpeg_bgr(data),
                                  javi.decode_jpeg_bgr(data))
    jdata = jwr.encode_jpeg_bgr(frame, 85)
    np.testing.assert_array_equal(tavi.decode_jpeg_bgr(jdata),
                                  javi.decode_jpeg_bgr(jdata))
    assert np.abs(tavi.decode_jpeg_bgr(data).astype(int)
                  - frame.astype(int)).mean() < 6.0


def test_avi_reader_survives_a_truncated_file(tmp_path):
    path = str(tmp_path / "t.avi")
    _write(twr.MJPEGAVIWriter(path, fps=30, workers=0), _frames(5))
    data = open(path, "rb").read()
    cut = str(tmp_path / "cut.avi")
    open(cut, "wb").write(data[:data.index(b"idx1") - 40])   # no index
    tr, jr = tavi.MJPEGAviReader(cut), javi.MJPEGAviReader(cut)
    assert len(tr) == len(jr) == N - 1
    np.testing.assert_array_equal(_read_all(tr), _read_all(jr))
    open(cut, "wb").write(b"RIFFxxxxWAVE")
    with pytest.raises(ValueError, match="not a RIFF AVI"):
        tavi.MJPEGAviReader(cut)
    open(cut, "wb").close()
    with pytest.raises(ValueError, match="not a RIFF AVI"):
        tavi.MJPEGAviReader(cut)


@pytest.mark.parametrize("suffix,cls", [(".npy", "NpyWriter"),
                                        (".avi", "MJPEGAVIWriter"),
                                        (".y4m", "Y4MWriter"),
                                        (".mp4", None)])
def test_make_writer_picks_by_suffix(tmp_path, suffix, cls):
    w = twr.make_writer(str(tmp_path / f"out{suffix}"), fps=30, quality=80)
    j = jwr.make_writer(str(tmp_path / f"jout{suffix}"), fps=30, quality=80)
    assert type(w).__name__ == type(j).__name__
    if cls:
        assert type(w).__name__ == cls
    w.release()
    j.release()
    with pytest.raises(ValueError, match="unsupported recording format"):
        twr.make_writer(str(tmp_path / "x.webm"))


@pytest.mark.parametrize("pre,post", [(0, 0), (2, 3), (5, 1)])
def test_event_gated_writer_policy_equals_jax(pre, post):
    class Sink:
        def __init__(self):
            self.got = []

        def write(self, f):
            self.got.append(f)

        def release(self):
            self.got.append("released")

    rng = np.random.RandomState(pre + post)
    trig = rng.rand(60) < 0.15
    a, b = Sink(), Sink()
    jw = jwr.EventGatedWriter(a, pre_roll=pre, post_roll=post)
    tw = tio.EventGatedWriter(b, pre_roll=pre, post_roll=post)
    for i, t in enumerate(trig):
        jw.write_gated(i, bool(t))
        tw.write_gated(i, bool(t))
    jw.write(100)
    tw.write(100)
    jw.release()
    tw.release()
    assert b.got == a.got and tw.summary() == jw.summary()
    assert tw.summary()["segments"] >= 1


def test_fps_meter_equals_jax():
    a, b = jfps.FPSMeter(alpha=0.2), tio.FPSMeter(alpha=0.2)
    t = 100.0
    for dt in (0.0, 0.033, 0.04, 1e-9, 0.5, 0.033):
        t += dt
        assert b.tick(t) == a.tick(t)
    assert (b.frames, b.fps) == (a.frames, a.fps)
    b.reset()
    assert (b.frames, b.fps) == (0, 0.0)


def test_image_dir_source_equals_jax(tmp_path):
    from PIL import Image
    frames = _frames(6, n=4)
    for i, f in enumerate(frames):
        ext = ("png", "jpg", "bmp", "jpeg")[i]
        Image.fromarray(f[..., ::-1]).save(tmp_path / f"im_{i}.{ext}")
    (tmp_path / "notes.txt").write_text("not an image")
    got = _read_all(tcap.ImageDirSource(str(tmp_path)))
    np.testing.assert_array_equal(got,
                                  _read_all(jcap.ImageDirSource(str(tmp_path))))
    np.testing.assert_array_equal(got[0], frames[0])      # png is exact
    assert got.shape == (4, H, W, 3)


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    """ffmpeg / ffprobe stand-ins on PATH that emit a known rawvideo
    stream (no real binary is promised anywhere)."""
    raw = tmp_path / "frames.raw"
    raw.write_bytes(_frames(7).tobytes())
    ffmpeg = tmp_path / "ffmpeg"
    ffmpeg.write_text(f"#!/bin/sh\ncat {raw}\n")
    ffprobe = tmp_path / "ffprobe"
    ffprobe.write_text(f'#!/bin/sh\necho "{W},{H},25/1"\n')
    for p in (ffmpeg, ffprobe):
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    return tmp_path


def test_ffmpeg_pipe_source(fake_ffmpeg, monkeypatch):
    src = tcap.FFmpegPipeSource("clip.mkv")
    assert (src.w, src.h, src.fps) == (W, H, 25.0)
    proc = src.proc
    np.testing.assert_array_equal(_read_all(src), _frames(7))
    assert proc.poll() is not None                  # reaped on release
    vs = tio.VideoSource(source="ffmpeg:clip.mkv", width=W, height=H)
    frames, ts, m = vs.read_batch(4)
    assert m == 4 and np.allclose(np.diff(ts), 1 / 25.0)   # the file's rate
    vs.release()
    monkeypatch.setattr(tcap, "_HAS_CV2", False)
    vs = tio.VideoSource(source="clip.mp4", width=W, height=H)
    assert isinstance(vs._src, tcap.FFmpegPipeSource) and vs.read().ok
    vs.release()
    monkeypatch.setenv("PATH", str(fake_ffmpeg / "nowhere"))
    with pytest.raises(RuntimeError, match="not on PATH"):
        tcap.FFmpegPipeSource("clip.mkv")
    with pytest.raises(RuntimeError, match="OpenCV not available"):
        tio.VideoSource(source="clip.mp4")


@pytest.mark.parametrize("spec", ["synthetic", "synthetic:6", "clip.npy",
                                  "clip.y4m", "clip.avi", "dir"])
def test_video_source_resolves_and_stamps_as_jax(tmp_path, spec):
    frames = _frames(8)
    _write(twr.make_writer(str(tmp_path / "clip.npy")), frames)
    _write(twr.make_writer(str(tmp_path / "clip.y4m"), fps=25), frames)
    _write(twr.make_writer(str(tmp_path / "clip.avi"), fps=25), frames)
    (tmp_path / "dir").mkdir()
    from PIL import Image
    for i, f in enumerate(frames[:3]):
        Image.fromarray(f[..., ::-1]).save(tmp_path / "dir" / f"{i}.png")
    src = spec if spec.startswith("synthetic") else str(tmp_path / spec)
    kw = dict(source=src, width=W, height=H, fps_request=20, num_frames=5)
    jv, tv = jcap.VideoSource(**kw), tio.VideoSource(**kw)
    assert type(tv._src).__name__ == type(jv._src).__name__
    jv._t0 = tv._t0 = 1.7e9
    jf, jts, jm = jv.read_batch(4)
    tf, tts, tm = tv.read_batch(4)
    assert tm == jm and tm >= 3
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tts, jts)
    fr = tv.read()
    assert isinstance(fr, tio.Frame) and fr.ok == jv.read().ok
    jv.release()
    tv.release()


def test_video_source_ends_and_refuses():
    vs = tio.VideoSource("synthetic:2", 32, 24, num_frames=3)
    assert vs.read_batch(8)[2] == 3
    frames, ts, m = vs.read_batch(8)
    assert m == 0 and frames.shape == (0, 0, 0, 3) and ts.shape == (0,)
    fog = tio.VideoSource("synthetic_fog:heavy", 40, 24, num_frames=1,
                          device="cpu")
    assert isinstance(fog._src, tcap.FoggedSyntheticRoadSource)
    assert fog.read_batch(4)[0].shape == (1, 24, 40, 3)
    with pytest.raises(ValueError, match="unknown fog level"):
        tio.VideoSource("synthetic_fog:foggy", device="cpu")
    noisy = tcap.SyntheticRoadSource(64, 48, 3, noise=0.05, seed=2)
    np.testing.assert_array_equal(
        noisy.render(4),
        jcap.SyntheticRoadSource(64, 48, 3, noise=0.05, seed=2).render(4))


def test_opencv_source_is_optional(monkeypatch):
    """cv2 stays optional: with it, an unopenable source reads not-ok;
    without it, the source raises instead of importing."""
    if tcap._HAS_CV2:
        vs = tio.VideoSource("/nonexistent/clip.mkv")
        assert isinstance(vs._src, tcap.OpenCVSource)
        assert not vs.read().ok
        vs.release()
    monkeypatch.setattr(tcap, "_HAS_CV2", False)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="OpenCV not available"):
        tcap.OpenCVSource(0, 640, 480, 30)


def test_device_synthetic_source_matches_host_and_jax():
    host = tcap.SyntheticRoadSource(160, 120, num_vehicles=3, seed=1)
    dev = tio.DeviceSyntheticSource(160, 120, num_vehicles=3, seed=1,
                                    device="cpu")
    jsrc = jdev.DeviceSyntheticSource(160, 120, num_vehicles=3, seed=1)
    got = dev.make_render_fn(batch=4)(5)
    assert tuple(got.shape) == (4, 120, 160, 3) and got.dtype == torch.uint8
    want = np.asarray(jsrc.make_render_fn(batch=4)(np.int32(5)))
    for i in range(4):
        # same float32 formulas: a rectangle edge may round to the next
        # pixel row or column (under 2 % of the pixels), as the JAX
        # renderer's own test allows against the host
        assert (got[i].numpy() != host.render(5 + i)).mean() < 0.02
        assert (got[i].numpy() != want[i]).mean() < 0.02
    at = dev.make_render_at_fn()(torch.tensor([5, 5, 50]))
    np.testing.assert_array_equal(at[0].numpy(), got[0].numpy())
    np.testing.assert_array_equal(at[1].numpy(), at[0].numpy())
    assert not np.array_equal(at[2].numpy(), at[0].numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tio.DeviceSyntheticSource(32, 24)
