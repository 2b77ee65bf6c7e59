"""The serving surface of the port vs the JAX package (CPU, float32).

The slice as a whole: ``roadvision_tpu_torch.Pipeline`` and
``roadvision_tpu.Pipeline`` stream the same 16 frames of ``synthetic:6``
(288x480, imgsz 160: an exact stride-3 letterbox, as 1080p at 640) with
``assets/yolov8n_synthetic_256.npz``. Processed frames bit-equal;
``Detection`` lists equal in count, class and track id, boxes within
0.05 px, confidences within 2e-3 (float32 reduction order through the
detector), distance and speed within rtol 1e-3, as
``tests/test_torch_pipeline.py``. Then the engine's state files, the
detector's host API, the config loader, the watchdog, and the entry
points (preview, detect, track, bench, cli) on the CPU.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import roadvision_tpu as rv
import roadvision_tpu_torch as rvt
from roadvision_tpu import config as jconfig
from roadvision_tpu.detect.types import Detection as JDetection
from roadvision_tpu.detect.types import DetectionBatch as JDetectionBatch
from roadvision_tpu_torch import cli
from roadvision_tpu_torch import config as tconfig
from roadvision_tpu_torch.detect import (COCO_NAMES, Detection, DetectionBatch,
                                         Detector, build_detector)
from roadvision_tpu_torch.io_video import MJPEGAviReader
from roadvision_tpu_torch.models.yolo import weights as tweights
from roadvision_tpu_torch.runtime import PipelineEngine
from roadvision_tpu_torch.runtime import engine as tengine
from roadvision_tpu_torch.tools import bench, detect, preview, track
from roadvision_tpu_torch.track import state_from_jax
from roadvision_tpu_torch.utils import (RES_WIDTH, StageTimer, get_logger,
                                        res_width)

ROOT = Path(__file__).resolve().parent.parent
H, W, N = 288, 480, 16
BOX_TOL, CONF_TOL = 0.05, 2e-3
MODEL = "assets/yolov8n_synthetic_256.npz"
CHAIN = [{"name": "CLAHEDehaze",
          "params": {"space": "YCrCb", "clip_limit": 2.0, "tile_grid": 8}},
         {"name": "MedianDerain", "params": {"ksize": 3}}]


def _cfg():
    return {
        "camera": {"source": "synthetic:6", "width": W, "height": H,
                   "fps_request": 30},
        "preprocess": {"enabled": True, "chain": CHAIN},
        "detect": {"enabled": True, "model": MODEL, "imgsz": 160,
                   "conf_thres": 0.25, "iou_thres": 0.7, "max_det": 20,
                   "classes_keep": [2], "compute_dtype": "float32"},
        "tracking": {"enabled": True, "max_staleness": 1.2, "min_hits": 3,
                     "iou_threshold": 0.35, "speed_window": 0.8},
        "geometry": {"enabled": True, "projector": {
            "type": "homography",
            "image_points": [[0, H], [W, H], [0, int(0.4 * H)],
                             [W, int(0.4 * H)]],
            "world_points": [[0, 0], [20, 0], [0, 120], [20, 120]],
            "origin": [10.0, 0.0], "max_distance": 1000.0}},
        "vis": {"draw": {"thickness": 1, "font_scale": 0.35}},
        "tpu": {"batch_size": 8, "compute_dtype": "float32"},
    }


def _close(a, b, rtol=1e-3):
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= rtol * max(1.0, abs(b))


def _same_results(got, want, ids_only=False):
    assert len(got) == len(want)
    n = 0
    for f, (g, w) in enumerate(zip(got, want)):
        assert g.ts == w.ts
        assert len(g.detections) == len(w.detections), f
        for dg, dw in zip(g.detections, w.detections):
            assert (dg.cls_id, dg.cls_name, dg.track_id) == \
                (dw.cls_id, dw.cls_name, dw.track_id), f
            if ids_only:
                continue
            assert max(abs(p - q) for p, q in zip(
                (dg.x1, dg.y1, dg.x2, dg.y2),
                (dw.x1, dw.y1, dw.x2, dw.y2))) < BOX_TOL
            assert abs(dg.conf - dw.conf) < CONF_TOL
            assert _close(dg.distance_m, dw.distance_m)
            assert _close(dg.speed_kmh, dw.speed_kmh)
        n += len(g.detections)
    return n


def _stream(pipe, n=N, t0=1.7e9):
    vs = pipe.open_source(None, max_frames=n)
    vs._t0 = t0                     # the same stamps on both sides
    return list(pipe(vs, max_frames=n))


@pytest.fixture(scope="module")
def pipes():
    """Both pipelines after the same 16 frames, with their results."""
    jp = rv.Pipeline(_cfg())
    tp = rvt.Pipeline(_cfg(), device="cpu")
    return jp, tp, _stream(jp), _stream(tp)


def test_pipeline_matches_jax_pipeline(pipes):
    jp, tp, want, got = pipes
    assert len(got) == N
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.raw, w.raw)
        np.testing.assert_array_equal(g.proc, w.proc)
    assert _same_results(got, want) >= N
    assert any(d.speed_kmh is not None for r in got for d in r.detections)
    assert tp.engine.lb_meta(H, W) == jp.engine.lb_meta(H, W)
    assert tp.engine.lb_meta(1080, 1920) == jp.engine.lb_meta(1080, 1920)
    assert set(tp.engine.timer.count) >= {"decode", "device_step",
                                          "host_unpack"}
    assert tp.engine.timer.count["device_step"] == 2


def test_state_file_of_the_jax_engine_continues_in_the_port(pipes, tmp_path):
    """Frames 16..23 after a hand-over of the stream state: through the
    JAX engine's ``save_state`` file and ``load_state``, and through
    ``state_from_jax`` on the live arrays. Same ids as the JAX engine
    going on by itself, and bit-equal between the two ways."""
    jp, tp, _, _ = pipes
    src = rvt.io_video.SyntheticRoadSource(W, H, num_vehicles=6)
    frames = np.stack([src.render(N + i) for i in range(8)])
    ts = 1.7e9 + (N + np.arange(8)) / 30.0
    jp.engine.save_state(tmp_path / "jax_state.npz")
    arrays = {k: np.asarray(v)
              for k, v in jp.engine.sort_state._asdict().items()}
    want = jp.engine.process_batch(frames, ts)

    by_file = PipelineEngine(tp.cfg, device="cpu")
    by_file.load_state(tmp_path / "jax_state.npz")
    live = PipelineEngine(tp.cfg, device="cpu")
    live.sort_state = state_from_jax(arrays, device="cpu")
    live._t0 = jp.engine._t0
    got = by_file.process_batch(frames, ts)
    assert _same_results(got, want) >= 8
    ids = {d.track_id for r in got for d in r.detections}
    assert min(ids) <= 6          # identities from before the hand-over
    other = live.process_batch(frames, ts)
    assert [r.detections for r in other] == [r.detections for r in got]
    # and the port's own engine, which saw the same 16 frames
    assert _same_results(tp.engine.process_batch(frames, ts), want) >= 8


def test_save_state_load_state_continues_bit_equal(tmp_path):
    cfg = tconfig.merge(tconfig.DEFAULTS, _cfg())
    src = rvt.io_video.SyntheticRoadSource(W, H, num_vehicles=6)
    batches = [(np.stack([src.render(k * 4 + i) for i in range(4)]),
                50.0 + (k * 4 + np.arange(4)) / 30.0) for k in range(6)]
    first = PipelineEngine(cfg, device="cpu")
    for f, t in batches[:3]:
        first.process_batch(f, t, want_proc=False)
    first.save_state(tmp_path / "s.npz")
    want = [first.process_batch(f, t, want_proc=False) for f, t in batches[3:]]
    second = PipelineEngine(cfg, device="cpu")
    second.load_state(tmp_path / "s.npz")
    assert second._t0 == first._t0 == 50.0
    got = [second.process_batch(f, t, want_proc=False) for f, t in batches[3:]]
    assert [[r.detections for r in b] for b in got] == \
        [[r.detections for r in b] for b in want]
    assert any(d.speed_kmh is not None and d.track_id is not None
               for b in got for r in b for d in r.detections)
    with np.load(tmp_path / "s.npz") as z:
        assert set(z.files) == {"t0"} | {f"sort_{k}" for k in
                                         tengine.SortState._fields}
        ref = tengine.init_state(4, "cpu")
        for k in tengine.SortState._fields:
            assert torch.from_numpy(z[f"sort_{k}"]).dtype == \
                getattr(ref, k).dtype, k
    # the two errors of the JAX engine
    other = PipelineEngine(tconfig.merge(cfg, {"tpu": {"track_slots": 32}}),
                           device="cpu")
    with pytest.raises(ValueError, match="track slots"):
        other.load_state(tmp_path / "s.npz")
    no_track = PipelineEngine(tconfig.merge(
        cfg, {"tracking": {"enabled": False}}), device="cpu")
    no_track.save_state(tmp_path / "bare.npz")
    with pytest.raises(ValueError, match="missing tracker arrays"):
        second.load_state(tmp_path / "bare.npz")
    no_track.load_state(tmp_path / "s.npz")       # nothing to restore
    fresh = PipelineEngine(cfg, device="cpu")
    fresh.save_state(tmp_path / "fresh.npz")
    second.load_state(tmp_path / "fresh.npz")
    assert second._t0 is None


def test_infer_batch_matches_yolo_jax(pipes):
    """``infer_batch`` / ``infer`` against ``YOLOJax`` in float32, the
    torch weights taken over by ``set_params``; batch 1 gives the row
    that batch 8 gives."""
    jp, tp, want, _ = pipes
    jdet = jp.engine.detector
    tdet = build_detector(dict(_cfg()["detect"], model="missing.pt"),
                          device="cpu", seed=3)
    assert isinstance(tdet, Detector) and not tdet.loaded and tdet.nc == 80
    tdet.set_params(jax_tree_to_numpy(jdet.params))
    assert tdet.nc == jdet.nc and tdet.names == jdet.names
    frames = np.stack([r.raw for r in want[:8]])
    jb, tb = jdet.infer_batch(frames), tdet.infer_batch(frames)
    assert isinstance(tb, DetectionBatch) and tb.capacity == jb.capacity == 20
    np.testing.assert_array_equal(tb.valid, jb.valid)
    assert tb.valid.sum() >= 8
    np.testing.assert_array_equal(tb.cls_id[tb.valid], jb.cls_id[jb.valid])
    assert np.abs(tb.boxes[tb.valid] - jb.boxes[jb.valid]).max() < BOX_TOL
    assert np.abs(tb.conf[tb.valid] - jb.conf[jb.valid]).max() < CONF_TOL
    assert tb.boxes.dtype == np.float32 and tb.cls_id.dtype == np.int32
    one, jone = tdet.infer(frames[3]), jdet.infer(frames[3])
    row = DetectionBatch(tb.boxes[3], tb.conf[3], tb.cls_id[3],
                         tb.valid[3]).to_detections(
        [tdet.names[i] for i in range(tdet.nc)])
    assert len(one) == len(row) == len(jone) >= 1
    for d, r, j in zip(one, row, jone):
        assert (d.cls_id, d.cls_name) == (r.cls_id, r.cls_name) == \
            (j.cls_id, j.cls_name)
        assert max(abs(p - q) for p, q in zip(
            (d.x1, d.y1, d.x2, d.y2), (r.x1, r.y1, r.x2, r.y2))) < BOX_TOL
        assert abs(d.conf - r.conf) < CONF_TOL
        assert abs(d.conf - j.conf) < CONF_TOL
    with pytest.raises(ValueError, match="yolov8s tree"):
        tdet.set_params({"0": {"w": np.zeros((3, 3, 3, 32))},
                         "22": {"cv3": [[None, None, {"b": np.zeros(4)}]]}})
    tdet.close()
    assert tp.detect_image(frames[3]) == tp.engine.detector.infer(frames[3])


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("cfg,err", [
    ({"backend": "onnx", "model": "w.onnx"}, FileNotFoundError),
    # RT-DETR loads .pt / .npz weights only (it raised NotImplementedError
    # here before it was ported; the case keeps its name)
    pytest.param({"backend": "ultralytics", "model": "rtdetr-l.onnx"},
                 ValueError, id="cfg1-NotImplementedError"),
    ({"backend": "onnx", "model": "yolo11n.pt"}, ValueError),
    ({"backend": "jax", "model": "yolov5n.pt", "task": "pose"}, ValueError),
    ({"backend": "tensorrt"}, ValueError),
    ({"backend": "caffe"}, ValueError)])
def test_detector_registry_names(cfg, err):
    with pytest.raises(err):
        build_detector(cfg, device="cpu")


def test_detection_batch_round_trips_as_jax():
    rng = np.random.RandomState(0)
    fields = []
    for i in range(7):
        x, y = rng.uniform(0, 300, 2)
        fields.append(dict(
            x1=float(x), y1=float(y), x2=float(x + 30), y2=float(y + 20),
            conf=float(np.float32(rng.uniform())), cls_id=int(i * 13 % 85),
            cls_name="x", track_id=[None, 4, 9][i % 3],
            distance_m=[None, 12.5][i % 2], speed_kmh=[33.25, None][i % 2]))
    for cap in (10, 4):
        jb = JDetectionBatch.from_detections(
            [JDetection(**f) for f in fields], cap)
        tb = DetectionBatch.from_detections(
            [Detection(**f) for f in fields], cap)
        assert tb.capacity == jb.capacity == cap
        for name in ("boxes", "conf", "cls_id", "valid", "track_id",
                     "distance_m", "speed_kmh"):
            got, want = getattr(tb, name), getattr(jb, name)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        back, jback = tb.to_detections(), jb.to_detections()
        assert len(back) == min(cap, 7)
        for d, j in zip(back, jback):
            assert vars(d) == vars(j)
    assert tuple(COCO_NAMES) == tuple(rv.detect.types.COCO_NAMES)
    bare = DetectionBatch(np.zeros((2, 3, 4), np.float32),
                          np.zeros((2, 3), np.float32),
                          np.zeros((2, 3), np.int32), np.zeros((2, 3), bool))
    assert bare.track_id.shape == (2, 3) and np.isnan(bare.speed_kmh).all()
    with pytest.raises(ValueError, match="single frame"):
        bare.to_detections()


@pytest.mark.parametrize("name", ["default.yaml", "synthetic_demo.yaml",
                                  "weather_demo.yaml", "multi_stream.yaml"])
def test_config_files_load_as_in_jax(name):
    path = str(ROOT / "configs" / name)
    assert tconfig.load_config(path) == jconfig.load_config(path)
    assert tconfig.DEFAULTS == jconfig.DEFAULTS
    assert tconfig.DEFAULTS["tpu"]["watchdog_s"] == 60.0
    assert tconfig.load_config(None) == jconfig.load_config(None)
    assert tconfig.project_root() == jconfig.project_root() == ROOT
    assert rvt.load_config is tconfig.load_config
    node = {"a": None, "b": {"c": None, "d": [None]}}
    assert tconfig.sanitize_none(node) == jconfig.sanitize_none(node) \
        == {"a": {}, "b": {"c": {}, "d": [None]}}
    with pytest.raises(FileNotFoundError, match="config file not found"):
        tconfig.load_config("/nope.yaml")


def test_utils_copies():
    assert res_width(1080) == 1920 and res_width(480) == 640
    assert res_width(2160) == 3840 and RES_WIDTH[720] == 1280
    timer = StageTimer(alpha=0.5)
    for _ in range(3):
        with timer.stage("a"):
            pass
    assert timer.count == {"a": 3} and timer.p50_ms("a") >= 0.0
    assert timer.p50_ms("b") == 0.0 and timer.summary().startswith("a=")
    log = get_logger("roadvision.test_torch_api")
    assert log is get_logger("roadvision.test_torch_api")
    assert len(log.handlers) == 1 and not log.propagate


def test_watchdog_arms_only_on_a_warm_shape(monkeypatch):
    """The first batch of a shape never starts the timer (it builds the
    kernels); a later one does, with ``tpu.watchdog_s``, and cancels it.
    The callback only sets ``watchdog_fired``."""
    timers = []

    class FakeTimer:
        def __init__(self, interval, fn):
            self.interval, self.fn = interval, fn
            self.started = self.cancelled = False
            timers.append(self)

        def start(self):
            self.started = True

        def cancel(self):
            self.cancelled = True

    monkeypatch.setattr(tengine.threading, "Timer", FakeTimer)
    cfg = tconfig.merge(tconfig.DEFAULTS, {
        "preprocess": {"enabled": True, "chain": CHAIN[1:]},
        "tpu": {"watchdog_s": 7.5}})
    eng = PipelineEngine(cfg, device="cpu")
    frames = np.zeros((2, 16, 24, 3), np.uint8)
    eng.process_batch(frames, np.array([0.0, 0.1]))
    assert timers == []
    eng.process_batch(frames, np.array([0.2, 0.3]), want_proc=False)
    assert timers == []                       # another shape key
    eng.process_batch(frames, np.array([0.4, 0.5]))
    assert len(timers) == 1 and timers[0].interval == 7.5
    assert timers[0].started and timers[0].cancelled
    assert not eng.watchdog_fired.is_set()
    timers[0].fn()
    assert eng.watchdog_fired.is_set()
    off = PipelineEngine(tconfig.merge(cfg, {"tpu": {"watchdog_s": 0}}),
                         device="cpu")
    for k in range(2):
        off.process_batch(frames, np.array([k, k + 0.1]))
    assert len(timers) == 1


def test_pipeline_library_surface(pipes, tmp_path):
    jp, tp, _, _ = pipes
    assert rvt.Pipeline is type(tp) and rvt.Detection is Detection
    # the fleet runs (tests/test_torch_multi_stream.py holds it)
    first = next(tp.streams(["synthetic:1", "synthetic:2"], max_frames=2))
    assert len(first) == 2 and all(len(r) == 2 for r in first)
    with pytest.raises(AttributeError):
        rvt.NoSuchThing
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rvt.Pipeline(_cfg())              # the card by default
    off = rvt.Pipeline(_cfg(), device="cpu", detect={"enabled": False})
    with pytest.raises(RuntimeError, match="detection is disabled"):
        off.detect_image(np.zeros((H, W, 3), np.uint8))
    # process_frames stamps by camera.fps_request and carries on
    frames = np.stack([rvt.io_video.SyntheticRoadSource(W, H, 6).render(i)
                       for i in range(3)])
    a = off.process_frames(frames)
    b = off.process_frames(frames[0])
    assert [r.ts for r in a] == [0.0, 1 / 30, 2 / 30]
    assert len(b) == 1 and abs(b[0].ts - 0.1) < 1e-9
    off.reset()
    assert off.process_frames(frames[:1])[0].ts == 0.0
    # process_video: the JAX package's summary, and a file that plays
    tp.reset()
    jp.reset()
    out = tmp_path / "t.avi"
    got = tp.process_video(None, str(out), max_frames=N)
    want = jp.process_video(None, str(tmp_path / "j.avi"), max_frames=N)
    assert got["frames"] == want["frames"] == N
    assert got["unique_tracks"] == want["unique_tracks"] >= 1
    assert got["duration_s"] == want["duration_s"]
    reader = MJPEGAviReader(str(out))
    assert len(reader) == N
    ok, img = reader.read_frame()
    assert ok and img.shape == (H, W, 3)
    reader.release()


def _write_cfg(tmp_path, **over):
    import yaml
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(tconfig.merge(_cfg(), over)))
    return str(path)


def test_preview_main_records_and_probes(tmp_path):
    cfg = _write_cfg(tmp_path)
    out = tmp_path / "o.avi"
    state = tmp_path / "state.npz"
    rc = preview.main(["--config", cfg, "--max-frames", "12", "--no-show",
                       "--record", str(out), "--device", "cpu",
                       "--state", str(state)])
    assert rc == 0 and state.exists()
    data = out.read_bytes()
    assert data[:4] == b"RIFF" and data.count(b"\xff\xd8\xff") == 12
    reader = MJPEGAviReader(str(out))
    ok, img = reader.read_frame()
    assert ok and img.shape == (H, 2 * W + 4, 3)      # the compare canvas
    reader.release()
    # resumes from the state file; event-gated recording to .npy
    gated = _write_cfg(tmp_path, preview={"compare": {"enable": False},
                                          "record": {"events_only": True,
                                                     "pre_roll": 1,
                                                     "post_roll": 1}})
    rc = preview.main(["--config", gated, "--max-frames", "4", "--no-show",
                       "--record", str(tmp_path / "g.npy"), "--device",
                       "cpu", "--state", str(state), "--watch-config"])
    assert rc == 0
    assert np.load(tmp_path / "g.npy").shape[1:] == (H, W, 3)
    # the known-good probes of the JAX preview
    assert preview.main(["--config", cfg, "--max-frames", "0", "--no-show",
                         "--device", "cpu"]) == 0
    with pytest.raises(FileNotFoundError):
        preview.main(["--config", "/nope.yaml", "--device", "cpu"])
    with pytest.raises(ValueError, match="unsupported recording format"):
        preview.main(["--config", cfg, "--max-frames", "2", "--no-show",
                      "--record", str(tmp_path / "x.webm"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            preview.main(["--config", cfg, "--max-frames", "2", "--no-show"])
    # analytics and the camera fleet run (they raised before their port)
    for over in ({"analytics": {"enabled": True}},
                 {"tpu": {"mesh": {"enable": True}},
                  "camera": {"sources": ["synthetic:1", "synthetic:2"]}}):
        assert preview.main(["--config", _write_cfg(tmp_path, **over),
                             "--max-frames", "2", "--no-show",
                             "--device", "cpu"]) == 0


def test_config_watcher_reloads_hot_sections(tmp_path):
    path = _write_cfg(tmp_path)
    cfg = tconfig.load_config(path)
    watcher = preview.ConfigWatcher(path, cfg)
    assert watcher.poll() is None
    import os
    import yaml
    hot = tconfig.merge(_cfg(), {"vis": {"draw": {"thickness": 3}}})
    Path(path).write_text(yaml.safe_dump(hot))
    os.utime(path, (watcher.mtime + 5, watcher.mtime + 5))
    fresh = watcher.poll()
    assert fresh["vis"]["draw"]["thickness"] == 3
    cold = tconfig.merge(hot, {"detect": {"conf_thres": 0.5}})
    Path(path).write_text(yaml.safe_dump(cold))
    os.utime(path, (watcher.mtime + 5, watcher.mtime + 5))
    assert watcher.poll() is None        # needs a restart: nothing applied
    assert preview.ConfigWatcher(None, cfg).poll() is None


def test_detect_and_track_tools(tmp_path, capsys):
    out = tmp_path / "det"
    rc = detect.main(["--source", "synthetic:3", "--frames", "2", "--out",
                      str(out), "--weights", MODEL, "--imgsz", "160",
                      "--classes", "2", "--dtype", "float32", "--json",
                      "--device", "cpu"])
    assert rc == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "detections.json", "frame_00000.jpg", "frame_00001.jpg"]
    records = json.loads((out / "detections.json").read_text())
    assert len(records) == 2 and all(
        {"bbox", "conf", "cls_id", "cls_name"} <= set(d)
        for frame in records for d in frame)
    with pytest.raises(ValueError, match="mutually exclusive"):
        detect.main(["--source", "synthetic", "--out", str(out), "--tta",
                     "--tile", "64", "--device", "cpu"])
    mot = tmp_path / "mot" / "t.txt"
    rc = track.main(["--source", "synthetic:6", "--frames", "12", "--out",
                     str(mot), "--config", _write_cfg(tmp_path), "--width",
                     str(W), "--height", str(H), "--interpolate", "2",
                     "--record", str(tmp_path / "trk.npy"), "--device",
                     "cpu"])
    assert rc == 0
    rows = [ln.split(",") for ln in mot.read_text().splitlines()]
    assert rows and all(len(r) == 10 and r[-1] == "-1" for r in rows)
    assert {int(r[0]) for r in rows} <= set(range(1, 13))
    assert any(float(r[7]) != -1.0 for r in rows)     # ground coordinates
    assert np.load(tmp_path / "trk.npy").shape == (12, H, W, 3)
    # --gt and the other backends raised NotImplementedError before they
    # were ported (their parity: tests/test_torch_{gate,trackers}.py)
    gt = tmp_path / "gt.txt"
    shutil.copy(mot, gt)
    for extra in (["--gt", str(gt)], ["--backend", "ocsort"]):
        assert track.main(["--source", "synthetic:6", "--frames", "4",
                           "--out", str(mot), "--config",
                           _write_cfg(tmp_path), "--width", str(W),
                           "--height", str(H), "--device", "cpu",
                           *extra]) == 0
    assert capsys.readouterr().out.count('"mota"') == 1


def test_bench_rehearsal_line_and_modes(capsys, monkeypatch):
    """The port bench at a toy size on the CPU: one JSON line with the
    documented keys, named as a CPU run; nothing of it is a device
    number."""
    rc = bench.main(["--device", "cpu", "--res", "360", "--batch", "2",
                     "--iters", "1", "--windows", "2", "--warmup", "1",
                     "--dtype", "float32"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 1
    line = json.loads(out[0])
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    assert line["card"] is None and line["metric"] == "pipeline_360p_fps"
    for key in ("host_fed_process_batch_fps", "host_fed_stream_fps",
                "device_resident_fps"):
        assert set(line[key]) == {"median", "min", "max", "windows"}
        assert len(line[key]["windows"]) == 2 and line[key]["min"] > 0
    assert set(line["stage_ms"]) == {"preprocess", "letterbox", "forward",
                                     "nms", "sort_geometry"}
    assert {"decode", "device_step", "host_unpack"} <= set(line["timer_ms"])
    assert set(line["launches_per_batch"]) == {
        "clahe_tile_luts", "clahe_apply", "median_k", "assoc_greedy",
        "assoc_auction", "nms_keep", "deform_sample", "deform_sample_bwd"}
    assert (line["batch"], line["iters"], line["dtype"]) == (2, 1, "float32")
    assert not any("baseline" in k or "v5e" in k for k in line)
    for mode, key in (("sort", "sort_tracker_fps"),
                      ("geometry", "homography_batch100_calls_per_sec"),
                      ("record", "record_tail_fps")):
        assert bench.main(["--device", "cpu", "--res", "360", "--iters", "1",
                           "--windows", "1", "--mode", mode]) == 0
        got = json.loads(capsys.readouterr().out.strip())
        assert got["mode"] == mode and got[key]["median"] > 0
    # the camera fleet (it raised before its port), at RVT_BENCH_RES
    monkeypatch.setenv("RVT_BENCH_STREAMS", "2")
    monkeypatch.setenv("RVT_BENCH_RES", "64")
    assert bench.main(["--device", "cpu", "--res", "360", "--iters", "1",
                       "--windows", "1", "--mode", "streams"]) == 0
    got = json.loads(capsys.readouterr().out.strip())
    assert got["metric"] == "streams2_64p_fps"
    assert got["streams_fps"]["median"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(["--iters", "1"])
    cfg = bench.bench_cfg(1080, 1920, 8, "yolov8n.pt")
    import bench as jbench
    want = jbench._cfg(1080, 1920, 8)
    for section in ("preprocess", "tracking", "geometry"):
        assert cfg[section] == want[section]
    assert {k: cfg["detect"][k] for k in ("conf_thres", "iou_thres",
                                          "max_det", "classes_keep")} == \
        {k: want["detect"][k] for k in ("conf_thres", "iou_thres",
                                        "max_det", "classes_keep")}


def test_cli_names_the_tools():
    with pytest.raises(SystemExit) as ei:
        cli.preview(["--help"])
    assert ei.value.code == 0
    with pytest.raises(SystemExit) as ei:
        cli.train(["--help"])
    assert ei.value.code == 0
    # --dp reaches the data-parallel step (it raised NotImplementedError
    # before multi-card training was ported): 8 images do not split 3 ways
    with pytest.raises(ValueError, match="--dp 3"):
        cli.train(["--dp", "3"])
    with pytest.raises(SystemExit) as ei:
        cli.analyze(["--help"])
    assert ei.value.code == 0
    for name in ("preview", "detect", "track", "serve", "bench", "analyze",
                 "train"):
        assert callable(getattr(cli, name))
    p = subprocess.run([sys.executable, "-m", "roadvision_tpu_torch.cli"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0 and "usage:" in p.stderr
