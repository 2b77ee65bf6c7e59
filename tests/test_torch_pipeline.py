"""The port's slice as a whole vs the JAX package, and the port's rules.

The port's ``PipelineEngine`` and the JAX ``PipelineEngine`` (both
float32, CPU) run the same ``SyntheticRoadSource`` frames for 2 batches
with ``assets/yolov8n_synthetic_256.npz``. 288x480 frames at imgsz 160
letterbox by an exact stride-3 slice, as 1080p does at 640. Processed
frames must be bit-equal; per-frame Detection lists must agree in count,
class and track id, boxes within 0.05 px and confidences within 2e-3
(float32 reduction order through the detector), distances and speeds
within rtol 1e-3.
"""
import ast
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roadvision_tpu.config import DEFAULTS as JDEFAULTS
from roadvision_tpu.config import merge as jmerge
from roadvision_tpu.io_video.capture import SyntheticRoadSource as JSource
from roadvision_tpu.preprocess import PreprocessPipeline as JPipeline
from roadvision_tpu.runtime import PipelineEngine as JEngine
from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.io_video import SyntheticRoadSource, VideoSource
from roadvision_tpu_torch.io_video.capture import FoggedSyntheticRoadSource
from roadvision_tpu_torch.kernels import _build
from roadvision_tpu_torch.ops import clahe as tclahe
from roadvision_tpu_torch.ops import median as tmedian
from roadvision_tpu_torch.ops import nms as tnms
from roadvision_tpu_torch.preprocess import PreprocessPipeline, get_op_class
from roadvision_tpu_torch.runtime import PipelineEngine
from roadvision_tpu_torch.track import sort as tsort
from roadvision_tpu_torch.utils import resolve_device

ROOT = Path(__file__).resolve().parent.parent
H, W = 288, 480

# The port's tests run torch on one intra-op thread. The suite runs in
# several pytest-xdist workers that share the machine's cores, and each
# worker imports every test module, so this holds in every worker: with
# torch's default pool (one thread per core) in each of them the cores
# are oversubscribed and every parallel region waits for descheduled
# threads (a bench rehearsal took 68-71 s under the suite's load with 8
# threads, 9.5 s with 1).
torch.set_num_threads(1)
BOX_TOL, CONF_TOL = 0.05, 2e-3
CHAIN = [{"name": "CLAHEDehaze",
          "params": {"space": "YCrCb", "clip_limit": 2.0, "tile_grid": 8}},
         {"name": "MedianDerain", "params": {"ksize": 3}}]


def _override():
    return {
        "preprocess": {"enabled": True, "chain": CHAIN},
        "detect": {"enabled": True, "model": "assets/yolov8n_synthetic_256.npz",
                   "imgsz": 160, "conf_thres": 0.25, "iou_thres": 0.7,
                   "max_det": 20, "classes_keep": [2], "device": "cpu",
                   "compute_dtype": "float32"},
        "tracking": {"enabled": True, "max_staleness": 1.2, "min_hits": 3,
                     "iou_threshold": 0.35, "speed_window": 0.8},
        "geometry": {"enabled": True, "projector": {
            "type": "homography",
            "image_points": [[0, H], [W, H], [0, int(0.4 * H)],
                             [W, int(0.4 * H)]],
            "world_points": [[0, 0], [20, 0], [0, 120], [20, 120]],
            "origin": [10.0, 0.0], "max_distance": 1000.0}},
        "tpu": {"batch_size": 8, "compute_dtype": "float32"},
    }


def _close(a, b, rtol=1e-3):
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= rtol * max(1.0, abs(b))


@pytest.mark.parametrize("tracking,batches", [(True, 2), (False, 1)])
def test_engine_matches_jax_engine(tracking, batches):
    over = _override()
    over["tracking"]["enabled"] = tracking    # off: projector-only distance
    jeng = JEngine(jmerge(JDEFAULTS, over))
    teng = PipelineEngine(merge(DEFAULTS, over), device="cpu")
    src = JSource(W, H, num_vehicles=6)
    n_dets = 0
    for bi in range(batches):
        frames = np.stack([src.render(bi * 8 + i) for i in range(8)])
        ts = 1.7e9 + (bi * 8 + np.arange(8)) / 30.0
        want = jeng.process_batch(frames, ts)
        got = teng.process_batch(frames, ts)
        for f, (w, g) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(g.proc, w.proc)
            assert g.ts == w.ts
            assert len(g.detections) == len(w.detections), (bi, f)
            for dg, dw in zip(g.detections, w.detections):
                assert (dg.cls_id, dg.cls_name, dg.track_id) == \
                    (dw.cls_id, dw.cls_name, dw.track_id)
                assert max(abs(p - q) for p, q in zip(
                    (dg.x1, dg.y1, dg.x2, dg.y2),
                    (dw.x1, dw.y1, dw.x2, dw.y2))) < BOX_TOL
                assert abs(dg.conf - dw.conf) < CONF_TOL
                assert _close(dg.distance_m, dw.distance_m)
                assert _close(dg.speed_kmh, dw.speed_kmh)
            n_dets += len(g.detections)
    assert n_dets >= 8 * batches     # the comparison saw real detections
    assert any(d.distance_m is not None for r in got for d in r.detections)
    assert tracking == any(d.speed_kmh is not None
                           for r in got for d in r.detections)


def test_engine_without_detector_returns_processed_frames():
    eng = PipelineEngine(merge(DEFAULTS, {
        "preprocess": {"enabled": True, "chain": CHAIN}}), device="cpu")
    frames = np.random.RandomState(6).randint(0, 256, (2, 32, 48, 3),
                                              dtype=np.uint8)
    out = eng.process_batch(frames, np.array([5.0, 5.1]))
    want = PreprocessPipeline({"chain": CHAIN}).apply_batch(
        torch.from_numpy(frames)).numpy()
    for r, w in zip(out, want):
        np.testing.assert_array_equal(r.proc, w)
        assert r.detections == []


@pytest.mark.parametrize("blend", ["cv2", "fixed"])
def test_preprocess_pipeline_matches_jax(blend):
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, (3, 64, 96, 3), dtype=np.uint8)
    chain = [dict(CHAIN[0], params=dict(CHAIN[0]["params"], tile_grid=4)),
             {"name": "CUDAMedianDerain", "params": {"ksize": 4}}]
    tchain = [dict(chain[0], params=dict(chain[0]["params"], blend=blend)),
              chain[1]]
    jp = JPipeline({"enabled": True, "chain": chain})
    tp = PreprocessPipeline({"enabled": True, "chain": tchain})
    got = tp.apply_batch(torch.from_numpy(frames)).numpy()
    if blend == "cv2":     # the JAX package's default blend
        np.testing.assert_array_equal(got, np.asarray(
            jp.apply_batch(jnp.asarray(frames))))
    else:                  # "fixed" through the JAX functions directly
        from roadvision_tpu.ops import color, clahe, median
        x = jnp.asarray(frames.astype(np.int32))
        y, cr, cb = color.bgr_planes_to_ycrcb_i32(x[..., 0], x[..., 1],
                                                  x[..., 2])
        y = clahe.clahe_planar_i32(y, 2.0, (4, 4), blend="fixed")
        planes = color.ycrcb_planes_to_bgr_i32(y, cr, cb)
        want = np.stack([np.asarray(median.median_planar_i32(p, 5))
                         for p in planes], -1)
        np.testing.assert_array_equal(got, want)
    assert PreprocessPipeline({"enabled": False, "chain": chain}).identity


def test_registry_aliases_and_unknown_name():
    assert get_op_class("CUDACLAHEDehaze") is get_op_class("CLAHEDehaze")
    assert get_op_class("CUDAMedianDerain") is get_op_class("MedianDerain")
    with pytest.raises(KeyError):
        get_op_class("Sharpen")


@pytest.mark.parametrize("over", [
    {"detect": {"enabled": True, "model": "yolov8n.pt"},
     "tracking": {"enabled": True, "backend": "bytetrack"}},
    {"detect": {"enabled": True, "model": "yolov8n.pt"},
     "tracking": {"enabled": True, "backend": "deepsort"}},
    {"detect": {"enabled": True, "model": "yolov8n.pt"},
     "tracking": {"enabled": True, "association": "hungarian"}},
    {"detect": {"enabled": True, "model": "yolov8n.pt"},
     "tracking": {"enabled": True, "gmc": True}},
    {"detect": {"enabled": True, "model": "yolov8n.pt",
                "temporal_gate": {"enable": True}}},
    {"detect": {"enabled": True, "model": "yolov8n.pt"},
     "tracking": {"enabled": True, "backend": "ocsort"}},
])
def test_engine_refuses_unported_configs(over):
    """These configs raised ``NotImplementedError`` before their backends,
    GMC and the temporal gate were ported; now each builds and processes
    a batch (their parity with JAX: tests/test_torch_{trackers,gmc_reid,
    gate}.py)."""
    over = merge(over, {"detect": {"model": _NPZ, "imgsz": 64}})
    eng = PipelineEngine(merge(DEFAULTS, over), device="cpu")
    out = eng.process_batch(np.zeros((2, 48, 64, 3), np.uint8),
                            np.array([0.0, 0.1]))
    assert len(out) == 2


@pytest.mark.parametrize("over", [
    {"preprocess": {"enabled": True, "chain": CHAIN,
                    "auto_gate": {"enable_low_contrast_gate": True,
                                  "impulse_thresh": 2.5}}},
    {"preprocess": {"enabled": True, "chain": CHAIN,
                    "auto_gate": {"enable_low_contrast_gate": True,
                                  "contrast_thresh": "auto"}}},
    {"preprocess": {"enabled": True, "chain": [
        {"name": "CLAHEDehaze", "params": {"space": "LAB"}}]}},
    {"preprocess": {"enabled": True, "chain": CHAIN},
     "tpu": {"sampled_preprocess": True}},
])
def test_engine_accepts_the_whole_preprocess_layer(over):
    """Gate, "auto" threshold, LAB and the sampled path construct and
    process a batch (they raised NotImplementedError before they were
    ported)."""
    eng = PipelineEngine(merge(DEFAULTS, over), device="cpu")
    frames = np.random.RandomState(2).randint(0, 256, (2, 32, 48, 3),
                                              dtype=np.uint8)
    out = eng.process_batch(frames, np.array([1.0, 1.1]))
    assert len(out) == 2 and out[0].proc.shape == (32, 48, 3)


def test_stream_over_synthetic_source():
    cfg = merge(DEFAULTS, {
        "preprocess": {"enabled": True, "chain": CHAIN},
        "detect": {"enabled": True, "model": "yolov8n.pt", "imgsz": 64,
                   "max_det": 5},
        "tracking": {"enabled": True},
        "tpu": {"batch_size": 3}})
    eng = PipelineEngine(cfg, device="cpu")
    out = list(eng.stream(VideoSource("synthetic:2", 96, 64), max_frames=7))
    assert len(out) == 7
    assert all(r.proc.shape == (64, 96, 3) for r in out)
    assert [r.ts for r in out] == sorted(r.ts for r in out)
    fog = VideoSource("synthetic_fog:medium:3", 48, 32, device="cpu")
    assert isinstance(fog._src, FoggedSyntheticRoadSource)
    assert (fog._src.level, fog._src.n_veh) == ("medium", 3)

    class Broken:
        def read_batch(self, n):
            raise OSError("decoder lost")

    # a failing source is logged and ends the stream, as in the JAX engine
    assert list(eng.stream(Broken())) == []


_NPZ = "assets/yolov8n_synthetic_256.npz"


@pytest.mark.parametrize("over,tracks,projects", [
    ({"tracking": {"backend": "nosuch"}}, False, True),
    ({"tracking": {"iou_threshold": "abc"}}, False, True),
    ({"tracking": {"association": "nosuch"}}, False, True),
    ({"geometry": {"projector": "x"}}, True, False),
])
def test_engine_construction_soft_fails_as_jax(over, tracks, projects):
    """A tracker or projector that fails to build is logged and left out,
    as the JAX engine does; the rest of the engine runs."""
    cfg = merge(merge(DEFAULTS, {
        "detect": {"enabled": True, "model": _NPZ, "imgsz": 64,
                   "compute_dtype": "float32", "device": "cpu"},
        "tracking": {"enabled": True},
        "geometry": {"enabled": True, "projector": {
            "type": "homography",
            "image_points": [[0, 48], [64, 48], [0, 20], [64, 20]],
            "world_points": [[0, 0], [6, 0], [0, 60], [6, 60]]}}}), over)
    jeng = JEngine(jmerge(JDEFAULTS, cfg))
    eng = PipelineEngine(cfg, device="cpu")
    assert (jeng.track_enabled, jeng.projector is not None) \
        == (eng.track_enabled, eng.projector is not None) \
        == (tracks, projects)
    out = eng.process_batch(np.zeros((2, 48, 64, 3), np.uint8),
                            np.array([0.0, 0.1]))
    assert len(out) == 2


def test_engine_construction_lets_not_ported_through(monkeypatch):
    """``NotImplementedError`` is not soft-failed: a tracker that is not
    ported says so by name (every backend is ported now, so one is
    simulated); the hungarian association builds."""
    cfg = merge(DEFAULTS, {
        "detect": {"enabled": True, "model": _NPZ, "imgsz": 64},
        "tracking": {"enabled": True, "association": "hungarian"}})
    assert PipelineEngine(cfg, device="cpu").track_enabled
    from roadvision_tpu_torch.runtime import engine as tengine

    def not_ported(cfg):
        raise NotImplementedError("tracking.backend 'x' is not ported")
    monkeypatch.setattr(tengine, "build_device_step", not_ported)
    with pytest.raises(NotImplementedError, match="not ported"):
        PipelineEngine(cfg, device="cpu")
    from roadvision_tpu_torch.track.sort import make_sort_step
    with pytest.raises(ValueError, match="unknown association"):
        make_sort_step(0.3, 1.0, 0.75, association="nosuch")


class _FailsAfter:
    """A source that gives ``good`` frames, then fails as a truncated
    file does."""

    def __init__(self, good: int):
        self.src = SyntheticRoadSource(64, 48, 2, seed=1)
        self.i, self.good = 0, good

    def read_batch(self, n):
        if self.i >= self.good:
            raise OSError("truncated")
        m = min(n, self.good - self.i)
        frames = np.stack([self.src.render(self.i + k) for k in range(m)])
        ts = 1000.0 + (self.i + np.arange(m)) / 30.0
        self.i += m
        return frames, ts, m


def test_source_failure_ends_the_stream_as_in_jax():
    """The frames read before the failure come out, then the stream ends
    without raising, in the JAX engine and in the port alike."""
    over = {"preprocess": {"enabled": True, "chain": CHAIN},
            "tpu": {"batch_size": 2}}
    jout = list(JEngine(jmerge(JDEFAULTS, over)).stream(_FailsAfter(5)))
    out = list(PipelineEngine(merge(DEFAULTS, over), device="cpu")
               .stream(_FailsAfter(5)))
    assert len(out) == len(jout) == 5
    for a, b in zip(jout, out):
        np.testing.assert_array_equal(np.asarray(a.proc), b.proc)


def test_upload_failure_is_raised_not_taken_for_a_short_source():
    """Only the source's own read soft-fails: a fault of the engine's
    upload (a broken ring, a card error in the copy) reaches the caller
    instead of ending the stream as if the video were short."""
    over = {"preprocess": {"enabled": True, "chain": CHAIN},
            "tpu": {"batch_size": 2}}
    eng = PipelineEngine(merge(DEFAULTS, over), device="cpu")
    calls = []
    real_upload = eng.upload

    def upload(frames):
        calls.append(len(frames))
        if len(calls) == 2:
            raise RuntimeError("4 uploads are waiting to be dispatched")
        return real_upload(frames)

    eng.upload = upload
    with pytest.raises(RuntimeError, match="uploads are waiting"):
        list(eng.stream(_FailsAfter(6)))
    assert calls == [2, 2]


def test_truncated_video_ends_pipeline_and_serve_normally(tmp_path):
    """A y4m with three frames and then garbage: ``Pipeline.__call__``
    yields the JAX pipeline's frames (the first batch of two; the batch
    the failure cuts is dropped in both) and ``tools/serve.py::main``
    returns 0, as the JAX tools do."""
    from roadvision_tpu_torch import Pipeline
    from roadvision_tpu_torch.io_video import Y4MWriter
    from roadvision_tpu_torch.tools import serve
    path = tmp_path / "cut.y4m"
    w = Y4MWriter(str(path))
    src = SyntheticRoadSource(32, 24, 2, seed=0)
    for i in range(3):
        w.write(src.render(i))
    w.release()
    with open(path, "ab") as fh:
        fh.write(b"GARBAGE\n" + bytes(100))
    cfg = merge(DEFAULTS, {"camera": {"source": str(path)},
                           "preprocess": {"enabled": True, "chain": CHAIN},
                           "tpu": {"batch_size": 2}})
    from roadvision_tpu.api import Pipeline as JPipeline_
    jout = list(JPipeline_(cfg)())
    out = list(Pipeline(cfg, device="cpu")())
    assert len(out) == len(jout) == 2
    for a, b in zip(jout, out):
        np.testing.assert_array_equal(np.asarray(a.proc), b.proc)
    cfg_path = tmp_path / "cut.yaml"
    import yaml
    cfg_path.write_text(yaml.safe_dump(cfg))
    assert serve.main(["--config", str(cfg_path), "--port", "0",
                       "--device", "cpu"]) == 0


def test_synthetic_source_is_a_copy_of_the_jax_one():
    a, b = SyntheticRoadSource(200, 120, 5, seed=3), JSource(200, 120, 5,
                                                             seed=3)
    for i in (0, 17):
        np.testing.assert_array_equal(a.render(i), b.render(i))
        assert a.gt_boxes(i) == b.gt_boxes(i)


# ---------------------------------------------------------------------------
# the port's rules

def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "roadvision_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "roadvision_tpu", "flax"), \
                f"{path.relative_to(ROOT)} imports {mod}"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineEngine(merge(DEFAULTS, {}))
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_never_fall_back(monkeypatch, tmp_path):
    """A non-CPU tensor never reaches a plain version, and without nvcc
    the kernels do not build: the card path raises instead of computing."""
    meta = torch.empty((2, 16, 16), dtype=torch.uint8, device="meta")
    luts = torch.empty((2, 2, 2, 256), dtype=torch.uint8, device="meta")
    scores = torch.empty((2, 16, 16), device="meta")
    alive = torch.empty((2, 16), dtype=torch.bool, device="meta")
    over = torch.empty((2, 16, 16), dtype=torch.bool, device="meta")
    for call in (lambda: tclahe.clahe_tile_luts(meta, 2, 2, 1, np.float32(1)),
                 lambda: tclahe.clahe_apply(meta, luts, 8, 8),
                 lambda: tmedian.median_planes(meta, 3),
                 lambda: tsort.greedy_associate(scores, alive, alive, 0.3),
                 lambda: tsort.auction_associate(scores, alive, alive, 0.3),
                 lambda: tnms.greedy_keep(over, alive)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_CANDIDATES", ())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("median")
    assert set(_build.launch_counts) == {"clahe_tile_luts", "clahe_apply",
                                         "median_k", "assoc_greedy",
                                         "assoc_auction", "nms_keep",
                                         "deform_sample"}
