"""The port's deployment helpers against the JAX package's, on the CPU:
the host API that closed C4 (``GroundProjector.distance`` /
``distance_for_bbox``, ``preprocess.register``, ``ops.masks.mask_iou``),
``tools/calibrate.py``, ``tools/calibrate_gate.py``, ``tools/warmup.py``
and ``utils/cache.py``.

Tolerances: the distances are the same float32 ``np.linalg.norm`` on
both sides, so equal; the calibrate tool's numbers are float64 numpy on
both sides, so its printed report is equal character for character;
calibrate_gate's JSON is equal (host statistics, the same frames).
JAX's own cases of ``tests/test_geometry.py:50-73`` are included.
``calibrate_gate`` with neither frames nor statistics raises a clear
``ValueError`` in the port (the JAX method fails obscurely there), so
the two are compared only on valid inputs.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from roadvision_tpu.geometry import GroundProjector as JGround  # noqa: E402
from roadvision_tpu.geometry import build_projector as jbuild  # noqa: E402
from roadvision_tpu.ops.masks import mask_iou as jmask_iou  # noqa: E402
from roadvision_tpu.preprocess import registry as jregistry  # noqa: E402
from roadvision_tpu_torch.geometry import GroundProjector  # noqa: E402
from roadvision_tpu_torch.geometry import build_projector  # noqa: E402
from roadvision_tpu_torch.ops.masks import mask_iou  # noqa: E402
from roadvision_tpu_torch.preprocess import (PreprocessOp,  # noqa: E402
                                             PreprocessPipeline, register)
from roadvision_tpu_torch.preprocess import registry  # noqa: E402
from tools import calibrate as jcalibrate  # noqa: E402
from tools import calibrate_gate as jcalibrate_gate  # noqa: E402
from roadvision_tpu_torch.tools import calibrate, calibrate_gate  # noqa: E402

torch.set_num_threads(1)


def _affine_cfg(**over):
    # tests/test_geometry.py's map: image (x, y) → world (x/100, (480-y)/10)
    cfg = {"type": "homography",
           "image_points": [[0, 480], [640, 480], [0, 80], [640, 80]],
           "world_points": [[0.0, 0.0], [6.4, 0.0], [0.0, 40.0],
                            [6.4, 40.0]],
           "origin": [0.0, 0.0], "max_distance": 1000.0}
    cfg.update(over)
    return cfg


def _pair(**over):
    cfg = {"projector": _affine_cfg(**over)}
    return build_projector(cfg, device="cpu"), jbuild(cfg)


# ---------------------------------------------------------------------------
# C4: the host API
# ---------------------------------------------------------------------------

def test_jax_cases_bottom_center_and_distance_clamp():
    """tests/test_geometry.py:50-59, on the port and on JAX."""
    for proj in _pair(max_distance=30.0):
        assert isinstance(proj, (GroundProjector, JGround))
        pt = proj.project_bbox((300, 100, 340, 280))
        np.testing.assert_allclose(pt, (3.2, 20.0), atol=1e-6)
        assert abs(proj.distance(pt) - np.hypot(3.2, 20.0)) < 1e-5
        assert proj.distance_for_bbox((300, 50, 340, 85)) == 30.0


@pytest.mark.parametrize("over", [{}, {"max_distance": 30.0},
                                  {"max_distance": None},
                                  {"origin": [3.0, -2.5]}])
@pytest.mark.parametrize("point", [(3.2, 20.0), (-7.5, 123.25), (0.0, 0.0),
                                   None, (float("inf"), 1.0),
                                   (float("nan"), 0.0), (1e20, 1e20)])
def test_distance_equals_jax(over, point):
    port, jax_ = _pair(**over)
    assert port.distance(point) == jax_.distance(point)


@pytest.mark.parametrize("bbox", [(300, 100, 340, 280), (0, 0, 10, 480),
                                  (100, 200, 200, 400), (300, 50, 340, 85),
                                  (10, 10, 20, 20.5)])
def test_distance_for_bbox_equals_jax(bbox):
    for over in ({}, {"max_distance": 25.0}, {"origin": [1.0, 2.0]}):
        port, jax_ = _pair(**over)
        assert port.project_bbox(bbox) == jax_.project_bbox(bbox)
        assert port.distance_for_bbox(bbox) == jax_.distance_for_bbox(bbox)


def test_degenerate_mapping_gives_none():
    """A line of w = 0 (the horizon): no point, no distance, in both."""
    cfg = {"projector": _affine_cfg(
        image_points=[[0, 480], [640, 480], [0, 300], [640, 300]],
        world_points=[[0, 0], [6.4, 0], [0, 1e6], [6.4, 1e6]])}
    port, jax_ = build_projector(cfg, device="cpu"), jbuild(cfg)
    for bbox in ((300, 100, 340, 299.99), (300, 100, 340, 280)):
        assert port.distance_for_bbox(bbox) == jax_.distance_for_bbox(bbox)


def test_ground_projector_is_abstract_and_subclassable():
    with pytest.raises(TypeError):
        GroundProjector()

    class Flat(GroundProjector):
        def project_point(self, x, y):
            return (x / 10.0, y / 10.0)

    class JFlat(JGround):
        def project_point(self, x, y):
            return (x / 10.0, y / 10.0)

    for origin, maxd in (((0, 0), None), ((1, 1), 5.0)):
        a, b = Flat(origin, maxd), JFlat(origin, maxd)
        for bbox in ((0, 0, 40, 30), (100, 0, 300, 900)):
            assert a.distance_for_bbox(bbox) == b.distance_for_bbox(bbox)
    with pytest.raises(ValueError):
        Flat(origin=(1, 2, 3))


def test_register_a_custom_op(monkeypatch):
    class Invert(PreprocessOp):
        def apply_batch(self, frames):
            return 255 - frames

    monkeypatch.setitem(registry.REGISTRY, "Invert", None)
    register("Invert", Invert)
    assert registry.get_op_class("Invert") is Invert
    pipe = PreprocessPipeline({"enabled": True,
                               "chain": [{"name": "Invert"}]}, device="cpu")
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 8, 12, 3), np.uint8))
    np.testing.assert_array_equal(pipe.apply_batch(frames).numpy(),
                                  255 - frames.numpy())
    # the same names, aliases included, on both sides
    assert set(registry.REGISTRY) - {"Invert"} == set(jregistry.REGISTRY)
    with pytest.raises(KeyError, match="Available"):
        registry.get_op_class("Nope")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_iou_equals_jax(seed):
    rng = np.random.RandomState(seed)
    a = rng.rand(24, 32) > 0.5
    b = rng.rand(24, 32) > 0.4
    assert mask_iou(a, b) == jmask_iou(a, b)
    assert mask_iou(a, a) == jmask_iou(a, a) == 1.0
    z = np.zeros((4, 4), bool)
    assert mask_iou(z, z) == jmask_iou(z, z) == 0.0
    assert mask_iou(a.astype(np.uint8), b.astype(np.float32)) \
        == jmask_iou(a.astype(np.uint8), b.astype(np.float32))


# ---------------------------------------------------------------------------
# tools/calibrate.py
# ---------------------------------------------------------------------------

def _points(tmp_path, name, img, wld, **extra):
    p = tmp_path / f"{name}.yaml"
    p.write_text(yaml.safe_dump({"image_points": np.asarray(img).tolist(),
                                 "world_points": np.asarray(wld).tolist(),
                                 **extra}))
    return str(p)


def _world(H, img):
    m = np.hstack([img, np.ones((len(img), 1))]) @ H.T
    return m[:, :2] / m[:, 2:]


H_TRUE = np.array([[0.02, 0.001, -3.0], [0.0005, -0.3, 150.0],
                   [1e-5, -2e-3, 1.0]])


def _cases(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.uniform([0, 200], [640, 480], (7, 2))
    wld = _world(H_TRUE, img)
    noisy = wld + rng.normal(0, 0.3, wld.shape)
    line = np.stack([np.linspace(0, 600, 5), np.linspace(100, 400, 5)], 1)
    tight = img[:5] * 0.01 + 100
    return {
        "exact": ([_points(tmp_path, "exact", img[:5], wld[:5], origin=[1, 2])
                   ], []),
        "check": ([_points(tmp_path, "main", img[:5], wld[:5]), "--check",
                   _points(tmp_path, "held", img[5:], wld[5:])], []),
        "noisy": ([_points(tmp_path, "noisy", img, noisy)],
                  ["--max-error", "2.0", "--origin", "0.5,-1"]),
        "collinear": ([_points(tmp_path, "line", line, _world(H_TRUE, line))],
                      []),
        "collinear_allowed": ([_points(tmp_path, "line2", line,
                                       _world(H_TRUE, line))],
                              ["--allow-warnings", "--max-error", "1e9"]),
        "tiny_span": ([_points(tmp_path, "tiny", tight,
                               _world(H_TRUE, tight))], []),
        "three": ([_points(tmp_path, "three", img[:3], wld[:3])], []),
        "config": ([str(ROOT / "configs" / "default.yaml")], []),
    }


@pytest.mark.parametrize("case", ["exact", "check", "noisy", "collinear",
                                  "collinear_allowed", "tiny_span", "three",
                                  "config"])
def test_calibrate_report_equals_jax(tmp_path, capsys, case):
    points, extra = _cases(tmp_path)[case]
    argv = ["--points", *points, *extra]
    rc_j = jcalibrate.main(argv)
    want = capsys.readouterr()
    rc = calibrate.main(argv + ["--device", "cpu"])
    got = capsys.readouterr()
    assert rc == rc_j
    assert got.out == want.out
    assert got.err == want.err


def test_calibrate_functions_equal_jax():
    rng = np.random.RandomState(3)
    img = rng.uniform(0, 640, (6, 2))
    wld = _world(H_TRUE, img) + rng.normal(0, 0.1, (6, 2))
    for a, b in zip(calibrate.reprojection_report(img, wld),
                    jcalibrate.reprojection_report(img, wld)):
        np.testing.assert_array_equal(a, b)
    for pts in (img, img[:, :1] * np.ones((1, 2)), img * 1e-3):
        assert calibrate.diagnostics(pts) == jcalibrate.diagnostics(pts)


def test_calibrate_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    points, _ = _cases(tmp_path)["exact"]
    with pytest.raises(RuntimeError, match="cuda"):
        calibrate.main(["--points", *points])


# ---------------------------------------------------------------------------
# tools/calibrate_gate.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--frames", "24", "--width", "128", "--height", "96", "--json"],
    ["--frames", "16", "--width", "96", "--height", "96", "--stat", "pspan",
     "--ratio", "0.9", "--pct", "20", "--impulse-margin", "2.0", "--json"],
    ["--frames", "12", "--width", "64", "--height", "64",
     "--source", "synthetic:3"],
])
def test_calibrate_gate_equals_jax(capsys, argv):
    rc_j = jcalibrate_gate.main(argv)
    want = capsys.readouterr()
    rc = calibrate_gate.main(argv + ["--device", "cpu"])
    got = capsys.readouterr()
    assert rc == rc_j == 0
    if "--json" in argv:
        assert json.loads(got.out) == json.loads(want.out)
    else:
        assert got.out == want.out and got.err == want.err


def test_calibrate_gate_threshold_and_the_clear_error():
    from roadvision_tpu.preprocess import PreprocessPipeline as JPipeline
    cfg = {"enabled": True, "chain": [],
           "auto_gate": {"enable_low_contrast_gate": True,
                         "contrast_thresh": "auto", "stat": "span"}}
    frames = np.random.RandomState(0).randint(30, 200, (6, 32, 48, 3),
                                              np.uint8)
    pipe = PreprocessPipeline(cfg, device="cpu")
    assert pipe.calibrate_gate(frames) == JPipeline(cfg).calibrate_gate(
        frames)
    stats = pipe.host_gate_stats(frames)
    assert pipe.calibrate_gate(stats=stats) \
        == JPipeline(cfg).calibrate_gate(stats=stats)
    with pytest.raises(ValueError, match="frames_u8 or stats"):
        pipe.calibrate_gate()


# ---------------------------------------------------------------------------
# tools/warmup.py and utils/cache.py
# ---------------------------------------------------------------------------

def _warm_cfg(tmp_path, gate: bool) -> str:
    cfg = {"camera": {"width": 96, "height": 64},
           "detect": {"enabled": True,
                      "model": str(ROOT / "assets"
                                   / "yolov8n_synthetic_256.npz"),
                      "imgsz": 96},
           "tpu": {"batch_size": 2}}
    if gate:
        cfg["detect"]["temporal_gate"] = {"enable": True}
    p = tmp_path / f"warm_{gate}.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def test_warm_shape_coasts_as_jax(tmp_path):
    """Zero frames score as static: with the gate, the second batch of
    each want_proc coasts (the JAX warm_shape's contract); both engines
    coast the same frames."""
    from roadvision_tpu.config import load_config as jload
    from roadvision_tpu.runtime import PipelineEngine as JEngine
    from roadvision_tpu_torch.config import load_config
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.tools import warmup
    from tools import warmup as jwarmup
    path = _warm_cfg(tmp_path, gate=True)
    eng = PipelineEngine(load_config(path), device="cpu")
    jeng = JEngine(jload(path))
    warmup.warm_shape(eng, 64, 96, 2)
    jwarmup.warm_shape(jeng, 64, 96, 2)
    assert eng.gate_frames_coasted == jeng.gate_frames_coasted == 2


@pytest.mark.parametrize("gate", [False, True])
def test_warmup_main(tmp_path, gate):
    from roadvision_tpu_torch.tools import warmup
    assert warmup.main(["--config", _warm_cfg(tmp_path, gate), "--res",
                        "64,96", "--batch", "2", "--device", "cpu"]) == 0


def test_enable_compilation_cache(monkeypatch, tmp_path):
    from roadvision_tpu_torch.kernels import _build
    from roadvision_tpu_torch.runtime import native
    from roadvision_tpu_torch.utils.cache import enable_compilation_cache
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    before = _build.BUILD_DIR
    assert enable_compilation_cache() == before
    monkeypatch.setenv("RVT_NO_CACHE", "1")
    assert enable_compilation_cache(tmp_path) is None
    assert _build.BUILD_DIR == before
    monkeypatch.delenv("RVT_NO_CACHE")
    assert enable_compilation_cache(tmp_path) == tmp_path.resolve()
    assert _build._lib_path("median").parent == tmp_path.resolve()
    assert native.build_dir() == tmp_path.resolve() / "native"
