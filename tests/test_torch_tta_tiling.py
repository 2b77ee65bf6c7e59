"""The port's test-time augmentation (``ops/tta.py``) and tiled inference
(``ops/tiling.py``) vs the JAX package (CPU, float32), with the trained
``assets/yolov8n_synthetic_256.npz`` on the synthetic road scene.

``scale_img`` applies, by their nonzero taps, the same weight matrices
``jax.image.resize(antialias=False)`` contracts: within 1e-5 (a few float32 ulps
of values in [0, 1]: XLA sums in another order; measured 1.7e-6). The
tile grid and the anchor trim are the same integers. The candidates (three augmented
passes; every tile plus the full frame in one batch) within 1e-4 in
scores and 1e-3 px in boxes (the forward's float32 noise, scaled by up
to 1 / 0.67 back to the base canvas, and the tiles' offsets of up to
~130 px where a float32 ulp is 1.5e-5 px); the NMS'd detections equal in
count, class and order, boxes within 1e-3 px, confidences within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models.yolo import yolov8 as j8
from roadvision_tpu.ops import tiling as jtiling
from roadvision_tpu.ops import tta as jtta
from roadvision_tpu_torch.detect.yolo_torch import YOLOTorch
from roadvision_tpu_torch.models.yolo import weights as tweights
from roadvision_tpu_torch.ops import tiling as ttiling
from roadvision_tpu_torch.ops import tta as ttta

from tests.oracles import torch_port

NPZ = "assets/yolov8n_synthetic_256.npz"
BOX_TOL, SCORE_TOL = 1e-3, 1e-4


def _road(n, w=224, h=128, seed=0):
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    src = SyntheticRoadSource(w, h, num_vehicles=6, seed=seed)
    return np.stack([src.render(i) for i in range(n)])


FRAMES = _road(2)
TS = 1000.0 + np.arange(2) / 30.0


def test_scale_img_matches_jax():
    x = np.random.RandomState(3).rand(2, 96, 160, 3).astype(np.float32)
    for ratio in (0.83, 0.67, 1.0):
        want = np.asarray(jtta.scale_img(jnp.asarray(x), ratio))
        got = ttta.scale_img(torch.from_numpy(x), ratio).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-5


def test_clip_bounds_and_tile_plans_match_jax():
    for n in (21 * 20, 21 * 48, 2520):
        for i in range(3):
            assert ttta.clip_bounds(n, i, 3) == jtta.clip_bounds(n, i, 3)
    for h, w, tile, ov in ((1080, 1920, 640, 0.25), (128, 224, 96, 0.25),
                           (96, 128, 64, 0.5), (60, 80, 96, 0.25),
                           (720, 1280, 512, 0.1)):
        assert ttiling.tile_plan(h, w, tile, ov) == \
            tuple(jtiling.tile_plan(h, w, tile, ov))
    assert len(ttiling.tile_plan(1080, 1920, 640, 0.25).offsets) == 8
    plan = ttiling.tile_plan(128, 224, 96, 0.25)
    np.testing.assert_array_equal(
        ttiling.extract_tiles(torch.from_numpy(FRAMES), plan).numpy(),
        np.asarray(jtiling.extract_tiles(jnp.asarray(FRAMES), plan)))


@pytest.fixture(scope="module")
def tree():
    return tweights.import_npz(NPZ)


def test_tta_candidates_match_jax(tree):
    imgs = YOLOTorch({"model": NPZ, "imgsz": 224}, device="cpu") \
        .letterbox(torch.from_numpy(FRAMES))[0]
    want = jax.jit(lambda p, x: jtta.tta_candidates(
        lambda p, x: j8.forward_raw(p, x, "n", 80), p, x))(
            tree, jnp.asarray(imgs.numpy()))
    model = tweights.model_from_params(tree).eval()
    with torch.no_grad():
        got = ttta.tta_candidates(model, imgs)
    for g, w, tol in zip(got, want, (BOX_TOL, SCORE_TOL)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() < tol


def test_tiled_candidates_match_jax(tree):
    from roadvision_tpu.detect.yolo_jax import YOLOJax
    cfg = {"model": NPZ, "imgsz": 96, "compute_dtype": "float32"}
    jdet = YOLOJax(dict(cfg, device="cpu"))
    det = YOLOTorch(cfg, device="cpu")
    plan = ttiling.tile_plan(128, 224, 96, 0.25)
    want = jax.jit(lambda p, f: jtiling.tiled_candidates(
        jdet, p, f, plan, full_frame=True))(jdet.params,
                                            jnp.asarray(FRAMES))
    with torch.no_grad():
        got = ttiling.tiled_candidates(det, torch.from_numpy(FRAMES), plan)
    for g, w, tol in zip(got, want, (BOX_TOL, SCORE_TOL)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() < tol


@pytest.mark.parametrize("over", [
    {"tta": True, "imgsz": 224},
    {"tiling": {"enable": True, "tile": 96, "overlap": 0.25},
     "imgsz": 96}])
def test_detector_matches_yolojax(over):
    from roadvision_tpu.detect.yolo_jax import YOLOJax
    cfg = dict({"model": NPZ, "conf_thres": 0.25, "max_det": 20,
                "compute_dtype": "float32"}, **over)
    det = YOLOTorch(cfg, device="cpu")
    jdet = YOLOJax(dict(cfg, device="cpu"))
    assert (det.tta, det.tile_cfg) == (jdet.tta, jdet.tile_cfg)
    got, want = det.infer_batch(FRAMES), jdet.infer_batch(FRAMES)
    np.testing.assert_array_equal(got.valid, want.valid)
    v = want.valid
    assert v.sum() > 4
    np.testing.assert_array_equal(got.cls_id[v], want.cls_id[v])
    assert np.abs(got.boxes[v] - want.boxes[v]).max() < BOX_TOL
    assert np.abs(got.conf[v] - want.conf[v]).max() < 1e-5


@pytest.mark.parametrize("over", [
    {"tta": True, "imgsz": 224},
    {"tiling": {"enable": True, "tile": 96, "overlap": 0.25,
                "full_frame": True}, "imgsz": 96}])
def test_engine_matches_jax_engine(over):
    """The chain, the detector's augmented or tiled pass and SORT: one
    batch through both engines."""
    cfg = torch_port.engine_cfg(NPZ, chain=True, tracking=True,
                                conf_thres=0.25, max_det=20, **over)
    got, want = torch_port.run_engines(cfg, FRAMES, TS)
    assert torch_port.assert_same_results(got, want, box_tol=BOX_TOL,
                                          conf_tol=1e-5) > 4
    from roadvision_tpu_torch.runtime import PipelineEngine
    eng = PipelineEngine(dict(cfg, tpu={"sampled_preprocess": True}),
                         device="cpu")
    if "tiling" in over:     # the tiles read the full processed frame
        assert eng.sampled_plans(128, 224, want_proc=False) is None
