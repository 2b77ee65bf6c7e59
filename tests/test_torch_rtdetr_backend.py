"""The port's RT-DETR detector (``detect/rtdetr_torch.py``), its engine
branch, int8, the registry and the export tool vs the JAX package's, on
the CPU.

Both packages load ``assets/rtdetr_l_synthetic_256.npz`` with the bf16
gather values off (each module's ``_BF16_VALS``). Stated bounds:

  * ``infer_batch`` on 48 × 72 synthetic road frames (stretched to 128):
    the same detections (count, class), boxes within 1e-3 px and
    confidences within 1e-5 (measured 0 and 4.5e-7);
  * the engine with SORT on 128 × 128 frames, two batches of two: the JAX
    engine's detections and track ids, boxes within 1e-3 px,
    confidences within 1e-4;
  * int8 (backbone and encoder convs; one decoder layer) against the
    JAX int8 detector, its weights quantised as its eager
    ``quantize_params`` quantises them: the same detections, boxes
    within 1e-4 px and confidences within 1e-5, with dynamic scales
    (measured 0 and 6e-8) and after each package's ``calibrate_int8`` on
    the same frames (measured 5.7e-6 px and 1.8e-7); the calibrated
    scales, conv by conv in execution order, within 2e-6 relative
    (measured 2.4e-7). One quantisation step of drift in one conv
    (``w_scale`` or ``a_scale`` × (1 + 1/127), backbone or encoder)
    moves the boxes 0.005-0.010 px, the confidences 4e-4-7.5e-4 and the
    scales 0.8-3 %.

``configs/rtdetr_demo.yaml`` runs through the port's preview CLI.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from roadvision_tpu.config import DEFAULTS as JDEFAULTS
from roadvision_tpu.config import merge as jmerge
from roadvision_tpu.detect.rtdetr_jax import RTDETRJax
from roadvision_tpu.models import rtdetr as J
from roadvision_tpu.models.yolo import quant as jquant
from roadvision_tpu.runtime import PipelineEngine as JEngine
from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.detect import build_detector
from roadvision_tpu_torch.detect.rtdetr_torch import RTDETRTorch
from roadvision_tpu_torch.io_video import SyntheticRoadSource
from roadvision_tpu_torch.models import rtdetr as T
from roadvision_tpu_torch.models.yolo import quant
from roadvision_tpu_torch.runtime import PipelineEngine

from tests.oracles.torch_port import quantize_params_np

ROOT = Path(__file__).resolve().parent.parent
NPZ = str(ROOT / "assets" / "rtdetr_l_synthetic_256.npz")
CFG = {"model": NPZ, "imgsz": 128, "conf_thres": 0.25, "max_det": 20,
       "device": "cpu", "compute_dtype": "float32"}


@pytest.fixture(autouse=True, scope="module")
def f32_gathers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_BF16_VALS", False)
        mp.setattr(T, "_BF16_VALS", False)
        yield


def _road(w, h, n, seed=0, step=5):
    src = SyntheticRoadSource(w, h, num_vehicles=5, seed=seed)
    return np.stack([src.render(step * i) for i in range(n)])


@pytest.fixture(scope="module")
def detector():
    return RTDETRTorch(CFG, device="cpu")


def _same_batch(a, b, box_tol, conf_tol):
    np.testing.assert_array_equal(a.valid, b.valid)
    v = a.valid
    assert v.any()
    np.testing.assert_array_equal(a.cls_id[v], b.cls_id[v])
    box = float(np.abs(a.boxes[v] - b.boxes[v]).max())
    conf = float(np.abs(a.conf[v] - b.conf[v]).max())
    assert box <= box_tol and conf <= conf_tol, (box, conf)


def test_infer_batch_matches_jax(detector):
    frames = _road(72, 48, 2)
    want = RTDETRJax(CFG).infer_batch(frames)
    got = detector.infer_batch(frames)
    assert got.boxes.shape == (2, 20, 4) and got.valid.dtype == bool
    _same_batch(want, got, 1e-3, 1e-5)
    dets = detector.infer(frames[1])
    assert len(dets) == int(got.valid[1].sum())
    for d in dets:
        assert 0 <= d.x1 <= d.x2 <= 72 and 0 <= d.y1 <= d.y2 <= 48
        assert d.cls_name == "car" and d.conf > 0.25


def test_detector_surface(detector):
    """The attributes the engine dispatches on, and the stretch resize's
    identity letterbox."""
    assert detector.nms_free and detector.task == "detect"
    assert detector.tile_cfg is None and detector.rect is False
    assert detector.dtype == torch.float32 and detector.loaded
    assert detector.num_queries == 100 and detector.nc == 80
    imgs, ratio, pad = detector.letterbox(
        torch.from_numpy(_road(72, 48, 1)))
    assert imgs.shape == (1, 128, 128, 3) and ratio == 1.0
    assert not pad.any()


def test_engine_matches_jax_with_tracking():
    """``process_batch`` through the NMS-free branch with SORT and the
    geometry: the JAX engine's detections and track ids."""
    over = {"preprocess": {"enabled": False},
            "detect": dict(CFG, enabled=True, classes_keep=[2]),
            "tracking": {"enabled": True, "max_staleness": 1.2,
                         "min_hits": 3, "iou_threshold": 0.35,
                         "speed_window": 0.8},
            "geometry": {"enabled": True, "projector": {
                "type": "homography",
                "image_points": [[0, 128], [128, 128], [0, 56], [128, 56]],
                "world_points": [[0, 0], [6.4, 0], [0, 60], [6.4, 60]],
                "origin": [3.2, -2.0], "max_distance": 100.0}},
            "tpu": {"batch_size": 2, "compute_dtype": "float32"}}
    jeng = JEngine(jmerge(JDEFAULTS, over))
    teng = PipelineEngine(merge(DEFAULTS, over), device="cpu")
    assert teng.lb_meta(128, 128) == (1.0, (0.0, 0.0))
    assert teng.sampled_plans(128, 128, False) is None
    frames = _road(128, 128, 4, step=2)
    ts = 1000.0 + np.arange(4) / 15.0
    n = 0
    for k in range(2):
        a = jeng.process_batch(frames[2 * k:2 * k + 2], ts[2 * k:2 * k + 2])
        b = teng.process_batch(frames[2 * k:2 * k + 2], ts[2 * k:2 * k + 2])
        for ra, rb in zip(a, b):
            assert len(ra.detections) == len(rb.detections)
            for da, db in zip(ra.detections, rb.detections):
                assert (da.cls_id, da.track_id) == (db.cls_id, db.track_id)
                assert max(abs(p - q) for p, q in zip(
                    (da.x1, da.y1, da.x2, da.y2),
                    (db.x1, db.y1, db.x2, db.y2))) <= 1e-3
                assert abs(da.conf - db.conf) <= 1e-4
                n += 1
    assert n > 0
    assert any(d.track_id for r in b for d in r.detections)


def test_sampled_preprocess_is_skipped_for_nms_free():
    eng = PipelineEngine(merge(DEFAULTS, {
        "preprocess": {"enabled": True, "chain": [
            {"name": "MedianDerain", "params": {"ksize": 3}}]},
        "detect": dict(CFG, enabled=True, imgsz=64),
        "tpu": {"sampled_preprocess": True}}), device="cpu")
    assert eng.sampled_plans(192, 192, False) is None
    out = eng.process_batch(_road(192, 192, 2), np.array([0.0, 0.1]),
                            want_proc=False)
    assert len(out) == 2


def test_num_queries_and_decoder_layers(detector):
    """Defaults and refusals as ``RTDETRJax``'s; the knobs reach the
    forward (nq proposals, the first K decoder layers)."""
    for bad, match in (({"max_det": 100, "num_queries": 50}, "max_det"),
                       ({"num_queries": 0}, "num_queries"),
                       ({"num_queries": 301}, "num_queries"),
                       ({"decoder_layers": 0}, "decoder_layers"),
                       ({"decoder_layers": 7}, "decoder_layers"),
                       ({"tiling": {"enable": True}}, "tiling"),
                       ({"tta": True}, "tta"),
                       ({"model": "rtdetr-l.onnx"}, "onnx")):
        cfg = dict({"model": "rtdetr-l.absent.pt"}, **bad)
        with pytest.raises(ValueError, match=match):
            RTDETRJax(cfg)
        with pytest.raises(ValueError, match=match):
            RTDETRTorch(cfg, device="cpu")
    imgs = torch.rand(1, 64, 64, 3, generator=torch.Generator()
                      .manual_seed(0))
    saved = detector.num_queries, detector.decoder_layers
    try:
        detector.num_queries, detector.decoder_layers = 16, 2
        boxes, probs = detector.forward(imgs)
    finally:
        detector.num_queries, detector.decoder_layers = saved
    assert boxes.shape == (1, 16, 4) and probs.shape == (1, 16, 80)
    with torch.no_grad():
        want = detector.model(imgs, num_queries=16, decoder_layers=2)
    assert torch.equal(want[0], boxes) and torch.equal(want[1], probs)


def _call_order_scales(det, frames):
    order = []
    hooks = [m.register_forward_hook(lambda m, i, o: order.append(m))
             for m in quant.qconvs(det.model)]
    det.infer_batch(frames)
    for h in hooks:
        h.remove()
    return np.array([float(m.a_scale) for m in order], np.float32)


def test_int8_matches_jax_int8():
    """Backbone and encoder convs quantised, the decoder float, against
    the JAX int8 detector (one decoder layer: the quantised part is the
    same, the JAX compile shorter): dynamic scales, then each package's
    ``calibrate_int8`` on the same two frames."""
    cfg = dict(CFG, compute_dtype="int8", decoder_layers=1)
    frames, calib = _road(72, 48, 1), _road(72, 48, 2, seed=3)
    jdet = RTDETRJax(dict(cfg, compute_dtype="float32"))
    stem = jdet.params["backbone"]["stem"]
    key = sorted(stem)[0]
    for k, v in quantize_params_np({key: stem[key]})[key].items():
        np.testing.assert_array_equal(
            np.asarray(v), np.asarray(jquant.quantize_conv(stem[key])[k]))
    jdet.params = dict(jdet.params,
                       backbone=quantize_params_np(jdet.params["backbone"]),
                       enc=quantize_params_np(jdet.params["enc"]))
    jdet.int8 = True
    jdet._jit_cache.clear()
    want = jdet.infer_batch(frames)
    det = RTDETRTorch(cfg, device="cpu")
    convs = quant.qconvs(det.model)
    assert len(convs) == len(quant.qconvs(det.model.backbone)) \
        + len(quant.qconvs(det.model.enc))
    assert not quant.qconvs(det.model.dec)
    assert {m.act for m in convs} == {None, "relu", "silu"}
    _same_batch(want, det.infer_batch(frames), 1e-4, 1e-5)
    baked = []
    assign = jquant.assign_scales

    def record(fwd, params, scales, imgs):
        baked.append(np.asarray(scales, np.float32))
        # JAX's assignment pass, traced instead of run eagerly: tracing a
        # forward that closes over the live param dicts visits them in
        # the same execution order and bakes the same a_scale leaves
        # (33 s eagerly on the CPU, ~2 s traced)
        return assign(lambda p, x: jax.jit(lambda y: fwd(p, y)).lower(x),
                      params, scales, imgs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant, "assign_scales", record)
        n = jdet.calibrate_int8(calib)
    assert det.calibrate_int8(calib) == n == len(convs)
    assert quant.has_static_scales(det.model)
    # each conv's scale, the port's in call order against the ones JAX
    # baked in execution order
    jscales, = baked
    gap = np.abs(_call_order_scales(det, frames) / jscales - 1).max()
    assert gap <= 2e-6, gap
    _same_batch(jdet.infer_batch(frames), det.infer_batch(frames), 1e-4, 1e-5)


def test_int8_auto_calibration_from_config():
    det = RTDETRTorch(dict(CFG, compute_dtype="int8", int8_calibration=1,
                           imgsz=64), device="cpu")
    frames = torch.from_numpy(_road(72, 48, 1))
    det.run(frames)
    assert det._calib_left == 0 and quant.has_static_scales(det.model)


def test_registry_dispatch_and_set_params(tmp_path):
    """By name (random init, seeded) and by content (a renamed .npz);
    ``set_params`` takes nc and names from the tree."""
    det = build_detector({"model": "rtdetr-l.pt", "imgsz": 64},
                         device="cpu", seed=1)
    assert isinstance(det, RTDETRTorch) and not det.loaded
    renamed = tmp_path / "mystery.npz"
    shutil.copy(NPZ, renamed)
    det2 = build_detector({"model": str(renamed)}, device="cpu")
    assert isinstance(det2, RTDETRTorch) and det2.loaded and det2.nc == 80
    assert det2.names[2] == "car"
    det.set_params(T.tree_from_model(T.random_model(5, seed=2)))
    assert det.nc == 5 and det.names[2] == "2"
    dets = det.infer(_road(72, 48, 1)[0])
    assert all(0 <= d.cls_id < 5 for d in dets)


def test_export_tool_roundtrip(tmp_path):
    """``tools/export.py``: RT-DETR to ``.npz`` only, read back equal by
    both packages; ONNX and overwriting the input are refused."""
    from roadvision_tpu_torch.models.yolo import weights as tweights
    from roadvision_tpu_torch.tools.export import main
    out = tmp_path / "rtdetr-l.out.npz"
    assert main(["--weights", NPZ, "--format", "npz",
                 "--out", str(out)]) == 0
    want, _, _ = T.load_params_rtdetr(NPZ)
    for loader in (T.load_params_rtdetr, J.load_params_rtdetr):
        got, nc, loaded = loader(str(out))
        assert loaded and nc == 80
        gf, wf = tweights.flatten_tree(got), tweights.flatten_tree(want)
        assert sorted(gf) == sorted(wf)
        for k in wf:
            np.testing.assert_array_equal(np.asarray(gf[k]), wf[k])
    assert main(["--weights", NPZ, "--format", "onnx",
                 "--out", str(tmp_path / "x.onnx")]) == 2
    assert main(["--weights", str(out), "--format", "npz",
                 "--out", str(out)]) == 2
    assert main(["--weights", str(tmp_path / "rtdetr-absent.pt"),
                 "--format", "npz"]) == 2


def test_rtdetr_demo_config_through_preview(tmp_path):
    """The shipped ``configs/rtdetr_demo.yaml`` through the port's preview
    CLI on the CPU: 8 frames recorded."""
    from roadvision_tpu_torch.tools import preview
    avi = tmp_path / "rtdetr.avi"
    rc = preview.main(["--config", str(ROOT / "configs" / "rtdetr_demo.yaml"),
                       "--max-frames", "8", "--no-show", "--record", str(avi),
                       "--device", "cpu"])
    assert rc == 0
    data = avi.read_bytes()
    assert data[:4] == b"RIFF" and data.count(b"\xff\xd8\xff") == 8
