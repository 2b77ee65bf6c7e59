"""The port's task heads vs the JAX package (CPU, float32): segment
(``yolov8_seg.py`` + ``ops/masks.py::compose_masks``), pose
(``yolov8_pose.py``), obb (``yolov8_obb.py`` + ``ops/obb.py``), on the
YOLOv8 and YOLO11 bases.

The same numpy-seeded inputs and the same JAX parameter tree go through
both; each JAX forward is compiled once per module. Tolerances: model
outputs within 1e-4 (boxes and keypoints in pixels of a 96 × 128 canvas,
scores, coefficients, prototypes — float32 reduction order through
~70 convolutions; measured ≤ 9.2e-5); the ProbIoU, mask and geometry
functions within 1e-5 (elementwise float32 transcendental ulps); the
rotated NMS equal in what it keeps. The engine tests run one batch
through both ``PipelineEngine``s from the same ``.npz``: boxes and
keypoints within 1e-3 px (source pixels: the letterbox ratio scales the
canvas error up), confidences within 1e-5, masks within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models.yolo import yolov8_obb as jobb
from roadvision_tpu.models.yolo import yolov8_pose as jpose
from roadvision_tpu.models.yolo import yolov8_seg as jseg
from roadvision_tpu.ops import masks as jmasks
from roadvision_tpu.ops import obb as jops_obb
from roadvision_tpu_torch.detect.yolo_torch import YOLOTorch
from roadvision_tpu_torch.models.yolo import weights as tweights
from roadvision_tpu_torch.models.yolo import yolov8_pose as tpose
from roadvision_tpu_torch.ops import masks as tmasks
from roadvision_tpu_torch.ops import obb as tobb

from tests.oracles import torch_port

TOL = 1e-4
X = np.random.RandomState(0).rand(2, 96, 128, 3).astype(np.float32)
INIT = {"segment": (jseg.init_params_seg, jseg.forward_seg_raw, 80),
        "pose": (jpose.init_params_pose, jpose.forward_pose_raw, 1),
        "obb": (jobb.init_params_obb, jobb.forward_obb_raw, 15)}


@pytest.fixture(scope="module")
def heads():
    """Per (task, arch): a seeded tree (the port's random init, in the
    JAX layout) and the JAX forward of it on X, compiled once each."""
    out = {}
    for i, (task, (_, fwd, nc)) in enumerate(INIT.items()):
        for arch in ("v8", "11"):
            params = tweights.tree_from_model(
                tweights.random_model(arch, task, "n", nc, seed=10 + i))
            j = jax.jit(lambda p, x, fwd=fwd, nc=nc, arch=arch: fwd(
                p, x, size="n", nc=nc, arch=arch))(params, jnp.asarray(X))
            out[task, arch] = (params, [np.asarray(a) for a in j])
    return out


@pytest.mark.parametrize("task", ["segment", "pose", "obb"])
def test_random_init_tree_matches_jax_layout(task):
    """The port's seeded init gives the JAX init's tree: same keys, list
    structure and shapes (``jax.eval_shape``, nothing computed), for both
    bases; pose defaults to nc 1 and obb to 15 as in ``load_params``."""
    init, _, nc = INIT[task]
    for arch in ("v8", "11"):
        want = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), "n", nc,
                                           arch=arch))
        got, a, size, loaded = tweights.load_params(
            "no/such.pt", arch=arch, task=task)
        assert (a, size, loaded) == (arch, "n", False)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        assert [g.shape for g in jax.tree_util.tree_leaves(got)] == \
            [w.shape for w in jax.tree_util.tree_leaves(want)]
        assert tweights.describe(got) == (arch, task, "n", nc)


def _port_forward(params):
    model = tweights.model_from_params(torch_port.jax_tree(params)).eval()
    with torch.no_grad():
        return model, [t.numpy() for t in model(torch.from_numpy(X))]


@pytest.mark.parametrize("arch", ["v8", "11"])
@pytest.mark.parametrize("task", ["segment", "pose", "obb"])
def test_task_forward_matches_jax(heads, task, arch):
    params, want = heads[task, arch]
    model, got = _port_forward(params)
    assert model.task == task and model.head_key == \
        ("23" if arch == "11" else "22")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() < TOL, np.abs(g - w).max()


def test_seg_prototypes_and_widths(heads):
    """The proto branch at input/4 with nm = 32; the transposed
    convolution's kernel is the tree's HWIO (2, 2, npr, npr) as
    (npr, npr, 2, 2); head widths follow ``seg_spec``."""
    params, want = heads["segment", "v8"]
    model, got = _port_forward(params)
    assert got[3].shape == (2, 24, 32, 32)
    proto = model.layers["22"].proto
    np.testing.assert_array_equal(
        proto.up_w.detach().numpy(),
        np.asarray(params["22"]["proto"]["up_w"]).transpose(2, 3, 0, 1))
    spec = jseg.seg_spec("n", 80)
    assert proto.cv1.weight.shape[0] == spec["npr"]
    assert model.layers["22"].cv4[0][0].weight.shape[0] == spec["c4"]


def test_compose_masks_matches_jax():
    rng = np.random.RandomState(1)
    coeffs = rng.randn(2, 7, 32).astype(np.float32)
    protos = rng.randn(2, 24, 32, 32).astype(np.float32)
    xy = rng.uniform(-10, 110, (2, 7, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (2, 7, 2))],
                           -1).astype(np.float32)
    valid = rng.rand(2, 7) > 0.3
    want = np.asarray(jmasks.compose_masks(
        jnp.asarray(coeffs), jnp.asarray(protos), jnp.asarray(boxes),
        jnp.asarray(valid)))
    got = tmasks.compose_masks(*(torch.from_numpy(a) for a in (
        coeffs, protos, boxes, valid))).numpy()
    assert got.shape == want.shape == (2, 7, 24, 32)
    np.testing.assert_array_equal(got == 0, want == 0)   # the crop
    assert np.abs(got - want).max() < 1e-5


def test_pose_keypoint_decode_and_scale_match_jax():
    rng = np.random.RandomState(2)
    hw = [(4, 6), (2, 3), (1, 2)]
    raw = rng.randn(2, 32, 51).astype(np.float32)
    want = np.asarray(jpose.decode_kpts(jnp.asarray(raw), hw))
    got = tpose.decode_kpts(torch.from_numpy(raw), hw).numpy()
    assert np.abs(got - want).max() < 1e-5
    ratio, pad = np.float32(0.5), np.array([4.0, 12.0], np.float32)
    want = np.asarray(jpose.scale_kpts(jnp.asarray(got), ratio, pad,
                                       (90, 120)))
    got = tpose.scale_kpts(torch.from_numpy(got), torch.tensor(ratio),
                           torch.from_numpy(pad), (90, 120)).numpy()
    assert np.abs(got - want).max() < 1e-5


def _rboxes(rng, shape):
    c = rng.uniform(0, 200, shape + (2,))
    wh = rng.uniform(4, 60, shape + (2,))
    th = rng.uniform(-np.pi / 4, 3 * np.pi / 4, shape + (1,))
    return np.concatenate([c, wh, th], -1).astype(np.float32)


def test_rbox_geometry_matches_jax():
    rng = np.random.RandomState(3)
    rb = _rboxes(rng, (40,))
    t = torch.from_numpy(rb)
    for jf, tf in ((jops_obb.probiou_matrix, tobb.probiou_matrix),
                   (jops_obb.rbox_corners, tobb.rbox_corners),
                   (jops_obb.rbox_to_aabb, tobb.rbox_to_aabb)):
        want = np.asarray(jf(jnp.asarray(rb)))
        got = tf(t).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-4, jf.__name__
    ratio, pad = np.float32(0.75), np.array([3.0, 9.0], np.float32)
    want = np.asarray(jops_obb.scale_rboxes(jnp.asarray(rb), ratio, pad,
                                            (150, 180)))
    got = tobb.scale_rboxes(t, torch.tensor(ratio), torch.from_numpy(pad),
                            (150, 180)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep", [None, (0, 2)])
def test_rotated_nms_matches_jax(keep):
    """Clustered boxes, three classes: the same survivors in the same
    order (the exact greedy by the Jacobi fixpoint on both sides)."""
    rng = np.random.RandomState(4)
    centres = _rboxes(rng, (2, 6))
    rb = np.repeat(centres, 40, axis=1)
    rb = rb + np.concatenate([rng.normal(0, 3, rb.shape[:2] + (4,)),
                              rng.normal(0, 0.1, rb.shape[:2] + (1,))],
                             -1).astype(np.float32)
    rb[..., 2:4] = np.abs(rb[..., 2:4]) + 1
    scores = rng.rand(2, 240, 3).astype(np.float32) ** 3
    kw = dict(conf_thres=0.05, iou_thres=0.5, max_det=30, pre_topk=200,
              classes_keep=keep)
    want = [np.asarray(a) for a in jops_obb.nms_rotated_batch(
        jnp.asarray(rb), jnp.asarray(scores), **kw)]
    got = [t.numpy() for t in tobb.nms_rotated_batch(
        torch.from_numpy(rb), torch.from_numpy(scores), **kw)]
    np.testing.assert_array_equal(got[3], want[3])           # valid
    v = want[3]
    assert 0 < v.sum() < v.size
    np.testing.assert_array_equal(got[2][v], want[2][v])     # class
    np.testing.assert_array_equal(got[1][v], want[1][v])     # conf
    np.testing.assert_array_equal(got[0][v], want[0][v])     # rboxes
    one = [np.asarray(a) for a in jops_obb.nms_rotated_single(
        jnp.asarray(rb[1]), jnp.asarray(scores[1]), return_idx=True, **kw)]
    got1 = [t.numpy() for t in tobb.nms_rotated_single(
        torch.from_numpy(rb[1]), torch.from_numpy(scores[1]),
        return_idx=True, **kw)]
    v1 = one[3]
    np.testing.assert_array_equal(got1[3], v1)
    np.testing.assert_array_equal(got1[4][v1], one[4][v1])   # source index


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(5)
    return (rng.randint(0, 256, (2, 72, 120, 3)).astype(np.uint8),
            1000.0 + np.arange(2) / 30.0)


@pytest.mark.parametrize("task,arch", [("segment", "v8"), ("pose", "11"),
                                       ("obb", "v8")])
def test_engine_task_matches_jax_engine(heads, frames, tmp_path, task, arch):
    """One batch through both engines from the same ``.npz``: the 8th
    output (masks, keypoints, rboxes) reaches ``Detection``; the obb
    boxes are the AABBs of the already-scaled rboxes (scaled once)."""
    params, _ = heads[task, arch]
    model = torch_port.write_npz(params, tmp_path / f"m-{task}.npz")
    cfg = torch_port.engine_cfg(model, tracking=(task == "pose"))
    got, want = torch_port.run_engines(cfg, *frames)
    n = torch_port.assert_same_results(got, want, box_tol=1e-3,
                                       conf_tol=1e-5, extra_tol=1e-3)
    assert n > 0
    field = {"segment": "mask", "pose": "keypoints", "obb": "rbox"}[task]
    assert all(getattr(d, field) is not None
               for r in got for d in r.detections)
    if task == "obb":
        for d in got[0].detections:
            c = tobb.rbox_corners(torch.from_numpy(np.asarray(d.rbox)))
            lo, hi = c.min(0).values.numpy(), c.max(0).values.numpy()
            assert np.allclose([d.x1, d.y1], np.clip(lo, 0, [120, 72]),
                               atol=1e-4)
            assert np.allclose([d.x2, d.y2], np.clip(hi, 0, [120, 72]),
                               atol=1e-4)


def test_detector_names_tasks_and_lb_meta(heads, frames, tmp_path):
    """Task from the checkpoint's head; person-only pose and DOTA obb
    names; the segment task's letterbox meta after ``infer_batch``."""
    from roadvision_tpu.detect.yolo_jax import YOLOJax
    for (task, arch), (params, _) in heads.items():
        path = torch_port.write_npz(params, tmp_path / f"{task}{arch}.npz")
        cfg = {"model": path, "imgsz": 96, "conf_thres": 1e-4,
               "max_det": 5, "compute_dtype": "float32"}
        det = YOLOTorch(cfg, device="cpu")
        jdet = YOLOJax(dict(cfg, device="cpu"))
        assert (det.task, det.arch, det.nc, det.names) == \
            (jdet.task, jdet.arch, jdet.nc, jdet.names)
    batch = det.infer_batch(frames[0])
    assert batch.rboxes.shape == (2, 5, 5) and det.last_letterbox_meta() \
        is None
    seg = YOLOTorch(dict(cfg, model=str(tmp_path / "segmentv8.npz")),
                    device="cpu")
    b = seg.infer_batch(frames[0])
    assert b.masks.shape == (2, 5, 16, 24)
    jseg_det = YOLOJax(dict(cfg, model=str(tmp_path / "segmentv8.npz"),
                            device="cpu"))
    jb = jseg_det.infer_batch(frames[0])
    r, p = seg.last_letterbox_meta()
    jr, jp = jseg_det.last_letterbox_meta()
    assert r == pytest.approx(jr) and tuple(p) == tuple(np.asarray(jp))
    assert np.abs(b.masks - jb.masks).max() < 1e-5


def test_bench_seg_mode_rehearsal(capsys):
    """The port bench's ``seg`` mode (the JAX bench's: the pipeline with a
    random-init segment head, masks as the 8th array) at a toy size on
    the CPU: one JSON line, named as a CPU run."""
    import json
    from roadvision_tpu_torch.tools import bench
    assert bench.main(["--device", "cpu", "--res", "144", "--batch", "2",
                       "--iters", "1", "--windows", "1", "--warmup", "1",
                       "--mode", "seg", "--dtype", "float32"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "random init" in out[0]          # the head's weights are absent
    line = json.loads(out[-1])
    assert line["metric"] == "seg_144p_fps" and line["card"] is None
    assert line["device_resident_fps"]["median"] > 0
    assert set(line["stage_ms"]) == {"preprocess", "letterbox", "forward",
                                     "nms", "sort_geometry"}
