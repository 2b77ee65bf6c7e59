"""roadvision_tpu_torch YOLOv8 and its weights vs the JAX package (CPU).

The same parameters drive the JAX ``yolov8.forward`` and the port's
``YOLOv8`` module in float32. Tolerance, as in tests/test_torch_parity.py:
boxes within 0.05 px, scores within 2e-3 — float32 reduction-order noise
through ~60 convolutions, far below a layout or decode bug.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models.yolo import weights as jweights
from roadvision_tpu.models.yolo import yolov8 as jyolo
from roadvision_tpu_torch.detect.yolo_torch import YOLOTorch
from roadvision_tpu_torch.models.yolo import weights as tweights
from roadvision_tpu_torch.models.yolo import yolov8 as tyolo

NPZ = "assets/yolov8n_synthetic_256.npz"
BOX_TOL, SCORE_TOL = 0.05, 2e-3


def _max_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("src,hw", [("random", (128, 128)),
                                    ("npz", (96, 160))])
def test_yolov8n_forward_matches_jax(src, hw):
    if src == "npz":
        params = jweights.import_npz(NPZ)
    else:
        params = jyolo.init_params(jax.random.PRNGKey(3), "n")
    x = np.random.RandomState(0).rand(2, hw[0], hw[1], 3).astype(np.float32)
    jb, js = jyolo.forward(params, jnp.asarray(x), size="n", nc=80,
                           dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = tyolo.build_model(tree, "n", 80).eval()
    with torch.no_grad():
        tb, ts = model(torch.from_numpy(x))
    assert tuple(tb.shape) == jb.shape and tuple(ts.shape) == js.shape
    assert _max_err(tb, jb) < BOX_TOL, _max_err(tb, jb)
    assert _max_err(ts, js) < SCORE_TOL, _max_err(ts, js)


def test_npz_import_matches_jax_import():
    want = jax.tree_util.tree_map(np.asarray, jweights.import_npz(NPZ))
    got = tweights.import_npz(NPZ)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_params_from_jax_fills_every_parameter():
    tree = tweights.import_npz(NPZ)
    sd = tweights.params_from_jax(tree)
    model = tyolo.YOLOv8("n", 80)
    assert set(sd) == set(model.state_dict())
    n_params = sum(int(np.prod(v.shape)) for v in sd.values())
    assert n_params == jyolo.count_params(jweights.import_npz(NPZ))
    w = sd["layers.2.m.0.cv1.weight"].numpy()
    np.testing.assert_array_equal(
        w, tree["2"]["m"][0]["cv1"]["w"].transpose(3, 2, 0, 1))


def test_load_params_describes_checkpoint_and_random_init():
    tree, arch, size, loaded = tweights.load_params(NPZ)
    assert (arch, size, loaded) == ("v8", "n", True)
    assert tweights.describe(tree) == ("v8", "detect", "n", 80)
    tree, arch, size, loaded = tweights.load_params("no/such/yolov8n.pt")
    assert not loaded and tweights.describe(tree) == ("v8", "detect", "n",
                                                      80)
    m1 = tyolo.build_model(None, "n", 80, seed=5)
    m2 = tyolo.build_model(None, "n", 80, seed=5)
    for a, b in zip(m1.state_dict().values(), m2.state_dict().values()):
        assert torch.equal(a, b)
    det = m1.layers["22"]
    assert float(det.cv2[0][2].bias.detach()[0]) == 1.0
    assert float(det.cv3[2][2].bias.detach()[0]) == pytest.approx(
        np.log(5.0 / 80 / (640.0 / 32) ** 2))


def test_arch_spec_matches_jax():
    for size in "nsmlx":
        assert tyolo.arch_spec(size, 80) == jyolo.arch_spec(size, 80)


def test_dfl_decode_and_anchors_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 7, 64).astype(np.float32)
    np.testing.assert_allclose(
        tyolo.dfl_decode(torch.from_numpy(logits)).numpy(),
        np.asarray(jyolo.dfl_decode(jnp.asarray(logits))), atol=1e-5)
    hw = [(4, 6), (2, 3), (1, 2)]
    tp, ts = tyolo.anchor_points(hw, torch.device("cpu"))
    jp, js = jyolo.anchor_points(hw)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_detector_bf16_on_cpu_runs_float32():
    det = YOLOTorch({"model": NPZ, "compute_dtype": "bfloat16",
                     "imgsz": 96}, device="cpu")
    assert det.dtype == torch.float32 and det.nc == 80 and det.loaded
    frames = np.random.RandomState(2).randint(0, 256, (1, 96, 96, 3),
                                              dtype=np.uint8)
    boxes, conf, cls_id, valid, extra = det.run(torch.from_numpy(frames))
    assert boxes.shape == (1, 100, 4) and conf.shape == valid.shape
    assert boxes.dtype == torch.float32 and extra is None


@pytest.mark.parametrize("over,err", [
    ({"model": "yolov5n.pt", "task": "segment"}, ValueError),
    ({"model": "yolo11n-pose.pt", "tta": True}, ValueError),
    ({"model": "yolov8n-seg.pt", "tiling": {"enable": True}}, ValueError),
    ({"model": "yolov5n.pt", "task": "pose"}, ValueError),
    ({"tta": True, "tiling": {"enable": True}}, ValueError),
    ({"tta": True, "imgsz": 72}, ValueError),
    ({"model": "yolov5n.pt", "task": "obb"}, ValueError),
    ({"task": "pose", "tiling": {"enable": True}}, ValueError),
], ids=[f"over{i}" for i in range(8)])
def test_detector_refuses_what_is_not_ported(over, err):
    """The JAX detector's own invalid combinations, refused with its
    messages (RT-DETR, refused here before it was ported, has its own
    backend: tests/test_torch_rtdetr_backend.py)."""
    cfg = {"model": "yolov8n.pt", "imgsz": 64}
    cfg.update(over)
    with pytest.raises(err):
        YOLOTorch(cfg, device="cpu")
