"""The port's YOLOv5, YOLO11 and YOLOv8-cls vs the JAX package (CPU,
float32).

The same seeded tree (the port's random init in the JAX layout, or the
repo's trained ``assets/yolov5n_synthetic_256.npz``) and the same
numpy-seeded inputs go through the JAX forward and the port's module;
each JAX forward is compiled once per module. Boxes and scores within
1e-4 (pixels of a 96 × 128 canvas; float32 reduction order through
~60-90 convolutions and YOLO11's attention; measured ≤ 6.1e-5), the
classifier's logits within 1e-5. The detectors run end to end against
``YOLOJax`` and the engines against the JAX engine, as in
tests/test_torch_tasks.py; ``synthetic_demo_v5.yaml`` runs through the
port's preview CLI on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models.yolo import yolo11 as j11
from roadvision_tpu.models.yolo import yolov5 as j5
from roadvision_tpu.models.yolo import yolov8_cls as jcls
from roadvision_tpu_torch.detect.yolo_torch import YOLOTorch
from roadvision_tpu_torch.models.yolo import weights as tweights
from roadvision_tpu_torch.models.yolo import yolo11 as t11
from roadvision_tpu_torch.models.yolo import yolov5 as t5
from roadvision_tpu_torch.models.yolo import yolov8_cls as tcls

from tests.oracles import torch_port

TOL = 1e-4
V5_NPZ = "assets/yolov5n_synthetic_256.npz"
X = np.random.RandomState(0).rand(2, 96, 128, 3).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    """Per family: the tree and the JAX forward of it on X."""
    out = {}
    for name, tree, fwd in (
            ("v5", tweights.import_npz(V5_NPZ),
             lambda p, x: j5.forward_raw(p, x, size="n", nc=80)),
            ("v5-random", tweights.tree_from_model(
                tweights.random_model("v5", "detect", "n", 80, seed=5)),
             lambda p, x: j5.forward_raw(p, x, size="n", nc=80)),
            ("11", tweights.tree_from_model(
                tweights.random_model("11", "detect", "n", 80, seed=1)),
             lambda p, x: j11.forward_raw_11(p, x, size="n", nc=80))):
        want = jax.jit(fwd)(tree, jnp.asarray(X))
        out[name] = (tree, [np.asarray(a) for a in want])
    return out


@pytest.mark.parametrize("name", ["v5", "v5-random", "11"])
def test_forward_matches_jax(nets, name):
    tree, want = nets[name]
    model = tweights.model_from_params(tree).eval()
    with torch.no_grad():
        got = [t.numpy() for t in model(torch.from_numpy(X))]
    # the trained v5's boxes: wh = (2σ)² · anchor, anchors up to 373 px,
    # where a float32 ulp is 3e-5 px — 5e-4 px is ~16 ulps (measured
    # 1.8e-4); every other output within TOL
    box_tol = 5e-4 if name == "v5" else TOL
    for g, w, tol in zip(got, want, (box_tol, TOL)):
        assert g.shape == w.shape
        assert np.abs(g - w).max() < tol, np.abs(g - w).max()


def test_arch_specs_match_jax():
    for size in "nsmlx":
        assert t5.arch_spec(size, 80) == j5.arch_spec(size, 80)
        assert t11.arch_spec_11(size, 80) == j11.arch_spec_11(size, 80)
        assert tcls.cls_spec(size, 10) == jcls.cls_spec(size, 10)


@pytest.mark.parametrize("arch,task,init", [
    ("v5", "detect", lambda: j5.init_params(jax.random.PRNGKey(0), "n", 80)),
    ("11", "detect",
     lambda: j11.init_params_11(jax.random.PRNGKey(0), "n", 80)),
    ("v8", "classify",
     lambda: jcls.init_params_cls(jax.random.PRNGKey(0), "n", 10))])
def test_random_init_tree_matches_jax_layout(arch, task, init):
    """Same keys, list structure and shapes as the JAX init
    (``jax.eval_shape``), v5's 6 × 6 stem and anchored head, YOLO11's
    (3, 3, 1, C) depthwise kernels; the v5 head biases as JAX's."""
    want = jax.eval_shape(init)
    nc = 10 if task == "classify" else 80
    got = tweights.tree_from_model(tweights.random_model(arch, task, "n",
                                                         nc, seed=0))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert [g.shape for g in jax.tree_util.tree_leaves(got)] == \
        [w.shape for w in jax.tree_util.tree_leaves(want)]
    assert tweights.describe(got) == (arch, task, "n", nc)
    if arch == "v5":     # yolov5.py:106-110
        b = got["24"]["m"][1]["b"].reshape(3, 85)
        np.testing.assert_array_equal(
            b[:, 4], np.float32(np.log(8.0 / (640.0 / 16) ** 2)))
        np.testing.assert_array_equal(
            b[:, 5:], np.float32(np.log(0.6 / (80 - 0.99))))


def test_depthwise_groups_inferred_from_the_kernel(nets):
    """No group count is stored: the (C, 1, 3, 3) kernels of YOLO11's
    head and positional encoding run depthwise because the input is C
    wide, as ``_conv`` infers ``feature_group_count``."""
    tree, _ = nets["11"]
    model = tweights.model_from_params(tree)
    dw = model.layers["23"].cv3[0][0].dw
    pe = model.layers["10"].m[0].attn.pe
    assert dw.weight.shape[1] == 1 and pe.weight.shape[1] == 1
    assert not hasattr(dw, "groups") and not hasattr(pe, "groups")
    x = torch.from_numpy(np.random.RandomState(1).rand(1, dw.weight.shape[0],
                                                       5, 7)
                         .astype(np.float32))
    want = torch.nn.functional.conv2d(
        x, dw.weight, None, 1, 1, 1, dw.weight.shape[0]) \
        + dw.bias[:, None, None]
    assert torch.allclose(dw(x), torch.nn.functional.silu(want))


def _cls_state_dict(tree):
    """A tree → the ultralytics -cls names, conv biases unfused."""
    sd = {}
    for key, arr in tweights.flatten_tree(tree).items():
        stem, leaf = key.rsplit(".", 1)
        if leaf == "w":
            sd[f"model.{stem}.conv.weight"] = torch.from_numpy(
                arr.transpose(3, 2, 0, 1).copy())
        elif leaf == "b":
            sd[f"model.{stem}.conv.bias"] = torch.from_numpy(arr.copy())
    sd["model.9.linear.weight"] = torch.from_numpy(
        tree["9"]["lin_w"].T.copy())
    sd["model.9.linear.bias"] = torch.from_numpy(tree["9"]["lin_b"].copy())
    return sd


def test_cls_forward_and_predict_match_jax(tmp_path):
    params = tweights.tree_from_model(
        tweights.random_model("v8", "classify", "n", 10, seed=2))
    x = X[:, :96, :96]
    want = np.asarray(jax.jit(lambda p, x: jcls.forward_cls_raw(
        p, x, size="n", nc=10))(params, jnp.asarray(x)))
    model = tweights.model_from_params(params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    assert got.shape == (2, 10)
    assert np.abs(got - want).max() < 1e-5
    # the predict surface: centre crop, antialiased resize, softmax
    frames = np.random.RandomState(3).randint(0, 256, (2, 90, 150, 3),
                                              dtype=np.uint8)
    # both load one -cls .pt state dict (torch.load, weights_only)
    torch.save(_cls_state_dict(params), tmp_path / "yolov8n-cls.pt")
    cfg = {"model": str(tmp_path / "yolov8n-cls.pt"), "imgsz": 64}
    jp = jcls.YOLOCls(cfg)
    tp = tcls.YOLOCls(cfg, device="cpu")
    assert (tp.loaded, tp.size, tp.nc) == (jp.loaded, jp.size, jp.nc) == \
        (True, "n", 10)
    jid, jprobs = jp.predict(frames)
    tid, tprobs = tp.predict(frames)
    assert tprobs.shape == (2, 10)
    np.testing.assert_array_equal(tid, jid)
    assert np.abs(tprobs - jprobs).max() < 1e-4


def test_detectors_match_yolojax(nets, tmp_path):
    """``infer_batch`` of v5 (the trained asset, conf 0.5 as the v5 demo)
    and YOLO11 against ``YOLOJax`` on the same frames."""
    from roadvision_tpu.detect.yolo_jax import YOLOJax
    frames = np.random.RandomState(4).randint(0, 256, (2, 80, 128, 3),
                                              dtype=np.uint8)
    v11 = torch_port.write_npz(nets["11"][0], tmp_path / "yolo11n.npz")
    for model, conf in ((V5_NPZ, 0.05), (v11, 1e-4)):
        cfg = {"model": model, "imgsz": 128, "conf_thres": conf,
               "max_det": 20, "compute_dtype": "float32"}
        det = YOLOTorch(cfg, device="cpu")
        jdet = YOLOJax(dict(cfg, device="cpu"))
        assert (det.arch, det.size, det.nc, det.loaded) == \
            (jdet.arch, jdet.size, jdet.nc, jdet.loaded)
        got, want = det.infer_batch(frames), jdet.infer_batch(frames)
        np.testing.assert_array_equal(got.valid, want.valid)
        assert want.valid.sum() > 0
        v = want.valid
        np.testing.assert_array_equal(got.cls_id[v], want.cls_id[v])
        assert np.abs(got.boxes[v] - want.boxes[v]).max() < 1e-3
        assert np.abs(got.conf[v] - want.conf[v]).max() < 1e-5


def test_v5_engine_matches_jax_engine():
    """The v5 demo's chain and tracker: one batch through both engines."""
    frames = np.random.RandomState(6).randint(0, 256, (2, 80, 128, 3),
                                              dtype=np.uint8)
    cfg = torch_port.engine_cfg(V5_NPZ, chain=True, tracking=True,
                                conf_thres=0.05, imgsz=128)
    got, want = torch_port.run_engines(cfg, frames,
                                       1000.0 + np.arange(2) / 30.0)
    assert torch_port.assert_same_results(got, want, box_tol=1e-3,
                                          conf_tol=1e-5) > 0


def test_v5_demo_config_through_the_preview_cli(tmp_path):
    """``configs/synthetic_demo_v5.yaml`` with ``--device cpu``: the
    anchored v5 checkpoint finds and tracks cars in the recording."""
    from roadvision_tpu_torch.tools import preview
    avi = tmp_path / "demo_v5.avi"
    rc = preview.main(["--config", "configs/synthetic_demo_v5.yaml",
                       "--max-frames", "8", "--no-show", "--record",
                       str(avi), "--device", "cpu"])
    assert rc == 0
    data = avi.read_bytes()
    assert data[:4] == b"RIFF" and data.count(b"\xff\xd8\xff") == 8
    from roadvision_tpu_torch.config import load_config
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.io_video import VideoSource
    cfg = load_config("configs/synthetic_demo_v5.yaml")
    eng = PipelineEngine(cfg, device="cpu")
    assert (eng.detector.arch, eng.detector.loaded) == ("v5", True)
    src = VideoSource("synthetic:4", 256, 256)
    frames, ts, _ = src.read_batch(8)
    dets = [d for r in eng.process_batch(frames, ts) for d in r.detections]
    assert dets and {d.cls_name for d in dets} == {"car"}
