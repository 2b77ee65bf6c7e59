"""The port's int8 path (``models/yolo/quant.py``) vs the JAX package's.

One convolution, given equal inputs, is bit-equal to ``conv_i8`` before
the activation: the same int8 weights and scales, the same int8
activations, int32 accumulators equal exactly, and the dequantisation
rounded once as XLA's fused multiply-add rounds it. SiLU is evaluated
in f64 and rounded once (so the card and the CPU agree); against
``jax.nn.silu`` within 4 float32 ulps. Across a network such an ulp can
move an activation across a quantisation step, and a step at a tensor's
abs-max moves its whole dynamic scale, so the whole forward is held to a
stated bound on the synthetic road scene the trained yolov8n sees:
scores within 5e-5 and the boxes of anchors scoring over 0.25 within
5e-5 px (measured 4.6e-6 and 7.6e-6, the JAX weights quantised in numpy
as the eager ``quantize_params`` does: under ``jit`` XLA computes some
``w_scale`` an ulp apart, which moved them to 1.3e-4 and 1.5e-5), where
int8 itself moves them 0.07-0.10 and 0.24-0.33 px from float32 (the JAX
package's own int8-vs-float32 bounds are 0.15 and 8 px). Calibration
(an observer mode on the quantised convs) gives each conv the JAX
calibration's static scale within 1 % (measured 0.84 %, 6 of 63 exact:
the two calibrations see activations that differ by such steps, a gap
of the implementations that the weights do not cause) and the same
detections.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models.yolo import quant as jq
from roadvision_tpu.models.yolo import yolo11 as j11
from roadvision_tpu.models.yolo import yolov8 as j8
from roadvision_tpu_torch.detect.yolo_torch import YOLOTorch
from roadvision_tpu_torch.models.yolo import quant as tq
from roadvision_tpu_torch.models.yolo import weights as tweights
from roadvision_tpu_torch.models.yolo.yolov8 import Conv
from roadvision_tpu_torch.ops.letterbox import letterbox_rect_u8

from tests.oracles import torch_port
from tests.oracles.torch_port import quantize_params_np

NPZ = "assets/yolov8n_synthetic_256.npz"
BOX_TOL, SCORE_TOL = 5e-5, 5e-5


def _road(n, seed=0):
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    src = SyntheticRoadSource(160, 128, num_vehicles=5, seed=seed)
    return np.stack([src.render(i) for i in range(n)])


FRAMES = _road(4)
X = letterbox_rect_u8(torch.from_numpy(FRAMES[:2]), 160)[0].numpy()


def _conv_pair(rng, cin, cout, k, stride, groups, pad):
    w = (rng.randn(k, k, cin // groups, cout) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    conv = Conv(cin, cout, k, stride, act=False, groups=groups, pad=pad)
    conv.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    conv.bias.data = torch.from_numpy(b)
    return jq.quantize_conv({"w": jnp.asarray(w), "b": jnp.asarray(b)}), \
        tq.QConv(conv)


@pytest.mark.parametrize("cin,cout,k,stride,groups,pad", [
    (3, 16, 3, 2, 1, None),      # the v8 stem: K = 27
    (64, 255, 1, 1, 1, None),    # the v5 head: N = 255
    (32, 32, 3, 1, 32, None),    # depthwise (YOLO11 head, C2PSA's pe)
    (3, 16, 6, 2, 1, 2),         # the v5 6 × 6 stem, pad 2
    (256, 64, 3, 1, 1, None),    # K = 2304
])
def test_quantized_conv_matches_jax(cin, cout, k, stride, groups, pad):
    rng = np.random.RandomState(cin + cout + k)
    jp, q = _conv_pair(rng, cin, cout, k, stride, groups, pad)
    np.testing.assert_array_equal(
        q.w_i8.numpy(), np.asarray(jp["w_i8"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(q.w_scale.numpy(), np.asarray(jp["w_scale"]))
    x = rng.randn(2, 12, 20, cin).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    # the int32 accumulators of the same int8 activations
    a = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12) / 127.0
    x_i8 = jnp.clip(jnp.round(x / a), -127, 127).astype(jnp.int8)
    p = k // 2 if pad is None else pad
    want_acc = jax.lax.conv_general_dilated(
        x_i8, jp["w_i8"], (stride, stride), [(p, p), (p, p)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    assert float(tq.dynamic_scale(xt)) == float(a)
    got_acc = tq.int8_conv(torch.from_numpy(np.array(x_i8))
                           .permute(0, 3, 1, 2), q.w_i8, stride, p)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_acc))
    for act in (False, True):
        q.act = act
        want = np.asarray(jax.jit(lambda x, jp: jq.conv_i8(
            x, jp, stride=stride, act=act, pad=pad))(jnp.asarray(x), jp))
        got = q(xt).permute(0, 2, 3, 1).numpy()
        if not act:
            np.testing.assert_array_equal(got, want)
        else:
            ulp = np.spacing(np.abs(want).astype(np.float32))
            assert (np.abs(got - want) <= 4 * ulp).all()


def test_int8_conv_exact_where_float32_is_not():
    """All-±127 operands over K = 3·3·256: sums past 2²⁴, exact in the
    int32 path (against int64 numpy)."""
    rng = np.random.RandomState(7)
    x = np.where(rng.rand(1, 256, 6, 6) < 0.9, 127, -127).astype(np.int8)
    w = np.where(rng.rand(8, 256, 3, 3) < 0.9, 127, -127).astype(np.int8)
    got = tq.int8_conv(torch.from_numpy(x), torch.from_numpy(w), 1, 1)
    xp = np.pad(x.astype(np.int64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = np.zeros((1, 8, 6, 6), np.int64)
    for i in range(3):
        for j in range(3):
            want += np.einsum("bchw,oc->bohw", xp[:, :, i:i + 6, j:j + 6],
                              w[:, :, i, j].astype(np.int64))
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def v8():
    """The trained yolov8n: its tree, the tree quantised as the JAX
    package's eager ``quantize_params`` does (in numpy) and the jitted JAX
    forward."""
    tree = tweights.import_npz(NPZ)
    jt = quantize_params_np(jax.tree_util.tree_map(jnp.asarray, tree))
    return tree, jt, jax.jit(lambda p, x: j8.forward_raw(p, x, size="n",
                                                         nc=80))


def _held(got, want):
    """Scores within SCORE_TOL; boxes of the anchors scoring over 0.25
    within BOX_TOL."""
    assert np.abs(got[1] - want[1]).max() < SCORE_TOL
    sure = want[1].max(-1) > 0.25
    assert sure.sum() > 5
    assert np.abs(got[0] - want[0]).max(-1)[sure].max() < BOX_TOL


def test_int8_forward_matches_jax(v8):
    """The trained yolov8n on the letterboxed road frames; int8 moves its
    scores far more than the two implementations differ."""
    tree, jt, f = v8
    want = [np.asarray(a) for a in f(jt, jnp.asarray(X))]
    model = tq.quantize_model_(tweights.model_from_params(tree)).eval()
    assert not any(isinstance(m, Conv) for m in model.modules())
    with torch.no_grad():
        got = [t.numpy() for t in model(torch.from_numpy(X))]
        f32 = tweights.model_from_params(tree).eval()(torch.from_numpy(X))
    _held(got, want)
    assert np.abs(f32[1].numpy() - want[1]).max() > 30 * SCORE_TOL


def test_int8_yolo11_forward_matches_jax():
    """A seeded YOLO11n: depthwise convs and the attention quantised too
    (random scores are ~1e-4: they are what is held)."""
    tree = tweights.tree_from_model(
        tweights.random_model("11", "detect", "n", 80, seed=1))
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    want = np.asarray(jax.jit(lambda p, x: j11.forward_raw_11(
        p, x, size="n", nc=80))(quantize_params_np(jt), jnp.asarray(X))[1])
    model = tq.quantize_model_(tweights.model_from_params(tree)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(X))[1].numpy()
    assert np.abs(got - want).max() < SCORE_TOL


def test_quantize_keeps_the_float_layers():
    """Only convolutions are quantised, as ``quantize_params``: the
    segment head's transposed convolution stays float32."""
    model = tq.quantize_model_(tweights.random_model("v8", "segment", "n",
                                                     80))
    proto = model.layers["22"].proto
    assert isinstance(proto.cv1, tq.QConv) and proto.up_w.dtype == \
        torch.float32
    n = len(tq.qconvs(model))
    want = sum(1 for k in tweights.flatten_tree(tweights.tree_from_model(
        tweights.random_model("v8", "segment", "n", 80))) if k.endswith(".w"))
    assert n == want


@pytest.fixture(scope="module")
def frames():
    return FRAMES


def _execution_order(model, x):
    """The quantised convs' tree paths in the order a forward runs them
    (the order ``capture_scales`` records)."""
    names = {m: n[len("layers."):] for n, m in model.named_modules()}
    order = []
    hooks = [m.register_forward_hook(lambda m, i, o: order.append(names[m]))
             for m in tq.qconvs(model)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return order


def _set_leaf(tree, path, key, value):
    node = tree
    for k in path.split("."):
        node = node[int(k)] if isinstance(node, list) else node[k]
    node[key] = value


def test_calibration_matches_jax(v8, frames):
    """``YOLOTorch.calibrate_int8`` against the JAX calibration
    (``capture_scales`` per batch under ``jit``, running max, the scales
    baked into the tree as ``assign_scales`` does): every conv's static
    scale within 1 % (the first exactly), and the calibrated forwards'
    scores within 0.04 (measured 0.035: each side quantises with its own
    scales)."""
    tree, jt, f = v8
    det = YOLOTorch({"model": NPZ, "imgsz": 160, "conf_thres": 0.25,
                     "compute_dtype": "int8"}, device="cpu")
    capture = jax.jit(lambda p, x: jq.capture_scales(
        lambda p, x: j8.forward_raw(p, x, size="n", nc=80), p, x))
    want = None
    for i in (0, 2):
        imgs = det.letterbox(torch.from_numpy(frames[i:i + 2]))[0].numpy()
        s = np.asarray(capture(jt, jnp.asarray(imgs)))
        want = s if want is None else np.maximum(want, s)
    assert det.calibrate_int8(frames, batch_size=2) == len(want) == 63
    assert tq.has_static_scales(det.model)
    order = _execution_order(det.model, torch.from_numpy(X))
    got = {n: float(m.a_scale) for n, m in
           ((n[len("layers."):], m) for n, m in det.model.named_modules())
           if isinstance(m, tq.QConv)}
    assert sorted(order) == sorted(got)
    assert got[order[0]] == want[0]         # max |first canvas| / 127
    for name, w in zip(order, want):
        assert got[name] == pytest.approx(float(w), rel=0.01), name
    static = jax.tree_util.tree_map(lambda a: a, jt)
    for name, w in zip(order, want):
        _set_leaf(static, name, "a_scale", jnp.float32(w))
    jout = [np.asarray(a) for a in f(static, jnp.asarray(X))]
    with torch.no_grad():
        tout = [t.numpy() for t in det.model(torch.from_numpy(X))]
    # the scales differ by up to 1 %, so each side quantises with its own
    assert np.abs(tout[1] - jout[1]).max() < 0.04
    tq.clear_static_scales(det.model)
    assert not tq.has_static_scales(det.model)


def test_auto_calibration_from_config(frames):
    """``int8_calibration: 4`` bakes after four frames of ``infer_batch``
    and, in the port, of the engine's batches too (the JAX engine ignores
    the key)."""
    cfg = {"model": NPZ, "imgsz": 160, "max_det": 10,
           "compute_dtype": "int8", "int8_calibration": 4}
    det = YOLOTorch(cfg, device="cpu")
    det.infer_batch(frames[:2])
    assert not tq.has_static_scales(det.model)
    det.infer_batch(frames[2:])
    assert tq.has_static_scales(det.model)
    assert det.infer_batch(frames[:2]).boxes.shape == (2, 10, 4)
    from roadvision_tpu_torch.runtime import PipelineEngine
    eng = PipelineEngine(torch_port.engine_cfg(NPZ, **{
        "compute_dtype": "int8", "int8_calibration": 4, "imgsz": 160}),
        device="cpu")
    eng.process_batch(frames, 1000.0 + np.arange(4) / 30.0)
    assert tq.has_static_scales(eng.detector.model)
    with pytest.raises(RuntimeError, match="int8"):
        YOLOTorch({"model": NPZ, "imgsz": 64}, device="cpu") \
            .calibrate_int8(frames[:1])


def test_engine_int8_matches_jax_engine(frames):
    """Dynamic scales, the chain and SORT: one batch through both
    engines from the trained yolov8n."""
    from roadvision_tpu.runtime.engine import PipelineEngine as JEngine
    from roadvision_tpu_torch.runtime import PipelineEngine
    cfg = torch_port.engine_cfg(NPZ, chain=True, tracking=True,
                                conf_thres=0.25, imgsz=160)
    ts = 1000.0 + np.arange(2) / 30.0
    # the JAX detector's own int8 set-up (``quantize_params`` of its
    # tree; float32 around the convs), quantised in numpy as the eager
    # call does (eagerly it takes ~14 s on this CPU)
    jeng = JEngine(cfg)
    jeng.detector.params = quantize_params_np(jeng.detector.params)
    want = jeng.process_batch(frames[:2], ts)
    cfg["detect"]["compute_dtype"] = "int8"
    got = PipelineEngine(cfg, device="cpu").process_batch(frames[:2], ts)
    # with the weights quantised alike: boxes within 1e-4 px, conf 1e-5
    # (measured 7.6e-6 px and 3.0e-7; 0.10 px with the weights quantised
    # under jit)
    assert torch_port.assert_same_results(got, want, box_tol=1e-4,
                                          conf_tol=1e-5) > 0
