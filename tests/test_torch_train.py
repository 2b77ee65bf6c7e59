"""The port's YOLOv8 / YOLO11 training against the JAX package (CPU,
float32).

The same tree (the repo's trained ``assets/yolov8n_synthetic_256.npz``
for v8, the port's seeded init in the JAX layout for YOLO11) and the same
synthetic batch (96², two images; the port's generator is bit-equal to
JAX's, tests/test_torch_dataset.py) go through JAX's jitted
``make_train_step`` — compiled once per family in a module fixture, two
steps — and the port's step. Tolerances:

  * loss and its components: rtol 1e-4; the foreground count exact;
  * gradients, read as the momentum after one step from zero (the clip
    scale times the gradient), per leaf:
    max |Δ| ≤ 1e-3 · max |g_leaf| + 1e-6;
  * parameters after one step: atol 1e-6;
  * the assignment (``fg``, ``target_gt``) exact, its targets 1e-5.

A training state crosses both ways: JAX saves after step 1, the port
resumes and its step 2 equals JAX's; the port saves, JAX resumes and its
step equals the port's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models.yolo import train as jtrain
from roadvision_tpu.runtime import checkpoint as jckpt
from roadvision_tpu_torch.detect import dataset as tds
from roadvision_tpu_torch.models.yolo import train as ttrain
from roadvision_tpu_torch.models.yolo import weights as tw
from roadvision_tpu_torch.runtime import checkpoint as tckpt
from roadvision_tpu_torch.tools.train import lr_scale_at

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-6
LR = 1e-2
V8_NPZ = "assets/yolov8n_synthetic_256.npz"


def flat(tree):
    return {k: np.asarray(v) for k, v in tw.flatten_tree(tree).items()}


def assert_grads_close(want_tree, got_tree):
    want, got = flat(want_tree), flat(got_tree)
    assert want.keys() == got.keys()
    for k in want:
        tol = 1e-3 * np.abs(want[k]).max() + 1e-6
        assert np.abs(want[k] - got[k]).max() <= tol, k


def assert_params_close(want_tree, got_tree, atol=PARAM_ATOL):
    want, got = flat(want_tree), flat(got_tree)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def to_torch(batch):
    imgs, *gts = batch
    return (torch.from_numpy(imgs).float() / 255.0,
            *(torch.from_numpy(np.asarray(g)) for g in gts))


def jcopy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def jnumpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(tree):
    return tw.model_from_params(tree).set_compute_dtype(torch.float32)


@pytest.fixture(scope="module", params=["v8", "11"])
def case(request):
    """JAX's two steps from the tree on one batch, and the port's first."""
    arch = request.param
    if arch == "v8":
        tree, nc = tw.import_npz(V8_NPZ), 80
    else:
        nc = 4
        tree = tw.tree_from_model(tw.random_model("11", "detect", "n", nc,
                                                  seed=1))
    batch = next(tds.synthetic_batches(2, imgsz=96, seed=3))
    x = jnp.asarray(batch[0], jnp.float32) / 255.0
    jstep = jtrain.make_train_step("n", nc, lr=LR, arch=arch)
    p1, m1, loss1, aux1 = jstep(jcopy(tree),
                                jtrain.init_momentum(jcopy(tree)), x,
                                *(jnp.asarray(g) for g in batch[1:]))
    s1 = (jnumpy(p1), jnumpy(m1))
    p2, m2, loss2, _ = jstep(p1, m1, x, *(jnp.asarray(g) for g in batch[1:]))
    model = port_model(tree)
    mom = ttrain.init_momentum(model)
    loss, aux = ttrain.make_train_step(lr=LR)(model, mom, *to_torch(batch))
    return dict(arch=arch, tree=tree, batch=batch, jstep=jstep, s1=s1,
                loss1=float(loss1),
                aux1={k: float(v) for k, v in aux1.items()},
                s2=(jnumpy(p2), jnumpy(m2)), loss2=float(loss2),
                port=(model, mom, float(loss), {k: float(v) for k, v in
                                                aux.items()}))


def test_loss_and_components_match_jax(case):
    _, _, loss, aux = case["port"]
    np.testing.assert_allclose(loss, case["loss1"], rtol=LOSS_RTOL)
    for k in ("box", "cls", "dfl", "grad_norm"):
        np.testing.assert_allclose(aux[k], case["aux1"][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert aux["num_fg"] == case["aux1"]["num_fg"] > 0
    assert aux["ok"] == 1.0


def test_gradients_match_jax(case):
    _, mom, _, _ = case["port"]
    assert_grads_close(case["s1"][1], tw.tree_from_state_dict(mom))


def test_params_after_one_step_match_jax(case):
    model = case["port"][0]
    assert_params_close(case["s1"][0], tw.tree_from_model(model))


def test_jax_state_resumes_in_port(case, tmp_path):
    """JAX saves after step 1; the port loads it and its step 2 is JAX's."""
    path = jckpt.save_train_state(str(tmp_path / "s1.npz"), *case["s1"], 1,
                                  use_orbax=False)
    params, mom_tree, step = tckpt.load_train_state(path)
    assert step == 1
    model = port_model(params)
    mom = tckpt.opt_state_from_tree(mom_tree, torch.device("cpu"))
    loss, _ = ttrain.make_train_step(lr=LR)(model, mom,
                                            *to_torch(case["batch"]))
    np.testing.assert_allclose(float(loss), case["loss2"], rtol=LOSS_RTOL)
    assert_params_close(case["s2"][0], tw.tree_from_model(model))
    assert_grads_close(case["s2"][1], tw.tree_from_state_dict(mom))


def test_port_state_resumes_in_jax(case, tmp_path):
    """The port saves its step-1 state; JAX loads it bit for bit and its
    step 2 equals the port's."""
    model, mom, _, _ = case["port"]
    path = tckpt.save_train_state(tmp_path / "p1.npz", model, mom, 1)
    params, momentum, step = jckpt.load_train_state(path)
    assert step == 1
    for want, got in ((tw.tree_from_model(model), params),
                      (tw.tree_from_state_dict(mom), momentum)):
        w, g = flat(want), flat(got)
        assert w.keys() == g.keys()
        assert all(np.array_equal(w[k], g[k]) for k in w)
    batch = case["batch"]
    p2, _, loss2, _ = case["jstep"](
        jcopy(params), jcopy(momentum),
        jnp.asarray(batch[0], jnp.float32) / 255.0,
        *(jnp.asarray(g) for g in batch[1:]))
    m = port_model(tw.tree_from_model(model))
    mm = {k: v.clone() for k, v in mom.items()}
    loss, _ = ttrain.make_train_step(lr=LR)(m, mm, *to_torch(batch))
    np.testing.assert_allclose(float(loss), float(loss2), rtol=LOSS_RTOL)
    assert_params_close(jnumpy(p2), tw.tree_from_model(m))


def test_task_aligned_assign_matches_jax():
    """On the trained model's detached scores and boxes: fg and target_gt
    exact, target scores and boxes within 1e-5."""
    model = port_model(tw.import_npz(V8_NPZ))
    imgs, gb, gc, gm = to_torch(next(tds.synthetic_batches(2, imgsz=96,
                                                           seed=4)))
    with torch.no_grad():
        _, outs = model.features_and_head(imgs)
        box, cls, pts, strides, _ = ttrain.head_logits(outs, model.nc)
        boxes = ttrain.decode_boxes(box, pts, strides)
        scores = torch.sigmoid(cls)
        anchors = pts * strides[:, None]
        got = ttrain.task_aligned_assign(scores, boxes, anchors, gb, gc, gm)
    want = jax.jit(jtrain.task_aligned_assign)(
        scores.numpy(), boxes.numpy(), anchors.numpy(), gb.numpy(),
        gc.numpy(), gm.numpy())
    assert got[0].sum() > 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_ciou_and_its_gradient_match_jax():
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 60, (64, 2, 2)).astype(np.float32)
    wh = rng.uniform(2, 30, (64, 2, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)            # (64, 2, 4)
    b1, b2 = boxes[:, 0], boxes[:, 1]
    want, want_g = jax.value_and_grad(
        lambda a: jtrain.ciou(a, b2).sum())(jnp.asarray(b1))
    t1 = torch.from_numpy(b1).requires_grad_()
    got = ttrain.ciou(t1, torch.from_numpy(b2)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-6)


def test_nan_batch_leaves_params_and_momentum_unchanged():
    """A non-finite batch adds nothing to the momentum (``torch.where``,
    train.py:229-232): from zero momentum the parameters and momentum
    stay as they are; after a good step the momentum only decays by 0.9
    and the parameters take that decayed step, as the JAX step does, all
    finite."""
    nc = 4
    model = port_model(tw.tree_from_model(
        tw.random_model("v8", "detect", "n", nc, seed=2)))
    mom = ttrain.init_momentum(model)
    step = ttrain.make_train_step(lr=LR)
    batch = to_torch(next(tds.synthetic_batches(2, imgsz=64, seed=5)))
    bad = batch[0].clone()
    bad[0, 3, 5, 1] = float("nan")

    def snapshot():
        return ({k: v.clone() for k, v in model.state_dict().items()},
                {k: v.clone() for k, v in mom.items()})

    before = snapshot()
    loss, aux = step(model, mom, bad, *batch[1:])
    assert not np.isfinite(float(loss)) and not bool(aux["ok"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[0][k]), k
    for k, v in mom.items():
        assert torch.equal(v, before[1][k]), k

    step(model, mom, *batch)                  # momentum no longer zero
    before = snapshot()
    step(model, mom, bad, *batch[1:])
    lr = ttrain.f32_product(LR, 1.0)
    for k, v in mom.items():
        assert torch.equal(v, before[1][k] * 0.9), k
        assert torch.isfinite(v).all()
        assert torch.equal(model.state_dict()[k], before[0][k] - lr * v), k
    assert any(v.abs().sum() > 0 for v in mom.values())


def test_clip_scales_to_the_clip_norm():
    """With the clip far below the gradient norm, one step from zero
    momentum leaves ‖momentum‖ = clip and moves each parameter by
    lr · momentum."""
    clip = 1e-3
    model = port_model(tw.import_npz(V8_NPZ))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mom = ttrain.init_momentum(model)
    batch = to_torch(next(tds.synthetic_batches(2, imgsz=64, seed=6)))
    _, aux = ttrain.make_train_step(lr=LR, clip_norm=clip)(model, mom,
                                                           *batch)
    assert float(aux["grad_norm"]) > 100 * clip
    norm = torch.sqrt(sum((m ** 2).sum() for m in mom.values()))
    np.testing.assert_allclose(float(norm), clip, rtol=1e-4)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(before[k] - ttrain.f32_product(LR, 1.0)
                                   * mom[k], v, rtol=0, atol=1e-7)


def test_ema_matches_jax():
    nc = 4
    a = port_model(tw.tree_from_model(tw.random_model("v8", "detect", "n",
                                                      nc, seed=7)))
    b = port_model(tw.tree_from_model(tw.random_model("v8", "detect", "n",
                                                      nc, seed=8)))
    want = jtrain.make_ema_update()(jcopy(tw.tree_from_model(a)),
                                    jcopy(tw.tree_from_model(b)),
                                    jnp.int32(1234))
    ttrain.make_ema_update()(a, b, 1234)
    assert_params_close(jnumpy(want), tw.tree_from_model(a), atol=1e-7)


def test_lr_schedule():
    """``lr_scale_at`` as tools/train.py:291-299 computes it: linear
    warmup, cosine to lrf held past the horizon, or constant."""
    assert lr_scale_at(5, 100, 10) == 0.5
    assert lr_scale_at(10, 100, 10) == 1.0
    np.testing.assert_allclose(lr_scale_at(55, 100, 10), 0.01 + 0.99 * 0.5,
                               rtol=1e-12)
    assert lr_scale_at(100, 100, 10) == pytest.approx(0.01)
    assert lr_scale_at(250, 100, 10) == pytest.approx(0.01)
    assert lr_scale_at(55, 100, 10, schedule="constant") == 1.0


def test_five_steps_on_a_fixed_batch_lower_the_loss():
    model = port_model(tw.import_npz(V8_NPZ))
    mom = ttrain.init_momentum(model)
    step = ttrain.make_train_step(lr=LR)
    batch = to_torch(next(tds.synthetic_batches(2, imgsz=96, seed=9)))
    losses = [float(step(model, mom, *batch)[0]) for _ in range(6)]
    assert losses[-1] < losses[0], losses
