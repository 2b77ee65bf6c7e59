"""The port's YOLOv5, segment, pose and obb training against the JAX
package (CPU, float32).

Per family one batch of the task's synthetic scenes (96², two images)
and one tree go through JAX's jitted ``make_train_step_*`` (compiled once
per family in a module fixture) and the port's step: loss and components
rtol 1e-4, foreground counts exact, gradients (the momentum after one
step from zero) per leaf max |Δ| ≤ 1e-3 · max |g_leaf| + 1e-6, parameters
after the step atol 1e-6. The trees are the repo's trained v5n, and for
the heads the trained v8n's weights wherever a head shares them (the rest
seeded): a random class head puts every anchor within 1e-4 of the prior,
where the assignment would be decided by float ties. The assignments are
held exact: v5's positives per level, the seg / pose top-K anchors
(``lax.top_k`` indices, ties in index order), obb's rotated ``fg`` and
``target_gt``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models.yolo import train_obb as jobb
from roadvision_tpu.models.yolo import train_pose as jpose
from roadvision_tpu.models.yolo import train_seg as jseg
from roadvision_tpu.models.yolo import train_v5 as jv5
from roadvision_tpu_torch.detect import dataset as tds
from roadvision_tpu_torch.models.rtdetr import topk_stable
from roadvision_tpu_torch.models.yolo import train as ttrain
from roadvision_tpu_torch.models.yolo import train_obb as tobb
from roadvision_tpu_torch.models.yolo import train_pose as tpose
from roadvision_tpu_torch.models.yolo import train_seg as tseg
from roadvision_tpu_torch.models.yolo import train_v5 as tv5
from roadvision_tpu_torch.models.yolo import weights as tw
from roadvision_tpu_torch.models.yolo.yolov5 import ANCHORS, STRIDES

from tests.test_torch_train import (LOSS_RTOL, assert_grads_close,
                                    assert_params_close, jcopy, jnumpy,
                                    port_model, to_torch)

LR = 1e-2
IMGSZ = 96


def trained_task_tree(task: str, nc: int):
    """A seeded v8n ``task`` tree with the trained v8n's weights wherever
    the shapes allow (the single pose class takes the car row, the 15
    obb classes the first 15 rows)."""
    trained = tw.flatten_tree(tw.import_npz(
        "assets/yolov8n_synthetic_256.npz"))
    tree = tw.flatten_tree(tw.tree_from_model(
        tw.random_model("v8", task, "n", nc, seed=0)))
    rows = {1: [2], 15: list(range(15)), 80: list(range(80))}[nc]
    for k, v in tree.items():
        if k not in trained:
            continue
        t = trained[k]
        if t.shape != v.shape:
            final = ".cv3." in k and k.rsplit(".", 2)[1] == "2"
            t = t[tuple(rows if final and d == t.ndim - 1 else slice(0, n)
                        for d, n in enumerate(v.shape))]
        tree[k] = t
    return tw.unflatten_tree(tree)


FAMILIES = {
    # name: (tree, nc, batch generator, JAX step factory, port loss)
    "v5": (lambda: tw.import_npz("assets/yolov5n_synthetic_256.npz"), 80,
           tds.synthetic_batches,
           lambda nc: jv5.make_train_step_v5("n", nc, lr=LR),
           tv5.detection_loss_v5),
    "seg": (lambda: trained_task_tree("segment", 80), 80,
            tds.synthetic_seg_batches,
            lambda nc: jseg.make_train_step_seg("n", nc, lr=LR),
            tseg.segmentation_loss),
    "pose": (lambda: trained_task_tree("pose", 1), 1,
             tds.synthetic_pose_batches,
             lambda nc: jpose.make_train_step_pose("n", nc, lr=LR),
             tpose.pose_loss),
    "obb": (lambda: trained_task_tree("obb", 15), 15,
            tds.synthetic_obb_batches,
            lambda nc: jobb.make_train_step_obb("n", nc, lr=LR),
            tobb.obb_loss),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def case(request):
    tree_fn, nc, gen, jfactory, loss_fn = FAMILIES[request.param]
    tree = tree_fn()
    batch = next(gen(2, imgsz=IMGSZ, seed=3))
    x = jnp.asarray(batch[0], jnp.float32) / 255.0
    p1, m1, loss1, aux1 = jfactory(nc)(
        jcopy(tree), jax.tree_util.tree_map(jnp.zeros_like, jcopy(tree)),
        x, *(jnp.asarray(g) for g in batch[1:]))
    model = port_model(tree)
    mom = ttrain.init_momentum(model)
    loss, aux = ttrain.make_train_step(loss_fn, lr=LR)(model, mom,
                                                       *to_torch(batch))
    return dict(name=request.param, tree=tree, batch=batch,
                want=(jnumpy(p1), jnumpy(m1), float(loss1),
                      {k: float(v) for k, v in aux1.items()}),
                got=(model, mom, float(loss),
                     {k: float(v) for k, v in aux.items()}))


def test_loss_and_components_match_jax(case):
    _, _, loss, aux = case["got"]
    _, _, want_loss, want_aux = case["want"]
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    for k, v in want_aux.items():
        if k == "num_fg":
            assert aux[k] == v > 0
        else:
            np.testing.assert_allclose(aux[k], v, rtol=LOSS_RTOL, err_msg=k)


def test_gradients_match_jax(case):
    assert_grads_close(case["want"][1], tw.tree_from_state_dict(
        case["got"][1]))


def test_params_after_one_step_match_jax(case):
    assert_params_close(case["want"][0], tw.tree_from_model(case["got"][0]))


def test_v5_positives_match_jax():
    """``_level_targets`` per level: the positive mask and cells exact."""
    _, gb, _, gm = next(tds.synthetic_batches(4, imgsz=IMGSZ, seed=11))
    positives = 0
    for lvl, stride in enumerate(STRIDES):
        hw = (IMGSZ // stride, IMGSZ // stride)
        anchors = ANCHORS[lvl] / float(stride)
        want = jax.jit(jv5._level_targets, static_argnums=3)(
            gb / stride, gm, anchors, hw)
        got = tv5._level_targets(torch.from_numpy(gb / stride),
                                 torch.from_numpy(gm),
                                 torch.from_numpy(anchors), hw)
        positives += int(got[0].sum())
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(got[3:], want[3:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
    assert positives > 0


def test_top_k_anchors_match_lax_top_k():
    """The seg / pose top-K pick on the trained model's assignment
    weights (most of them 0: ties everywhere past the foreground) is
    ``lax.top_k``'s, index for index."""
    model = port_model(trained_task_tree("segment", 80))
    imgs, gb, gc, gm, _ = to_torch(next(tds.synthetic_seg_batches(
        2, imgsz=IMGSZ, seed=12)))
    with torch.no_grad():
        _, outs = model.features_and_head(imgs)
        t = ttrain.detection_terms(outs, model.nc, gb, gc, gm)[-1]
    weight = t["weight"]
    assert 0 < int((weight > 0).sum()) < 64
    for k in (64, 10, weight.shape[1]):
        vals, idx = tseg.top_foreground(weight, k)
        wv, wi = jax.lax.top_k(weight.numpy(), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
    x = torch.tensor([[3.0, 1.0, 3.0, 0.0, 1.0, 3.0]])
    np.testing.assert_array_equal(topk_stable(x, 4).numpy(),
                                  np.asarray(jax.lax.top_k(x.numpy(), 4)[1]))


def test_rotated_assignment_matches_jax():
    model = port_model(trained_task_tree("obb", 15))
    imgs, grb, gc, gm = to_torch(next(tds.synthetic_obb_batches(
        2, imgsz=IMGSZ, seed=13)))
    with torch.no_grad():
        feats, outs = model.features_and_head(imgs)
        box, cls, pts, strides, hw = ttrain.head_logits(outs, model.nc)
        angle = (torch.sigmoid(tseg.head_rows(model, feats)[..., 0])
                 - 0.25) * np.pi
        from roadvision_tpu_torch.models.yolo.yolov8_obb import decode_rbox
        rb = decode_rbox(box, angle, hw)
        scores = torch.sigmoid(cls)
        anchors = pts * strides[:, None]
        got = tobb.task_aligned_assign_rotated(scores, rb, anchors, grb, gc,
                                               gm)
    want = jax.jit(jobb.task_aligned_assign_rotated)(
        scores.numpy(), rb.numpy(), anchors.numpy(), grb.numpy(),
        gc.numpy(), gm.numpy())
    assert got[0].sum() > 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_obb_gradient_is_finite_at_degenerate_boxes():
    """Near-degenerate covariances (a 1e-3 px wide target, square boxes
    whose angle is undefined): the loss and every gradient stay finite
    where JAX's do."""
    tree = trained_task_tree("obb", 15)
    imgs, grb, gc, gm = next(tds.synthetic_obb_batches(2, imgsz=64, seed=14))
    grb = grb.copy()
    grb[0, 0, 2] = 1e-3
    grb[1, 0, 2:4] = 20.0
    batch = (imgs, grb, gc, gm)
    _, jgrads = jax.value_and_grad(
        lambda p: jobb.obb_loss(p, jnp.asarray(imgs, jnp.float32) / 255.0,
                                grb, gc, gm, size="n", nc=15)[0])(
        jcopy(tree))
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree_util.tree_leaves(jgrads))
    model = port_model(tree)
    loss, _ = tobb.obb_loss(model, *to_torch(batch))
    grads = ttrain.grads_and_norm(model, loss)[2]
    assert np.isfinite(loss.item())
    assert all(torch.isfinite(g).all() for g in grads)
