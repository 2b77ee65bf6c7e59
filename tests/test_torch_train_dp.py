"""The port's data × tensor-parallel train step (``parallel/data.py``) and
``tools/train.py --dp`` against the port's single-device step and JAX's
jitted step (CPU, float32).

The mesh is ``{data: 4, model: 2}`` over ``["cpu"] * 8`` (JAX's test of
the sharded step uses the same over its 8 virtual devices): four
replicas, one image each, every conv the JAX rule splits column-parallel
over two entries. Each batch is uneven on purpose: its last two images
keep one gt and none, so every batch-global normaliser (the target score
sum, v5's positives, objectness cells and batch size, seg's selected
foreground, RT-DETR's gt count) differs between the replicas, and a step
that took any of them per replica would be off by far more than the
tolerances (each test shows that too).

Tolerances, the dp × tp step against the port's single-device step and
against JAX's unsharded step: JAX's for its sharded step
(``tests/test_train_parallel.py``): loss rtol 1e-5, ``num_fg`` exact,
every parameter and momentum leaf rtol 2e-4, atol 2e-6. RT-DETR's AdamW
as tests/test_torch_rtdetr_train.py compares it: its first step is
≈ lr · sign(g), so where g is float noise only |Δp| ≤ 2 · lr is held.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models import rtdetr as jrtdetr
from roadvision_tpu.models import rtdetr_train as jrt
from roadvision_tpu.models.yolo import train as jtrain
from roadvision_tpu.models.yolo import train_seg as jseg
from roadvision_tpu.models.yolo import train_v5 as jv5
from roadvision_tpu_torch.detect import dataset as tds
from roadvision_tpu_torch.models import rtdetr as trtdetr
from roadvision_tpu_torch.models import rtdetr_train as trt
from roadvision_tpu_torch.models.yolo import train as ttrain
from roadvision_tpu_torch.models.yolo import weights as tw
from roadvision_tpu_torch.models.yolo.train_obb import obb_loss
from roadvision_tpu_torch.models.yolo.train_pose import pose_loss
from roadvision_tpu_torch.models.yolo.train_seg import segmentation_loss
from roadvision_tpu_torch.models.yolo.train_v5 import detection_loss_v5
from roadvision_tpu_torch.parallel import (DataParallelStep, make_mesh,
                                           merge_shards)
from roadvision_tpu_torch.runtime import checkpoint as tckpt
from roadvision_tpu_torch.tools import train as train_tool

from tests.test_torch_rtdetr_train import (assert_adamw_params_close,
                                           assert_rtdetr_grads_close,
                                           seeded_model)
from tests.test_torch_train import jcopy, jnumpy, port_model, to_torch
from tests.test_torch_train_tasks import trained_task_tree

LR = 1e-3
DP_LOSS_RTOL = 1e-5
DP_RTOL, DP_ATOL = 2e-4, 2e-6
IMGSZ = 64


def uneven(batch):
    """The last two images keep one gt and none."""
    imgs, boxes, cls, mask, *extra = batch
    mask = mask.copy()
    keep = np.flatnonzero(mask[2])[:1]
    mask[2] = False
    mask[2, keep] = True
    mask[3] = False
    return (imgs, boxes, cls, mask, *extra)


FAMILIES = {
    # name: (tree, batch, JAX step, port step)
    "v8": (lambda: tw.import_npz("assets/yolov8n_synthetic_256.npz"),
           lambda: next(tds.synthetic_batches(4, imgsz=IMGSZ, seed=3)),
           lambda: jtrain.make_train_step("n", 80, lr=LR),
           lambda: ttrain.make_train_step(lr=LR)),
    "v5": (lambda: tw.import_npz("assets/yolov5n_synthetic_256.npz"),
           lambda: next(tds.synthetic_batches(4, imgsz=IMGSZ, seed=3)),
           lambda: jv5.make_train_step_v5("n", 80, lr=LR),
           lambda: ttrain.make_train_step(detection_loss_v5, lr=LR)),
    "seg": (lambda: trained_task_tree("segment", 80),
            lambda: next(tds.synthetic_seg_batches(4, imgsz=IMGSZ, seed=3)),
            lambda: jseg.make_train_step_seg("n", 80, lr=LR),
            lambda: ttrain.make_train_step(segmentation_loss, lr=LR)),
}


def state_tree(state):
    return tw.tree_from_state_dict(merge_shards(state))


@pytest.fixture(scope="module", params=list(FAMILIES))
def case(request):
    tree_fn, batch_fn, jfactory, tfactory = FAMILIES[request.param]
    tree, batch = tree_fn(), uneven(batch_fn())
    x = jnp.asarray(batch[0], jnp.float32) / 255.0
    p1, m1, loss1, aux1 = jfactory()(
        jcopy(tree), jax.tree_util.tree_map(jnp.zeros_like, jcopy(tree)),
        x, *(jnp.asarray(g) for g in batch[1:]))
    step = tfactory()
    single = port_model(tree)
    mom = step.init(single)
    loss, aux = step(single, mom, *to_torch(batch))
    dp = DataParallelStep(step, port_model(tree),
                          make_mesh(8, model_parallel=2, device="cpu"))
    dloss, daux = dp(*to_torch(batch))
    # each replica normalising by its own image alone
    with torch.no_grad():
        per_replica = [float(step.loss_fn(port_model(tree), *(
            t[i:i + 1] for t in to_torch(batch)))[0]) for i in range(4)]
    return dict(jax=(jnumpy(p1), jnumpy(m1), float(loss1),
                     {k: float(v) for k, v in aux1.items()}),
                single=(single, mom, float(loss),
                        {k: float(v) for k, v in aux.items()}),
                dp=(dp, float(dloss), {k: float(v) for k, v in
                                       daux.items()}),
                naive=sum(per_replica) / 4)


def assert_leaves_close(want_tree, got_tree):
    want, got = tw.flatten_tree(want_tree), tw.flatten_tree(got_tree)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=DP_RTOL,
                                   atol=DP_ATOL, err_msg=k)


def test_dp_tp_step_matches_single_device(case):
    single, mom, loss, aux = case["single"]
    dp, dloss, daux = case["dp"]
    np.testing.assert_allclose(dloss, loss, rtol=DP_LOSS_RTOL)
    for k, v in aux.items():
        if k in ("num_fg", "ok"):
            assert daux[k] == v, k
        else:
            np.testing.assert_allclose(daux[k], v, rtol=DP_LOSS_RTOL,
                                       err_msg=k)
    assert aux["num_fg"] > 0
    assert_leaves_close(tw.tree_from_model(single), tw.tree_from_state_dict(
        merge_shards(dp.model.state_dict())))
    assert_leaves_close(tw.tree_from_state_dict(mom), state_tree(dp.state))


def test_per_replica_normalisers_would_differ(case):
    """The batch is uneven enough: averaging the replicas' own losses
    misses the single-device loss by far more than DP_LOSS_RTOL."""
    loss = case["single"][2]
    assert abs(case["naive"] - loss) > 100 * DP_LOSS_RTOL * abs(loss)


def test_replicas_stay_identical(case):
    dp = case["dp"][0]
    assert len(dp.replicas) == 4
    assert any(".shards." in n for n, _ in dp.model.named_parameters())
    for others in dp.params[1:]:
        for a, b in zip(dp.params[0], others):
            assert torch.equal(a, b)


def test_dp_tp_step_matches_jax(case):
    want_p, want_m, want_loss, want_aux = case["jax"]
    dp, dloss, daux = case["dp"]
    np.testing.assert_allclose(dloss, want_loss, rtol=DP_LOSS_RTOL)
    assert daux["num_fg"] == want_aux["num_fg"]
    assert_leaves_close(want_m, state_tree(dp.state))
    assert_leaves_close(want_p, tw.tree_from_state_dict(
        merge_shards(dp.model.state_dict())))


@pytest.mark.parametrize("name,tree_fn,gen,loss_fn", [
    ("yolo11", lambda: tw.tree_from_model(tw.random_model(
        "11", "detect", "n", 80, seed=1)), tds.synthetic_batches,
     ttrain.detection_loss),
    ("pose", lambda: trained_task_tree("pose", 1),
     tds.synthetic_pose_batches, pose_loss),
    ("obb", lambda: trained_task_tree("obb", 15),
     tds.synthetic_obb_batches, obb_loss),
])
def test_dp_tp_step_of_the_other_families(name, tree_fn, gen, loss_fn):
    """YOLO11 and the pose / obb heads through a {data: 2, model: 2}
    step on an uneven batch, against the single-device step."""
    tree = tree_fn()
    batch = to_torch(uneven(next(gen(4, imgsz=IMGSZ, seed=3))))
    step = ttrain.make_train_step(loss_fn, lr=LR)
    single = port_model(tree)
    mom = step.init(single)
    loss, aux = step(single, mom, *batch)
    dp = DataParallelStep(step, port_model(tree),
                          make_mesh(4, model_parallel=2, device="cpu"))
    dloss, daux = dp(*batch)
    np.testing.assert_allclose(float(dloss), float(loss), rtol=DP_LOSS_RTOL)
    assert int(daux["num_fg"]) == int(aux["num_fg"])
    assert_leaves_close(tw.tree_from_model(single), tw.tree_from_state_dict(
        merge_shards(dp.model.state_dict())))
    assert_leaves_close(tw.tree_from_state_dict(mom), state_tree(dp.state))


# --- RT-DETR: AdamW, the gt count over every replica ---------------------

@pytest.fixture(scope="module")
def rt_case():
    saved = jrtdetr._BF16_VALS, trtdetr._BF16_VALS
    jrtdetr._BF16_VALS = trtdetr._BF16_VALS = False
    try:
        model = seeded_model().set_compute_dtype(torch.float32)
        tree = trtdetr.tree_from_model(model)
        batch = uneven(next(tds.synthetic_batches(4, imgsz=IMGSZ, seed=5)))
        imgs = batch[0].astype(np.float32) / 255.0
        nc = trtdetr.nc_of(tree)
        b = (imgs, batch[1], np.minimum(batch[2], nc - 1), batch[3])
        p1, o1, loss1, aux1 = jrt.make_train_step_rtdetr(nc, lr=1e-4)(
            jcopy(tree), jrt.init_opt_rtdetr(jcopy(tree)),
            *(jnp.asarray(a) for a in b))
        tb = tuple(torch.from_numpy(np.asarray(a)) for a in b)
        step = trt.make_train_step_rtdetr(lr=1e-4)
        single = copy.deepcopy(model)
        opt = step.init(single)
        loss, aux = step(single, opt, *tb)
        dp = DataParallelStep(step, copy.deepcopy(model),
                              make_mesh(8, model_parallel=2, device="cpu"))
        dloss, daux = dp(*tb)
        with torch.no_grad():
            naive = sum(float(step.loss_fn(copy.deepcopy(model),
                                           *(t[i:i + 1] for t in tb))[0])
                        for i in range(4)) / 4
    finally:
        jrtdetr._BF16_VALS, trtdetr._BF16_VALS = saved
    return dict(jax=(jnumpy(p1), jnumpy(o1), float(loss1),
                     {k: float(v) for k, v in aux1.items()}),
                single=(single, opt, float(loss),
                        {k: float(v) for k, v in aux.items()}),
                dp=(dp, float(dloss), {k: float(v) for k, v in
                                       daux.items()}), naive=naive)


def test_rtdetr_dp_tp_step_matches_single_device_and_jax(rt_case):
    single, opt, loss, aux = rt_case["single"]
    dp, dloss, daux = rt_case["dp"]
    np.testing.assert_allclose(dloss, loss, rtol=DP_LOSS_RTOL)
    assert daux["num_fg"] == aux["num_fg"] > 0
    assert abs(rt_case["naive"] - loss) > 100 * DP_LOSS_RTOL * abs(loss)
    got_p = tw.tree_from_state_dict(merge_shards(dp.model.state_dict()))
    got_m = state_tree(dp.state["m"])
    single_m = tw.tree_from_state_dict(opt["m"])
    assert_rtdetr_grads_close(single_m, got_m)
    assert_adamw_params_close(trtdetr.tree_from_model(single), got_p,
                              single_m)
    assert int(dp.state["t"]) == int(opt["t"]) == 1
    want_p, want_o, want_loss, want_aux = rt_case["jax"]
    np.testing.assert_allclose(dloss, want_loss, rtol=DP_LOSS_RTOL)
    assert daux["num_fg"] == want_aux["num_fg"]
    assert_rtdetr_grads_close(want_o["m"], got_m)
    assert_adamw_params_close(want_p, got_p, want_o["m"])


# --- tools/train.py --dp -------------------------------------------------

def _run(tmp_path, name, dp, *extra):
    out = tmp_path / f"{name}.npz"
    argv = ["--device", "cpu", "--dp", str(dp), "--data", "synthetic",
            "--imgsz", "64", "--batch", "4", "--lr", "1e-3", "--weights",
            "assets/yolov8n_synthetic_256.npz", "--out", str(out), *extra]
    assert train_tool.main(argv) == 0
    return tckpt.load_train_state(out)


def test_train_tool_dp2_saves_and_resumes_as_dp1(tmp_path):
    runs = {dp: _run(tmp_path, f"dp{dp}", dp, "--steps", "2")
            for dp in (1, 2)}
    for dp in (1, 2):
        assert runs[dp][2] == 2
    resumed = {dp: _run(tmp_path, f"resumed{dp}", dp, "--steps", "1",
                        "--resume", str(tmp_path / f"dp{dp}.npz"))
               for dp in (1, 2)}
    for a, b in ((runs[1], runs[2]), (resumed[1], resumed[2])):
        for tree_a, tree_b in ((a[0], b[0]), (a[1], b[1])):
            fa, fb = tw.flatten_tree(tree_a), tw.flatten_tree(tree_b)
            assert fa.keys() == fb.keys()
            for k in fa:
                np.testing.assert_allclose(fb[k], fa[k], rtol=DP_RTOL,
                                           atol=DP_ATOL, err_msg=k)
    assert resumed[2][2] == 3
    assert (tmp_path / "resumed2.weights.npz").exists()


def test_train_tool_dp_errors():
    with pytest.raises(ValueError, match="split evenly"):
        train_tool.main(["--device", "cpu", "--dp", "3", "--batch", "4",
                         "--steps", "1"])
