"""The port's RT-DETR training against the JAX package (CPU, float32).

``hungarian_match`` (the ε-auction) equals JAX's on each problem and is
within M·ε of scipy's exact assignment; the port's batched auction over
many problems equals per-problem runs. ``rtdetr_loss`` and one AdamW step
at 1 × 64², nc 4, from the port's seeded init with its box heads spread
(zero-initialised they put every query on its anchor, where gt boxes on
the 1/64 grid tie L1 costs exactly): JAX's jitted
``make_train_step_rtdetr`` is compiled once in a module fixture. Loss and
components rtol 1e-4; gradients (the first moment after one step from
zero is 0.1 · clip scale · g) per leaf max |Δ| ≤ 1e-3 · max |g_leaf| +
1e-5, the atol of 1e-5 for the deformable sampling's offset weights,
whose gradients at this size (~2e-4) go through bilinear corner weights
in another summation order. Parameters after the step atol 1e-6 where
|g| exceeds that gradient tolerance: AdamW's first step moves each
parameter by ≈ lr · sign(g), and where g is float noise — the attention
key biases, to which softmax is invariant, have a gradient of exactly 0
in exact arithmetic — the sign is arbitrary, so there the step is only
held to |Δp| ≤ 2 · lr.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models import rtdetr as jrtdetr
from roadvision_tpu.models import rtdetr_train as jrt
from roadvision_tpu.runtime import checkpoint as jckpt
from roadvision_tpu_torch.models import rtdetr as trtdetr
from roadvision_tpu_torch.models import rtdetr_train as trt
from roadvision_tpu_torch.models.yolo import weights as tw
from roadvision_tpu_torch.runtime import checkpoint as tckpt

from tests.test_torch_train import LOSS_RTOL, flat, jcopy, jnumpy

LR = 1e-4
NC = 4
GB = np.array([[[4.3, 6.7, 40.1, 30.9], [20.6, 19.2, 60.3, 61.7],
                [0.0, 0.0, 0.0, 0.0]]], np.float32)
GC = np.array([[1, 2, 0]], np.int32)
GM = np.array([[True, True, False]])


@pytest.fixture(autouse=True)
def f32_values(monkeypatch):
    """Both packages read ``_BF16_VALS`` at import: pin it off."""
    monkeypatch.setattr(jrtdetr, "_BF16_VALS", False)
    monkeypatch.setattr(trtdetr, "_BF16_VALS", False)


def seeded_model():
    model = trtdetr.random_model(NC, seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for head in [model.dec.enc_bbox, *model.dec.dec_bbox]:
            head[2].weight.copy_(torch.randn(head[2].weight.shape,
                                             generator=gen) * 0.05)
    return model


def batch():
    img = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    return img, GB, GC, GM


def to_torch(b):
    return tuple(torch.from_numpy(a) for a in b)


@pytest.fixture(scope="module")
def case():
    saved = jrtdetr._BF16_VALS, trtdetr._BF16_VALS
    jrtdetr._BF16_VALS = trtdetr._BF16_VALS = False
    try:
        model = seeded_model().set_compute_dtype(torch.float32)
        tree = trtdetr.tree_from_model(model)
        b = batch()
        jstep = jrt.make_train_step_rtdetr(NC, lr=LR)
        p1, o1, loss1, aux1 = jstep(jcopy(tree),
                                    jrt.init_opt_rtdetr(jcopy(tree)),
                                    *(jnp.asarray(a) for a in b))
        s1 = (jnumpy(p1), jnumpy(o1))
        p2, o2, loss2, _ = jstep(p1, o1, *(jnp.asarray(a) for a in b))
        opt = trt.init_opt_rtdetr(model)
        trt.reset_host_syncs()
        loss, aux = trt.make_train_step_rtdetr(lr=LR)(model, opt,
                                                      *to_torch(b))
        syncs = trt.host_syncs
    finally:
        jrtdetr._BF16_VALS, trtdetr._BF16_VALS = saved
    return dict(tree=tree, batch=b, jstep=jstep, s1=s1,
                want=(float(loss1), {k: float(v) for k, v in aux1.items()}),
                s2=(jnumpy(p2), jnumpy(o2), float(loss2)),
                got=(model, opt, float(loss),
                     {k: float(v) for k, v in aux.items()}, syncs))


def grad_from_m(m_tree):
    """The first moment after one AdamW step from zero is (1 − β1)·s·g."""
    return {k: v / 0.1 for k, v in flat(m_tree).items()}


def assert_rtdetr_grads_close(want_m, got_m):
    want, got = grad_from_m(want_m), grad_from_m(got_m)
    assert want.keys() == got.keys()
    for k in want:
        tol = 1e-3 * np.abs(want[k]).max() + 1e-5
        assert np.abs(want[k] - got[k]).max() <= tol, k


def assert_adamw_params_close(want_p, got_p, want_m):
    want, got, g = flat(want_p), flat(got_p), grad_from_m(want_m)
    assert want.keys() == got.keys()
    for k in want:
        tol = 1e-3 * np.abs(g[k]).max() + 1e-5
        sure = np.abs(g[k]) > tol
        np.testing.assert_allclose(got[k][sure], want[k][sure], rtol=0,
                                   atol=1e-6, err_msg=k)
        assert np.abs(got[k] - want[k]).max() <= 2 * LR + 1e-6, k


def test_loss_and_components_match_jax(case):
    want_loss, want_aux = case["want"]
    _, _, loss, aux, syncs = case["got"]
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    for k in ("cls", "l1", "giou", "grad_norm"):
        np.testing.assert_allclose(aux[k], want_aux[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert aux["num_fg"] == want_aux["num_fg"] == 2
    assert 1 <= syncs <= 4      # one read of "done" per 8 auction rounds


def test_gradients_match_jax(case):
    _, opt, _, _, _ = case["got"]
    assert_rtdetr_grads_close(case["s1"][1]["m"],
                              tw.tree_from_state_dict(opt["m"]))


def test_adamw_step_matches_jax(case):
    model, opt, _, _, _ = case["got"]
    assert_adamw_params_close(case["s1"][0], tw.tree_from_model(model),
                              case["s1"][1]["m"])
    assert int(opt["t"]) == int(case["s1"][1]["t"]) == 1
    v_want, v_got = flat(case["s1"][1]["v"]), flat(
        tw.tree_from_state_dict(opt["v"]))
    for k in v_want:
        tol = 2e-3 * np.abs(v_want[k]).max() + 1e-12
        assert np.abs(v_want[k] - v_got[k]).max() <= tol, k


def test_jax_state_resumes_in_port(case, tmp_path):
    """JAX saves {params, {m, v, t}} after step 1; the port resumes it and
    its step 2 equals JAX's."""
    path = jckpt.save_train_state(str(tmp_path / "r1.npz"), *case["s1"], 1,
                                  use_orbax=False)
    params, opt_tree, step = tckpt.load_train_state(path)
    assert step == 1 and set(opt_tree) == {"m", "v", "t"}
    model = tw.model_from_params(params).set_compute_dtype(torch.float32)
    opt = tckpt.opt_state_from_tree(opt_tree, torch.device("cpu"))
    loss, _ = trt.make_train_step_rtdetr(lr=LR)(model, opt,
                                                *to_torch(case["batch"]))
    np.testing.assert_allclose(float(loss), case["s2"][2], rtol=LOSS_RTOL)
    assert int(opt["t"]) == 2
    assert_adamw_params_close(case["s2"][0], tw.tree_from_model(model),
                              case["s1"][1]["m"])


def test_port_state_resumes_in_jax(case, tmp_path):
    model, opt, _, _, _ = case["got"]
    path = tckpt.save_train_state(tmp_path / "p1.npz", model, opt, 1)
    params, opt_tree, step = jckpt.load_train_state(path)
    assert step == 1 and int(opt_tree["t"]) == 1
    for want, got in ((tw.tree_from_model(model), params),
                      (tw.tree_from_state_dict(opt["m"]), opt_tree["m"]),
                      (tw.tree_from_state_dict(opt["v"]), opt_tree["v"])):
        w, g = flat(want), flat(got)
        assert w.keys() == g.keys()
        assert all(np.array_equal(w[k], g[k]) for k in w)
    _, o2, loss2, _ = case["jstep"](jcopy(params), jcopy(opt_tree),
                                    *(jnp.asarray(a) for a in case["batch"]))
    assert int(o2["t"]) == 2 and np.isfinite(float(loss2))


def test_nan_batch_leaves_adamw_state_unchanged(case):
    model = tw.model_from_params(case["tree"]).set_compute_dtype(
        torch.float32)
    opt = trt.init_opt_rtdetr(model)
    step = trt.make_train_step_rtdetr(lr=LR)
    img, *gts = to_torch(case["batch"])
    step(model, opt, img, *gts)
    before = ({k: v.clone() for k, v in model.state_dict().items()},
              {k: v.clone() for k, v in opt["m"].items()},
              {k: v.clone() for k, v in opt["v"].items()}, int(opt["t"]))
    bad = img.clone()
    bad[0, 1, 2, 0] = float("nan")
    loss, aux = step(model, opt, bad, *gts)
    assert not np.isfinite(float(loss)) and not bool(aux["ok"])
    assert int(opt["t"]) == before[3] == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[0][k]), k
    for k in opt["m"]:
        assert torch.equal(opt["m"][k], before[1][k]), k
        assert torch.equal(opt["v"][k], before[2][k]), k


def test_hungarian_match_matches_jax_and_scipy():
    from scipy.optimize import linear_sum_assignment
    rng = np.random.RandomState(0)
    for m, nq, n_valid in ((3, 20, 3), (8, 40, 6), (12, 30, 12), (5, 5, 5)):
        cost = rng.uniform(0, 10, (m, nq)).astype(np.float32)
        mask = np.arange(m) < n_valid
        want = np.asarray(jax.jit(jrt.hungarian_match)(cost, mask))
        got = trt.hungarian_match(torch.from_numpy(cost)[None],
                                  torch.from_numpy(mask)[None])[0].numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[~mask] == -1).all()
        assert len(set(got[mask])) == n_valid
        rows, cols = linear_sum_assignment(cost[mask])
        best = cost[mask][rows, cols].sum()
        ours = cost[np.arange(m)[mask], got[mask]].sum()
        assert best - 1e-4 <= ours <= best + n_valid * trt.AUCTION_EPS + 1e-4


def test_batched_auction_equals_per_problem_runs():
    """Problems of different difficulty in one batch: the finished ones
    are not moved by the rounds the others still need."""
    rng = np.random.RandomState(1)
    costs, masks = [], []
    for i in range(14):
        c = rng.uniform(0, 10, (12, 50)).astype(np.float32)
        if i % 3 == 0:          # near-equal columns: many rounds
            c = 5.0 + rng.uniform(0, 1e-2, c.shape).astype(np.float32)
        costs.append(c)
        masks.append(np.arange(12) < rng.randint(1, 13))
    cost, mask = torch.from_numpy(np.stack(costs)), torch.from_numpy(
        np.stack(masks))
    together = trt.hungarian_match(cost, mask)
    for i in range(len(costs)):
        alone = trt.hungarian_match(cost[i:i + 1], mask[i:i + 1])
        assert torch.equal(alone[0], together[i]), i


def test_training_forward_detaches_as_jax(monkeypatch):
    """The first queries and reference boxes are detached, and each
    layer's refined box before it feeds the next: a loss on the last
    layer's boxes reaches no earlier decoder layer's box head. The
    sampling reads f32 values whatever ``_BF16_VALS`` says."""
    model = seeded_model().set_compute_dtype(torch.float32)
    x = torch.from_numpy(batch()[0])
    with torch.no_grad():
        f32 = model.forward_train(x)
        monkeypatch.setattr(trtdetr, "_BF16_VALS", True)
        assert torch.equal(model.forward_train(x)["boxes"][-1],
                           f32["boxes"][-1])
    aux = model.forward_train(x)
    assert len(aux["boxes"]) == len(aux["scores"]) == trtdetr.NDL
    assert aux["enc_boxes"].shape == aux["boxes"][0].shape
    aux["boxes"][-1].sum().backward()
    heads = model.dec.dec_bbox
    assert all(p.grad is None or not p.grad.any()
               for h in heads[:-1] for p in h.parameters())
    assert heads[-1][2].weight.grad.abs().sum() > 0
    assert model.dec.enc_bbox[2].weight.grad is None or \
        not model.dec.enc_bbox[2].weight.grad.any()
