"""The deformable sampling's gradient (``ops/deform.py``: K8's plain
version, the autograd function around K7 and K8) on the CPU in float32.

* ``deform_sample_backward_plain`` against ``torch.autograd.grad`` of
  ``deform_sample_plain`` (both gather formulations) on random inputs,
  non-square levels, points on and just outside every edge of every
  level, and one NaN location: equal to the one-gather autograd (it is
  that autograd), within RTOL / ATOL · scale of the paired one.
* A torch model of K8's arithmetic (``csrc/deform.cu``), per (batch,
  query, head) and point by point in the kernel's order: K7's softmax,
  the recomputed corner weights, masks and rows, the lane groups'
  points, each corner row's dot product with the output gradient over a
  lane's 4 channels and then its group of 8 lanes, S, Dx, Dy formed from
  them, the softmax backward, the offset and box chain, the value rows'
  sums (a lane's four products skipped only where all are 0). Held to
  the plain backward on the same cases, on (NL, NDP) = (3, 3), (4, 5)
  (a ragged last lane group) and on a NaN output gradient whose zero-
  weight corners must still carry the NaN into the value gradient, at
  RTOL / ATOL · scale, with non-finite values at the same places; the
  only check of K8's derivation that runs without a card (where the
  smoke and the card tests hold K8 to the plain backward).
* ``deform_attn`` with gradients, through the plain version's autograd
  and through ``DeformSample`` with the K8 model in the kernels' place,
  against ``jax.vjp`` of ``roadvision_tpu/models/rtdetr.py::_deform_attn``
  on the same numpy inputs and linear weights (``bf16_vals=False``, as
  the train path pins it): the gradients of the query, the boxes, the
  values and the offset, attention-weight and output linears.

Tolerances: RTOL 1e-5 and ATOL 5e-6 times the largest magnitude of the
gradient compared (``_close``): the sums run in other orders (a
butterfly over 32 lanes against torch's reductions, value rows summed in
another order, XLA's fusions), and the softmax backward subtracts sums
of O(1) terms; the differences seen are at most 5.5e-7 of that
magnitude.
"""
import functools

import numpy as np
import pytest
import torch

import jax

from roadvision_tpu.models import rtdetr as J
from roadvision_tpu_torch.models import rtdetr as T
from roadvision_tpu_torch.ops import deform as D
from tests.test_torch_deform import (POINT_CASES, _butterfly, _lins,
                                     corner_weights, lane_points,
                                     points_case, warp_softmax)

RTOL, ATOL = 1e-5, 5e-6
SQUARE = [(10, 10), (5, 5), (3, 3)]
RAGGED = [(6, 10), (3, 5), (2, 3)]
NQ = 7
CASES = ("random", "ragged", "edges", "nan")
NAMES = ("off", "logits", "refer", "values")


def _grad_case(name: str, seed: int = 11):
    """(grad_out, off, logits, refer, values, shapes) of a case, f32 on
    the CPU, from a numpy seed."""
    rng = np.random.RandomState(seed)
    shapes = RAGGED if name in ("ragged", "nan") else SQUARE
    rows = sum(h * w for h, w in shapes)
    b = 2
    off = rng.randn(b, NQ, T.NH, T.NL, T.NDP, 2) * 3
    refer = rng.uniform(0.05, 0.95, (b, NQ, 4))
    if name == "edges":
        # ctr 0.5, wh 1: loc = 0.5 + off / 8; x at -0.5 (loc 0), 0, W - 1,
        # W - 0.5 (loc 1), just outside (-1, W) and far outside
        refer[:] = (0.5, 0.5, 1.0, 1.0)
        for lvl, (hl, wl) in enumerate(shapes):
            for ax, n in ((0, wl), (1, hl)):
                locs = np.array([0.0, 0.5 / n, (n - 0.5) / n, 1.0,
                                 -0.5 / n, 1.0 + 0.5 / n, -0.25, 1.25])
                off[:, :, :, lvl, :, ax] = (rng.choice(
                    locs, off[:, :, :, lvl, :, ax].shape) - 0.5) * 8.0
    if name == "nan":
        off[1, 3, 5, 1, 2, 0] = np.nan
    arrays = (rng.randn(b, NQ, T.NH, T.HD // T.NH), off,
              rng.randn(b, NQ, T.NH, T.NL * T.NDP), refer,
              rng.randn(b, rows, T.NH, T.HD // T.NH))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays] \
        + [shapes]


# the point of a (batch, query, head) at pixel centres, with a NaN in its
# output gradient: NAN_GO = (batch, query, head, channel)
DYADIC = [(8, 8), (4, 4), (2, 2)]
NAN_GO = (1, 2, 3, 5)


def _nan_grad_case(seed: int = 12):
    """(grad_out, off, logits, refer, values, shapes): random, except
    that NAN_GO's (batch, query, head) puts every point on a pixel centre
    (fx = fy = 0 exactly: the corners (1,0), (0,1), (1,1) weigh 0, and a
    point in the last column or row has corners outside the map) and its
    output gradient holds a NaN in one channel. The plain backward adds
    0 · NaN into those corners' rows."""
    *args, _ = _grad_case("random", seed)
    grad_out, off, logits, refer, values = args
    rng = np.random.RandomState(seed)
    b, q, h, c = NAN_GO
    refer[b, q] = torch.tensor([0.5, 0.5, 1.0, 1.0])
    for lvl, (hl, wl) in enumerate(DYADIC):
        for ax, n in ((0, wl), (1, hl)):
            k = rng.randint(0, n, T.NDP)
            k[0] = n - 1
            # loc = 0.5 + off / 8 = (k + 0.5) / n: x = loc · n - 0.5 = k
            off[b, q, h, lvl, :, ax] = torch.from_numpy(
                (((k + 0.5) / n - 0.5) * 8.0).astype(np.float32))
    grad_out[b, q, h, c] = float("nan")
    rows = sum(hh * ww for hh, ww in DYADIC)
    values = torch.from_numpy(rng.randn(2, rows, T.NH, T.HD // T.NH)
                              .astype(np.float32))
    return [grad_out, off, logits, refer, values, DYADIC]


def _case_args(case: str):
    """A case's (grad_out, off, logits, refer, values, shapes)."""
    if case == "nan_grad":
        return _nan_grad_case()
    if case in POINT_CASES:
        args = points_case(*POINT_CASES[case])
        b, nq, nh = args[0].shape[:3]
        go = np.random.RandomState(13).randn(b, nq, nh, T.HD // T.NH)
        return [torch.from_numpy(go.astype(np.float32))] + args
    return _grad_case(case)


def _autograd(grad_out, off, logits, refer, values, shapes, paired=False):
    ins = [t.clone().requires_grad_(True)
           for t in (off, logits, refer, values)]
    out = D.deform_sample_plain(*ins, shapes, paired=paired)
    return torch.autograd.grad(out, ins, grad_out)


def _close(got, want, what):
    """Non-finite values in the same tensors; where both are finite,
    |got - want| <= RTOL |want| + ATOL · max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bad_g, bad_w = ~np.isfinite(got), ~np.isfinite(want)
    assert bad_g.any() == bad_w.any(), (what, bad_g.sum(), bad_w.sum())
    both = ~(bad_g | bad_w)
    scale = np.abs(want[both]).max() if both.any() else 0.0
    np.testing.assert_allclose(got[both], want[both], rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)
    return bad_w


def k8_model(grad_out, off, logits, refer, values, shapes):
    """K8's arithmetic (csrc/deform.cu) in its order, over every (batch,
    query, head) at once: K7's lane points, then lane group g (lanes 8g …
    8g+7, 4 channels a lane) takes the points j ≡ g (mod 4); per corner
    each lane forms the row's dot product with the output gradient over
    its 4 channels (((c0 + c1) + c2) + c3), the group sums it by xor
    shuffles over its 8 lanes, and lane j forms point j's S, Dx and Dy
    from the four sums; the value rows take a lane's four products
    unless all are exactly 0; the softmax backward and the box sums are
    butterflies over the next power of two of lanes past NL·NDP."""
    b, nq, nh, nl, ndp, _ = off.shape
    npts = nl * ndp
    ppl = -(-npts // 4)
    width = 1
    while width < npts:
        width *= 2
    attw = warp_softmax(logits, npts)                       # (B, NQ, NH, P)
    fx, fy, masks, rows, wl, hl = lane_points(off, refer, shapes)
    w = corner_weights(fx, fy, masks)

    def group_sum(x):                 # (…, 32) channels → a lane group's
        lanes = x.reshape(x.shape[:-1] + (8, 4))
        lanes = ((lanes[..., 0] + lanes[..., 1]) + lanes[..., 2]) \
            + lanes[..., 3]
        return _butterfly(lanes, torch.add, 8)[..., 0]

    def lanes_sum(x):                 # (…, P) → over `width` lanes
        lanes = torch.zeros(x.shape[:-1] + (width,))
        lanes[..., :npts] = x
        return _butterfly(lanes, torch.add, width)[..., 0]

    g_values = torch.zeros_like(values)
    sums = torch.zeros((3, b, nq, nh, npts))               # S, Dx, Dy
    bi = torch.arange(b)[:, None, None]
    hi = torch.arange(nh)[None, None, :]
    for grp in range(4):
        for t in range(ppl):
            j = grp + 4 * t
            if j >= npts:
                continue
            wk = [w[..., j, k, None] for k in range(4)]
            # per corner the dot product with the output gradient, over a
            # lane's 4 channels and then its group of 8 lanes
            d = [group_sum(values[bi, rows[..., j, k], hi] * grad_out)
                 for k in range(4)]
            # lane j's S, Dx, Dy with its corner weights
            mk = [masks[..., j, k] for k in range(4)]
            pfx, pfy = fx[..., j], fy[..., j]
            pgx, pgy = 1.0 - pfx, 1.0 - pfy
            s_l = torch.zeros_like(d[0])
            for k in range(4):
                s_l = s_l + w[..., j, k] * d[k]
            sums[0, ..., j] = s_l
            sums[1, ..., j] = (mk[0] * -pgy) * d[0] + (mk[1] * pgy) * d[1] \
                + (mk[2] * -pfy) * d[2] + (mk[3] * pfy) * d[3]
            sums[2, ..., j] = (mk[0] * -pgx) * d[0] + (mk[1] * -pfx) * d[1] \
                + (mk[2] * pgx) * d[2] + (mk[3] * pfx) * d[3]
            ag = grad_out * attw[..., j, None]
            for k in range(4):
                c = ag * wk[k]
                # a lane's vector atomic, skipped only where its four
                # products are all exactly 0 (a NaN product is added)
                keep = (c != 0).reshape(b, nq, nh, 8, 4).any(-1) \
                    .repeat_interleave(4, -1)
                row = rows[..., j, k]
                idx = (bi.expand_as(row)[..., None].expand_as(c)[keep],
                       row[..., None].expand_as(c)[keep],
                       hi.expand_as(row)[..., None].expand_as(c)[keep],
                       torch.arange(32).expand_as(c)[keep])
                g_values.index_put_(idx, c[keep], accumulate=True)
    s_p, dx_p, dy_p = sums
    g_logits = attw * (s_p - lanes_sum(attw * s_p)[..., None])
    inv = torch.tensor(1.0, dtype=torch.float32) / float(ndp)
    glx = (attw * dx_p) * wl
    gly = (attw * dy_p) * hl
    tx, ty = glx * 0.5, gly * 0.5
    rr = refer[:, :, None, None, :]                        # (B, NQ, 1, 1, 4)
    oxp = off[..., 0].reshape(b, nq, nh, npts)
    oyp = off[..., 1].reshape(b, nq, nh, npts)
    g_off = torch.stack([(tx * rr[..., 2]) * inv, (ty * rr[..., 3]) * inv],
                        dim=-1).reshape(off.shape)
    parts = [lanes_sum(v) for v in (glx, gly, tx * (oxp * inv),
                                    ty * (oyp * inv))]     # (B, NQ, NH)
    g_refer = torch.zeros_like(refer)
    for h in range(nh):                        # the heads' atomics
        g_refer = g_refer + torch.stack([p[:, :, h] for p in parts], -1)
    return g_off, g_logits.reshape(logits.shape), g_refer, g_values


@pytest.mark.parametrize("case", CASES)
def test_backward_plain_is_autograd_of_the_plain_version(case):
    *args, shapes = _grad_case(case)
    want = _autograd(*args, shapes)
    got = D.deform_sample_backward_plain(*args, shapes)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    # the same from inside inference mode, with a non-contiguous grad_out
    with torch.inference_mode():
        g_nc = args[0].transpose(0, 1).contiguous().transpose(0, 1)
        again = D.deform_sample_backward_plain(g_nc, *args[1:], shapes)
    for g, w in zip(again, want):
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    paired = _autograd(*args, shapes, paired=True)
    bad = [_close(g, w, f"{case} {n}") for g, w, n in zip(got, paired, NAMES)]
    assert any(x.any() for x in bad) == (case == "nan")


@pytest.mark.parametrize("case", CASES + tuple(POINT_CASES) + ("nan_grad",))
def test_k8_model_matches_the_plain_backward(case):
    *args, shapes = _case_args(case)
    want = D.deform_sample_backward_plain(*args, shapes)
    got = k8_model(*args, shapes)
    for g, w, n in zip(got, want, NAMES):
        bad = _close(g, w, f"{case} {n}")
        # NaN at the plain backward's places: for the NaN point, its y
        # offset (0 · NaN through 1 - fx), its (batch, query, head)'s
        # logits, its query's y and size gradients and level 1's row 0
        # of its head
        assert np.array_equal(np.isnan(g.numpy()), bad), n
        assert bad.any() == (case in ("nan", "nan_grad")), n
    if case == "nan_grad":
        # the value gradient is NaN in the NaN channel of every corner
        # row the (batch, query, head) reads, those its zero-weight
        # corners read among them: a skip on the weight alone misses them
        b, q, h, c = NAN_GO
        fx, fy, masks, rows, _, _ = lane_points(args[1], args[3], shapes)
        w = corner_weights(fx, fy, masks)
        zero = rows[b, q, h][w[b, q, h] == 0]
        assert zero.numel() and torch.isnan(got[3][b, zero, h, c]).all()
        assert int(torch.isnan(got[3]).sum()) == int(
            torch.unique(rows[b, q, h]).numel())
    if case == "nan":
        g_off, g_logits, g_refer, g_values = (t.numpy() for t in got)
        assert np.isnan(g_off[1, 3, 5, 1, 2, 1]) and np.isnan(g_off).sum() == 1
        assert np.isnan(g_logits[1, 3, 5]).all()
        assert np.isnan(g_refer[1, 3, 1:]).all()
        row0 = RAGGED[0][0] * RAGGED[0][1]
        assert np.isnan(g_values[1, row0, 5]).all() \
            and np.isnan(g_values).sum() == g_values.shape[-1]


def test_k8_wrapper_refuses_what_it_does_not_take():
    """The checks run before any build: bf16 values, a grad_out of another
    shape, too many points a head."""
    grad_out, off, logits, refer, values, shapes = _grad_case("random")
    with pytest.raises(ValueError, match="float32"):
        D._sample_backward_cuda(grad_out, off, logits, refer,
                                values.to(torch.bfloat16), shapes)
    with pytest.raises(ValueError, match="does not fit"):
        D._sample_backward_cuda(grad_out[:, :3], off, logits, refer, values,
                                shapes)
    big = off.repeat(1, 1, 1, 1, 3, 1)
    with pytest.raises(ValueError, match="32 points"):
        D._sample_backward_cuda(grad_out, big, logits.repeat(1, 1, 1, 3),
                                refer, values, shapes)


@pytest.fixture
def modelled_kernels(monkeypatch):
    """``DeformSample`` on the CPU: K7's launch replaced by the plain
    forward and K8's by :func:`k8_model`; records the backward calls."""
    calls = []

    def k7(off, logits, refer, values, shapes, bf16_vals):
        assert bf16_vals is False
        return D.deform_sample_plain(off, logits, refer, values, shapes)

    def k8(*args):
        calls.append(args)
        return k8_model(*args)
    monkeypatch.setattr(D, "_sample_cuda", k7)
    monkeypatch.setattr(D, "_sample_backward_cuda", k8)
    return calls


def test_deform_sample_function_returns_the_grads_asked_for(
        modelled_kernels):
    grad_out, off, logits, refer, values, shapes = _grad_case("ragged")
    off.requires_grad_(True)
    values.requires_grad_(True)
    out = D.DeformSample.apply(off, logits, refer, values, shapes)
    out.backward(grad_out)
    assert len(modelled_kernels) == 1
    want = D.deform_sample_backward_plain(grad_out, off, logits, refer,
                                          values, shapes)
    _close(off.grad, want[0], "off")
    _close(values.grad, want[3], "values")
    assert logits.grad is None and refer.grad is None


def _jax_case(case: str):
    """(query, refer, values, shapes, cotangent) numpy f32 for
    ``_deform_attn`` with ``_lins``' weights (whose offsets read the
    query's first channels, so that a case places the points)."""
    from tests.test_torch_deform import _case
    query, refer, values, shapes = _case(case, seed=7)
    rng = np.random.RandomState(8)
    cot = rng.randn(*query.shape).astype(np.float32)
    return query, refer, values, shapes, cot


@functools.lru_cache(maxsize=None)
def _jax_vjp(shapes):
    """``jax.vjp`` of ``_deform_attn`` at these levels, jitted once."""
    def f(jp_, q, r, v):
        return J._deform_attn(jp_, q, r, v, list(shapes), bf16_vals=False)

    @jax.jit
    def grads(jp_, q, r, v, cot):
        return jax.vjp(f, jp_, q, r, v)[1](cot)
    return grads


@pytest.fixture(scope="module")
def lins():
    return _lins(np.random.RandomState(1))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("route", ["autograd", "k8_model"])
def test_deform_attn_gradients_match_jax(request, lins, case, route):
    p, jp = lins
    query, refer, values, shapes, cot = _jax_case(case)

    jg_p, jg_q, jg_r, jg_v = (jax.tree_util.tree_map(np.asarray, t)
                              for t in _jax_vjp(tuple(shapes))(
                                  jp, query, refer, values, cot))
    sample = None
    if route == "k8_model":
        request.getfixturevalue("modelled_kernels")

        def sample(off, logits, refer_, v, shapes_, bf16_vals, paired):
            assert bf16_vals is False
            return D.DeformSample.apply(off, logits, refer_, v, shapes_)
    p.zero_grad()
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (query, refer, values)]
    out = T.deform_attn(p, *ins, shapes, bf16_vals=False, sample=sample)
    out.backward(torch.from_numpy(cot))
    pairs = [("query", ins[0].grad, jg_q), ("refer", ins[1].grad, jg_r),
             ("values", ins[2].grad, jg_v)]
    for name in ("off", "attw", "out"):
        lin = getattr(p, name)
        pairs += [(f"{name}.w", lin.weight.grad.T, jg_p[name]["w"]),
                  (f"{name}.b", lin.bias.grad, jg_p[name]["b"])]
    for name, got, want in pairs:
        bad = _close(got.detach().numpy(), want, f"{case} {route} {name}")
        if case != "nan":
            assert not bad.any(), name
