"""The deformable sampling's gradient (``ops/deform.py``: K8's plain
version, the autograd function around K7 and K8) on the CPU in float32.

* ``deform_sample_backward_plain`` against ``torch.autograd.grad`` of
  ``deform_sample_plain`` (both gather formulations) on random inputs,
  non-square levels, points on and just outside every edge of every
  level, and one NaN location: equal to the one-gather autograd (it is
  that autograd), within RTOL / ATOL · scale of the paired one.
* A torch model of K8's arithmetic (``csrc/deform.cu``), per (batch,
  query, head) and point by point in the kernel's order: K7's softmax,
  the recomputed corner weights, masks and rows, the per-lane products
  and their butterfly sums S, Dx, Dy, the softmax backward, the offset
  and box chain, the value rows' sums. Held to the plain backward on the
  same cases at RTOL / ATOL · scale, with non-finite values in the same
  gradient tensors; the only check of K8's derivation that runs without
  a card (where the smoke and the card tests hold K8 to the plain
  backward).
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
from tests.test_torch_deform import _butterfly, _lins

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
    """K8's arithmetic (csrc/deform.cu), one step at a time in its order,
    over every (batch, query, head) at once: the lanes are the last axis
    (32 channels), ``_butterfly`` the warp's xor sums."""
    b, nq, nh, nl, ndp, _ = off.shape
    npts = nl * ndp
    width = 1
    while width < npts:
        width *= 2
    lanes = torch.full((b, nq, nh, width), -float("inf"))
    lanes[..., :npts] = logits
    mx = _butterfly(lanes, lambda a, p: torch.where(a < p, p, a), width)
    e = torch.exp(lanes - mx)
    s = _butterfly(torch.zeros(()) + e, torch.add, width)
    attw = torch.where(s == 0, torch.full_like(s, float("nan")), e / s)
    attw = attw[..., :npts]                                 # (B, NQ, NH, P)

    def warp_sum(x):                      # over the 32 channel lanes
        return _butterfly(x, torch.add, 32)[..., 0]

    inv = torch.tensor(1.0, dtype=torch.float32) / float(ndp)
    r = refer[:, :, None, None, None, :]
    ox, oy = off[..., 0], off[..., 1]
    lx = r[..., 0] + ox * inv * r[..., 2] * 0.5
    ly = r[..., 1] + oy * inv * r[..., 3] * 0.5
    g_values = torch.zeros_like(values)
    sums = torch.zeros((3, b, nq, nh, npts))               # S, Dx, Dy
    sides = torch.zeros((2, b, nq, nh, npts))        # Wl, Hl
    bi = torch.arange(b)[:, None, None]
    hi = torch.arange(nh)[None, None, :]
    start = 0
    for lvl, (hl, wl) in enumerate(shapes):
        sx = lx[:, :, :, lvl] * wl - 0.5
        sy = ly[:, :, :, lvl] * hl - 0.5
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx, fy = sx - x0, sy - y0
        gx, gy = 1.0 - fx, 1.0 - fy
        wts = (gx * gy, fx * gy, gx * fy, fx * fy)
        for pt in range(ndp):
            j = lvl * ndp + pt
            a = attw[..., j]
            ag = grad_out * a[..., None]
            vg, wk, mk = [], [], []
            for k in range(4):
                xi = x0[..., pt] + (k & 1)
                yi = y0[..., pt] + (k >> 1)
                inb = ((xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)).float()
                w = wts[k][..., pt] * inb
                nan = torch.isnan(xi) | torch.isnan(yi)
                row = (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1))
                row = start + torch.where(nan, torch.zeros_like(row),
                                          row).long()
                vg.append(values[bi, row, hi] * grad_out)
                c = ag * w[..., None]
                keep = c != 0                       # NaN products are added
                idx = (bi.expand_as(row)[..., None].expand_as(c)[keep],
                       row[..., None].expand_as(c)[keep],
                       hi.expand_as(row)[..., None].expand_as(c)[keep],
                       torch.arange(32).expand_as(c)[keep])
                g_values.index_put_(idx, c[keep], accumulate=True)
                wk.append(w[..., None])
                mk.append(inb[..., None])
            s_l = torch.zeros_like(grad_out)
            for k in range(4):
                s_l = s_l + wk[k] * vg[k]
            pfx, pfy = fx[..., pt, None], fy[..., pt, None]
            pgx, pgy = 1.0 - pfx, 1.0 - pfy
            dx = (mk[0] * -pgy) * vg[0] + (mk[1] * pgy) * vg[1] \
                + (mk[2] * -pfy) * vg[2] + (mk[3] * pfy) * vg[3]
            dy = (mk[0] * -pgx) * vg[0] + (mk[1] * -pfx) * vg[1] \
                + (mk[2] * pgx) * vg[2] + (mk[3] * pfx) * vg[3]
            for i, v in enumerate((s_l, dx, dy)):
                sums[i, ..., j] = warp_sum(v)
            sides[0, ..., j] = float(wl)
            sides[1, ..., j] = float(hl)
        start += hl * wl
    s_p, dx_p, dy_p = sums
    lanes32 = torch.zeros((b, nq, nh, 32))
    lanes32[..., :npts] = attw * s_p
    as_ = warp_sum(lanes32)
    g_logits = attw * (s_p - as_[..., None])
    glx = (attw * dx_p) * sides[0]
    gly = (attw * dy_p) * sides[1]
    tx, ty = glx * 0.5, gly * 0.5
    rr = refer[:, :, None, None, :]                        # (B, NQ, 1, 1, 4)
    oxp = ox.reshape(b, nq, nh, npts)
    oyp = oy.reshape(b, nq, nh, npts)
    g_off = torch.stack([(tx * rr[..., 2]) * inv, (ty * rr[..., 3]) * inv],
                        dim=-1).reshape(off.shape)
    parts = []
    for v in (glx, gly, tx * (oxp * inv), ty * (oyp * inv)):
        lane = torch.zeros((b, nq, nh, 32))
        lane[..., :npts] = v
        parts.append(warp_sum(lane))                       # (B, NQ, NH)
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


@pytest.mark.parametrize("case", CASES)
def test_k8_model_matches_the_plain_backward(case):
    *args, shapes = _grad_case(case)
    want = D.deform_sample_backward_plain(*args, shapes)
    got = k8_model(*args, shapes)
    for g, w, n in zip(got, want, NAMES):
        bad = _close(g, w, f"{case} {n}")
        # NaN at the plain backward's places: for the NaN point, its y
        # offset (0 · NaN through 1 - fx), its (batch, query, head)'s
        # logits, its query's y and size gradients and level 1's row 0
        # of its head
        assert np.array_equal(np.isnan(g.numpy()), bad), n
        assert bad.any() == (case == "nan"), n
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
