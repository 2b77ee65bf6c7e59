"""The deformable-attention sampling (``ops/deform.py``, K7's plain
version and its wrapper) against the JAX package's ``_deform_attn``, on
the CPU in float32.

* ``deform_attn`` (the two linears, ``deform_sample`` → the plain
  version on the CPU, the output linear) against JAX's ``_deform_attn``
  on the same numpy inputs made from a seed: bf16 values on and off,
  both gather formulations (``_PAIRED_GATHERS`` pinned in both modules,
  as tests/test_torch_rtdetr.py pins it), square and non-square levels,
  sampling locations on the map edges (x = -0.5, exactly W - 1, W - 0.5)
  and outside it, and a query whose offsets and logits are NaN: the same
  NaN outputs, every other value within rtol 1e-5, atol 1e-6.
* A torch model of K7's arithmetic order, per (batch, query, head): the
  softmax's butterfly maximum and sum over 16 lanes, the location as
  ``ctr + off · (1/NDP) · wh · 0.5``, the lane groups' points j ≡ g
  (mod 4), each point's corner sum from 0 in corner order times its
  weight into a [point][channel] tile, the tile summed per level over
  the points (in torch's reduction order on the card) and over the
  levels, each product and sum rounded on its own; bit-equal to the
  plain version given the CPU's softmax, division by NDP and point sum,
  and within the same tolerance with the kernel's, on the same cases and on
  (NL, NDP) = (3, 3), (4, 5), whose last lane group is ragged, so that
  the kernel's order is checked before it runs on a card (where the
  smoke holds K7 to the plain version bit for bit).
* The wrapper's refusals; the decoder's ``sample`` argument and the
  training forward's sampling through the wrapper (the plain version
  under autograd on the CPU; K7 and K8 on a card,
  tests/test_torch_deform_grad.py and the card tests); the per-shape
  caches of the anchors and the sincos embedding (built
  outside inference mode: a model that served a batch can still train).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roadvision_tpu.models import rtdetr as J
from roadvision_tpu_torch.models import rtdetr as T
from roadvision_tpu_torch.ops import deform as D

RTOL, ATOL = 1e-5, 1e-6
SQUARE = [(8, 8), (4, 4), (2, 2)]
RAGGED = [(6, 10), (3, 5), (2, 3)]
NQ = 9


def _lins(rng):
    """(port DeformAttn, JAX params): the offsets read the query's first
    NH·NL·NDP·2 channels as they are (so that a test places the sampling
    points), the logits a random map of the rest; value and output
    linears random."""
    n_off = T.NH * T.NL * T.NDP * 2
    p, jp = T.DeformAttn(), {}
    w_off = np.zeros((T.HD, n_off), np.float32)
    w_off[np.arange(n_off), np.arange(n_off)] = 1.0
    w_att = np.zeros((T.HD, T.NH * T.NL * T.NDP), np.float32)
    w_att[n_off:] = rng.randn(T.HD - n_off, w_att.shape[1]) * 0.5
    weights = {"off": (w_off, np.zeros(n_off, np.float32)),
               "attw": (w_att, (rng.randn(w_att.shape[1]) * 0.3)
                        .astype(np.float32))}
    for name in ("val", "out"):
        weights[name] = ((rng.randn(T.HD, T.HD) / 16).astype(np.float32),
                         (rng.randn(T.HD) * 0.1).astype(np.float32))
    for name, (w, b) in weights.items():
        jp[name] = {"w": w, "b": b}
        lin = getattr(p, name)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w.T.copy()))
            lin.bias.copy_(torch.from_numpy(b))
    return p, jp


def _case(name: str, seed: int = 3):
    """(query, refer, values, shapes) of a case, numpy f32."""
    rng = np.random.RandomState(seed)
    shapes = RAGGED if name in ("ragged", "nan") else SQUARE
    rows = sum(h * w for h, w in shapes)
    n_off = T.NH * T.NL * T.NDP * 2
    query = rng.randn(2, NQ, T.HD).astype(np.float32)
    refer = rng.uniform(0.1, 0.9, (2, NQ, 4)).astype(np.float32)
    off = rng.uniform(-6, 6, (2, NQ, T.NH, T.NL, T.NDP, 2))
    if name == "edges":
        # ctr 0.5, wh 1: loc = 0.5 + off / 8 → offsets that put x at -0.5
        # (loc 0), 0 (on the first column's centre), W - 1, W - 0.5 (loc
        # 1) and outside (loc -0.25, 1.25)
        refer[:] = (0.5, 0.5, 1.0, 1.0)
        for lvl, (hl, wl) in enumerate(shapes):
            locs = np.array([0.0, 0.5 / wl, (wl - 0.5) / wl, 1.0, -0.25,
                             1.25])
            picks = (locs - 0.5) * 8.0
            off[:, :, :, lvl] = rng.choice(picks, off[:, :, :, lvl].shape)
    query[..., :n_off] = off.reshape(2, NQ, n_off)
    if name == "nan":
        query[1, 4, 5] = np.nan          # every offset and logit of it
    values = rng.randn(2, rows, T.NH, T.HD // T.NH).astype(np.float32)
    return query, refer, values, shapes


CASES = ("random", "ragged", "edges", "nan")


@pytest.fixture(scope="module")
def lins():
    return _lins(np.random.RandomState(1))


def _assert_close(got, want):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=RTOL, atol=ATOL)
    return nan


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("bf16_vals", [False, True])
def test_deform_sample_plain_matches_jax(monkeypatch, lins, case, paired,
                                         bf16_vals):
    monkeypatch.setattr(J, "_PAIRED_GATHERS", paired)
    monkeypatch.setattr(T, "_PAIRED_GATHERS", paired)
    p, jp = lins
    query, refer, values, shapes = _case(case)
    want = np.asarray(J._deform_attn(jp, jnp.asarray(query),
                                     jnp.asarray(refer), jnp.asarray(values),
                                     shapes, bf16_vals=bf16_vals))
    with torch.no_grad():
        got = T.deform_attn(p, torch.from_numpy(query),
                            torch.from_numpy(refer), torch.from_numpy(values),
                            shapes, bf16_vals=bf16_vals).numpy()
    nan = _assert_close(got, want)
    if case == "nan":
        # the NaN query alone: NaN in every output channel
        assert nan[1, 4].all() and nan.sum() == nan.shape[-1]
    else:
        assert not nan.any()


def _sampling_inputs(case: str):
    """The wrapper's inputs for a case: off, logits, refer, values."""
    p, _ = _lins(np.random.RandomState(1))
    query, refer, values, shapes = _case(case)
    q = torch.from_numpy(query)
    with torch.no_grad():
        off = p.off(q).reshape(2, NQ, T.NH, T.NL, T.NDP, 2)
        logits = p.attw(q).reshape(2, NQ, T.NH, T.NL * T.NDP)
    return (off, logits, torch.from_numpy(refer), torch.from_numpy(values),
            shapes)


def _butterfly(x: torch.Tensor, op, width: int) -> torch.Tensor:
    """Lane j ⊕ lane j ^ o for o = width/2 … 1 over the last axis, lane
    by lane as the warp shuffles it."""
    lanes = torch.arange(x.shape[-1])
    o = width // 2
    while o > 0:
        x = op(x, x[..., lanes ^ o])
        o //= 2
    return x


def warp_softmax(logits, npts: int):
    """Lane j's softmax weight as the kernels compute it, torch's warp
    softmax: logit j in lane j (the lanes past NL·NDP -inf), a butterfly
    maximum and sum over the next power of two of lanes, exp(x - max) /
    sum. (B, NQ, NH, P) → (B, NQ, NH, P)."""
    width = 1
    while width < npts:
        width *= 2
    lanes = torch.full(logits.shape[:-1] + (width,), -float("inf"))
    lanes[..., :npts] = logits
    mx = _butterfly(lanes, lambda a, p: torch.where(a < p, p, a), width)
    e = torch.exp(lanes - mx)
    s = _butterfly(torch.zeros(()) + e, torch.add, width)
    attw = torch.where(s == 0, torch.full_like(s, float("nan")), e / s)
    return attw[..., :npts]


def lane_points(off, refer, shapes, cpu_ops: bool = False):
    """Lane j's point j as the kernels compute it (``locate`` in
    csrc/deform.cu): the fractions fx, fy (B, NQ, NH, P), the corners'
    in-map masks (…, P, 4) as 1.0 / 0.0, their rows of the batch's values
    (…, P, 4: the level's first row plus the clamped row in it; a NaN
    location reads the level's row 0) and each point's level width and
    height (P,). The offsets are scaled by 1/NDP as a product, as torch
    divides by a scalar on the card; ``cpu_ops`` divides, as it does on
    the CPU."""
    b, nq, nh, nl, ndp, _ = off.shape
    npts = nl * ndp
    inv = torch.tensor(1.0, dtype=torch.float32) / float(ndp)
    o = off.reshape(b, nq, nh, npts, 2)
    r = refer[:, :, None, None, :]
    lvl = [j // ndp for j in range(npts)]
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    wl = torch.tensor([float(shapes[v][1]) for v in lvl])
    hl = torch.tensor([float(shapes[v][0]) for v in lvl])
    start = torch.tensor([int(starts[v]) for v in lvl])
    o = o / ndp if cpu_ops else o * inv
    lx = r[..., 0] + o[..., 0] * r[..., 2] * 0.5
    ly = r[..., 1] + o[..., 1] * r[..., 3] * 0.5
    sx, sy = lx * wl - 0.5, ly * hl - 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    masks, rows = [], []
    for k in range(4):
        xi, yi = x0 + (k & 1), y0 + (k >> 1)
        masks.append(((xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)).float())
        row = torch.minimum(yi.clamp(min=0), hl - 1) * wl \
            + torch.minimum(xi.clamp(min=0), wl - 1)
        nan = torch.isnan(xi) | torch.isnan(yi)
        rows.append(start + torch.where(nan, torch.zeros_like(row),
                                        row).long())
    return (sx - x0, sy - y0, torch.stack(masks, -1), torch.stack(rows, -1),
            wl, hl)


def corner_weights(fx, fy, masks):
    """The corners (0,0), (1,0), (0,1), (1,1)'s masked weights (…, 4),
    recomputed from the fractions and masks a lane group receives."""
    gx, gy = 1.0 - fx, 1.0 - fy
    return torch.stack((gx * gy, fx * gy, gx * fy, fx * fy), -1) * masks


def k7_model(off, logits, refer, values, shapes, bf16_vals=False,
             cpu_ops: bool = False):
    """K7's arithmetic in its order (csrc/deform.cu), over every (batch,
    query, head) at once: lanes 0 … P-1 compute the points' weights
    (``warp_softmax``) and geometry (``cpu_ops``: torch's CPU softmax and
    division by NDP, the plain version's ops on the CPU, where the
    card's torch runs the kernel's); lane group g (lanes
    8g … 8g+7, 4 channels a lane; the channel axis here whole) takes the
    points j ≡ g (mod 4) and writes each one's corner sum, from 0 in
    corner order, times its weight into the [point][channel] tile; lane =
    channel then sums the tile per level over the points as torch's
    reduction kernel does on the card (four accumulators from 0, point p
    into p % 4, then ((a0 + a1) + a2) + a3; ``cpu_ops``: the points in
    order, as the CPU sums them), and over the levels from 0."""
    b, nq, nh, nl, ndp, _ = off.shape
    npts = nl * ndp
    ppl = -(-npts // 4)
    attw = logits.softmax(dim=-1) if cpu_ops \
        else warp_softmax(logits, npts)
    fx, fy, masks, rows, _, _ = lane_points(off, refer, shapes, cpu_ops)
    w = corner_weights(fx, fy, masks)
    if bf16_vals:
        values = values.to(torch.bfloat16)
    values = values.float()
    dh = values.shape[-1]
    bi = torch.arange(b)[:, None, None]
    hi = torch.arange(nh)[None, None, :]
    tile = torch.zeros((b, nq, nh, 4 * ppl, dh))
    for grp in range(4):
        for t in range(ppl):
            j = grp + 4 * t
            if j >= npts:
                continue
            acc = torch.zeros((b, nq, nh, dh))
            for k in range(4):
                acc = acc + values[bi, rows[..., j, k], hi] \
                    * w[..., j, k, None]
            tile[..., j, :] = acc * attw[..., j, None]
    out = torch.zeros((b, nq, nh, dh))
    for lvl in range(nl):
        pts = [tile[..., lvl * ndp + p, :] for p in range(ndp)]
        if cpu_ops:                   # the CPU's sum: the points in order
            lsum = torch.zeros_like(out)
            for x in pts:
                lsum = lsum + x
        else:                         # torch's reduction kernel on the card
            acc = [torch.zeros_like(out) for _ in range(4)]
            for p, x in enumerate(pts):
                acc[p % 4] = acc[p % 4] + x
            lsum = ((acc[0] + acc[1]) + acc[2]) + acc[3]
        out = out + lsum
    return out


# (NL, NDP) with NL·NDP not a multiple of 4: the last lane group ragged
POINT_CASES = {"3x3": (3, 3), "4x5": (4, 5)}


def points_case(nl: int, ndp: int, seed: int = 4):
    """(off, logits, refer, values, shapes) f32 for NL levels of NDP
    points a head, from a numpy seed: square and non-square levels, some
    points outside the map."""
    rng = np.random.RandomState(seed)
    shapes = [(8, 8), (4, 6), (3, 3), (2, 5)][:nl]
    rows = sum(h * w for h, w in shapes)
    arrays = (rng.uniform(-6, 6, (2, NQ, T.NH, nl, ndp, 2)),
              rng.randn(2, NQ, T.NH, nl * ndp),
              rng.uniform(0.1, 0.9, (2, NQ, 4)),
              rng.randn(2, rows, T.NH, T.HD // T.NH))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays] \
        + [shapes]


def _bits_equal(got, want):
    """Equal values, NaN at the same places."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("case", CASES + tuple(POINT_CASES))
@pytest.mark.parametrize("bf16_vals", [False, True])
def test_k7_order_matches_the_plain_version(case, bf16_vals):
    """With the CPU's softmax, division and point sum (not the card's
    warp softmax, product with 1/NDP and four-accumulator sum) the model
    is bit-equal to the plain version; with the kernel's it is within
    RTOL / ATOL of it."""
    args = points_case(*POINT_CASES[case]) if case in POINT_CASES \
        else _sampling_inputs(case)
    want = D.deform_sample_plain(*args, bf16_vals=bf16_vals)
    _bits_equal(k7_model(*args, bf16_vals=bf16_vals, cpu_ops=True), want)
    got = k7_model(*args, bf16_vals=bf16_vals).numpy()
    nan = _assert_close(got, want.numpy())
    assert nan.any() == (case == "nan")


def test_one_nan_location_reads_row_zero_with_a_nan_weight():
    """A NaN offset of one point: its (batch, query, head) alone is NaN,
    the rest as without it; the gathers stay inside the map."""
    off, logits, refer, values, shapes = _sampling_inputs("ragged")
    clean = D.deform_sample_plain(off, logits, refer, values, shapes)
    off = off.clone()
    off[0, 2, 3, 1, 0, 0] = float("nan")
    got = D.deform_sample_plain(off, logits, refer, values, shapes)
    nan = torch.isnan(got)
    assert nan[0, 2, 3].all() and int(nan.sum()) == got.shape[-1]
    nan[0, 2, 3] = True
    assert torch.equal(got[~nan], clean[~nan])
    assert torch.equal(torch.isnan(k7_model(off, logits, refer, values,
                                            shapes)), torch.isnan(got))


def test_wrapper_runs_the_plain_version_on_the_cpu():
    args = _sampling_inputs("random")
    want = D.deform_sample_plain(*args, bf16_vals=True, paired=True)
    assert torch.equal(D.deform_sample(*args, bf16_vals=True, paired=True),
                       want)
    # gradients through the plain version's autograd
    off = args[0].clone().requires_grad_(True)
    D.deform_sample(off, *args[1:]).sum().backward()
    assert off.grad is not None and torch.isfinite(off.grad).all()


def test_wrapper_refuses_what_does_not_fit():
    off, logits, refer, values, shapes = _sampling_inputs("random")
    with pytest.raises(ValueError, match="do not fit"):
        D.deform_sample(off, logits[..., :5], refer, values, shapes)
    with pytest.raises(ValueError, match="rows"):
        D.deform_sample(off, logits, refer, values[:, 1:], shapes)
    with pytest.raises(ValueError, match="unsupported devices"):
        D.deform_sample(*(t.to("meta") for t in (off, logits, refer,
                                                 values)), shapes)


def test_training_samples_through_the_plain_version(monkeypatch):
    """``forward_train`` samples through the wrapper ``deform_sample``
    (on the CPU its plain version, whose autograd takes the gradient; on
    a card K7 and K8), with f32 values, once a decoder layer; the
    offset, attention-weight and value linears get gradients."""
    model = T.random_model(nc=3, seed=0)
    x = torch.rand(1, 64, 64, 3)
    calls = []

    def wrapper(*a, **kw):
        calls.append((kw["bf16_vals"], a[3].dtype, torch.is_grad_enabled()))
        return D.deform_sample(*a, **kw)
    monkeypatch.setattr(T, "deform_sample", wrapper)
    aux = model.forward_train(x)
    (aux["boxes"][-1].sum() + aux["scores"][-1].sum()).backward()
    n = len(model.dec.layers)
    assert calls == [(False, torch.float32, True)] * n
    for lp in model.dec.layers:
        for lin in (lp.ca.off, lp.ca.attw, lp.ca.val):
            assert lin.weight.grad is not None
    assert float(model.dec.layers[0].ca.off.weight.grad.abs().sum()) > 0
    with torch.no_grad():
        model(x, num_queries=8, decoder_layers=1)
    assert len(calls) == n + 1


@pytest.mark.parametrize("route", ["k7", "plain", "paired"])
def test_the_decoder_samples_through_its_sample_argument(route):
    """``Decoder.forward(..., sample=)`` calls the sampling it is given,
    once a layer: each of the profiler's routes gives the default
    decoder's outputs on the CPU (the plain version in either gather
    formulation)."""
    from roadvision_tpu_torch.tools.profile_rtdetr import sampling_of
    model = T.random_model(nc=3, seed=1).eval()
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return sampling_of(route)(*a, **kw)
    with torch.no_grad():
        feats = model.features(torch.rand(2, 64, 64, 3))
        want = model.dec(feats, 8, 2)
        got = model.dec(feats, 8, 2, sample=counted)
    assert len(calls) == 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_anchors_and_embedding_are_built_once_per_shape():
    """The decoder's anchors and AIFI's sincos embedding: made once per
    shape and device, equal to the functions, usable by a training pass
    after an inference pass."""
    model = T.random_model(nc=3, seed=0).eval()
    x = torch.rand(1, 64, 64, 3)
    with torch.inference_mode():
        model(x, num_queries=8, decoder_layers=1)
    shapes = [(8, 8), (4, 4), (2, 2)]
    a1 = model.dec.anchors(shapes, torch.device("cpu"))
    assert a1 is model.dec.anchors(shapes, torch.device("cpu"))
    want = T.anchors_for(shapes)
    assert all(torch.equal(g, w) for g, w in zip(a1, want))
    pos = model.enc.aifi.pos_embed(2, 2, T.HD, torch.device("cpu"),
                                   torch.float32)
    assert torch.equal(pos, T.sincos_pe(2, 2, T.HD))
    assert not pos.is_inference() and not a1[0].is_inference()
    model.train()
    aux = model.forward_train(x)
    (aux["boxes"][-1].sum() + aux["enc_scores"].sum()).backward()
    assert model.dec.enc_output["lin"].weight.grad is not None
