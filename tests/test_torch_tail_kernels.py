"""The plain versions of K4's and K6's boxes modes against the JAX package
(CPU), on inputs made from a seeded numpy generator.

* ``track/sort.py::greedy_associate_boxes_plain`` (what K4's boxes mode
  computes: ``x_to_bbox`` of the predicted means, ``iou_matrix`` against
  the detections, the greedy rounds and the inverse map) against
  ``roadvision_tpu/track/sort_tpu.py``'s ``x_to_bbox`` → ``iou_matrix``
  → ``greedy_associate`` → the step's ``trk2det`` scatter (:498-508):
  both maps exactly equal.
* ``ops/nms.py::nms_batch`` (which calls ``greedy_keep_boxes``, K6's
  boxes mode, and on the CPU its plain version) against
  ``roadvision_tpu/ops/nms.py::nms_single`` image by image: kept boxes,
  classes, anchor indices and validity equal, confidences exact.
* The default SORT step (boxes mode) against the same step with the
  association handed over as a hook (``iou_matrix`` +
  ``greedy_associate`` + the inverse map, the route before the boxes
  mode): states and outputs equal, frame by frame.

* ``track/sort.py::auction_associate_boxes_plain`` (what K5's boxes
  mode computes, the ε-auction in place of the greedy rounds) against
  ``x_to_bbox`` → ``iou_matrix`` → ``auction_associate`` → the scatter,
  and the ``association: hungarian`` default step against JAX's step.
* A model in torch of K5's round as the kernel computes it (the
  bidder-independent columns' top two merged into the live columns' top
  two, the second best floored at -1e9, the column decided by the
  largest 64-bit key) against ``auction_round_plain``'s best column,
  second best, winner and ``has_bid``, round after round, on adversarial
  states: NaN, ±inf and ±0 values and bids, dead columns priced above 0,
  dummies priced above 1e9, ties.

Cases: road scenes, IoU exactly at the threshold (exact in float32),
equal scores, overlapping boxes of different classes, coordinates near
the class offsets, NaN and zero-area boxes, nothing valid, and
T = D = 300 for the association, and a ``max_iters`` cap for the auction.
"""
import functools
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.ops import nms as jnms
from roadvision_tpu.track import sort_tpu as jsort
from roadvision_tpu_torch.ops import nms as tnms
from roadvision_tpu_torch.track import sort as tsort


# ---------------------------------------------------------------------------
# K4: the association's boxes mode

def _road_tracks(rng, p, t, d, tracks, dets, span=240.0):
    """``tracks`` live slots spread over ``t`` whose means predict boxes
    near ``dets`` valid detections (a prefix of ``d``), in a ``span`` px
    canvas."""
    n = max(tracks, dets)
    wh = rng.uniform(12, 40, (p, n, 2))
    xy = rng.uniform(0, span - 40, (p, n, 2))
    mean = rng.normal(0, 20, (p, t, 7)).astype(np.float32)
    alive = np.zeros((p, t), bool)
    for i in range(p):
        slots = rng.choice(t, tracks, replace=False)
        c = xy[i, :tracks] + wh[i, :tracks] / 2 \
            + rng.normal(0, 2, (tracks, 2))
        mean[i, slots, :2] = c
        mean[i, slots, 2] = wh[i, :tracks, 0] * wh[i, :tracks, 1]
        mean[i, slots, 3] = wh[i, :tracks, 0] / wh[i, :tracks, 1]
        alive[i, slots] = True
    boxes = np.zeros((p, d, 4), np.float32)
    dxy = xy[:, :dets] + rng.normal(0, 3, (p, dets, 2))
    boxes[:, :dets] = np.concatenate([dxy, dxy + wh[:, :dets]], -1)
    dvalid = np.zeros((p, d), bool)
    dvalid[:, :dets] = True
    return mean, boxes, alive, dvalid


def _assoc_case(name):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    if name == "road":
        return _road_tracks(rng, 3, 24, 24, 9, 7) + (0.35,)
    if name.startswith("at threshold"):
        # x_to_bbox((5 + 20i, 5, 100, 1)) = (20i, 0, 20i + 10, 10)
        # exactly; detections (0, 0, 10, 5), (0, 0, 10, 2.5), (0, 0, 5, 5)
        # shifted alike have IoU 0.5, 0.25 and 0.25 with it
        mean = np.zeros((2, 12, 7), np.float32)
        mean[:, :, :4] = (5, 5, 100, 1)
        mean[:, :, 0] += np.arange(12) * 20.0
        shapes = np.array([[0, 0, 10, 5], [0, 0, 10, 2.5], [0, 0, 5, 5]],
                          np.float32)
        boxes = shapes[rng.randint(0, 3, (2, 12))]
        boxes[..., ::2] += np.arange(12)[:, None] * 20.0
        ones = np.ones((2, 12), bool)
        return mean, boxes, ones, ones.copy(), float(name.split()[-1])
    if name == "equal scores":
        mean, boxes, alive, dvalid = _road_tracks(rng, 2, 16, 16, 8, 8)
        mean[:, 1::2] = mean[:, 0::2]          # twin tracks
        boxes[:, 1::2] = boxes[:, 0::2]        # twin detections
        return mean, boxes, alive | np.roll(alive, 1, 1), dvalid, 0.35
    if name == "nan and zero area":
        mean, boxes, alive, dvalid = _road_tracks(rng, 2, 24, 24, 16, 16)
        mean[:, 2::5, 2] = 0.0                 # zero-area predictions
        mean[:, 3::7, 0] = np.nan
        mean[:, 4::9, 3] = np.inf
        boxes[:, 1::4, 2] = boxes[:, 1::4, 0]  # zero-width detections
        boxes[:, 2::6, 1] = np.nan
        boxes[:, 5::7, 3] = np.inf
        return mean, boxes, alive, dvalid, 0.3
    if name == "nothing valid":
        mean, boxes, alive, dvalid = _road_tracks(rng, 2, 16, 16, 8, 8)
        alive[0] = False
        dvalid[1] = False
        return mean, boxes, alive, dvalid, 0.35
    assert name == "T = D = 300"
    return _road_tracks(rng, 1, 300, 300, 60, 40, span=256.0) + (0.2,)


ASSOC_CASES = ("road", "at threshold 0.5", "at threshold 0.25",
               "equal scores", "nan and zero area", "nothing valid",
               "T = D = 300")


@functools.lru_cache(maxsize=None)
def _jax_assoc_fn(num_t, num_d, thresh):
    def one(mean, boxes, alive, dvalid):
        iou = jsort.iou_matrix(jsort.x_to_bbox(mean), boxes)
        det2trk = jsort.greedy_associate(iou, alive, dvalid, thresh)
        trk2det = jnp.full((num_t,), -1, jnp.int32).at[
            jnp.where(det2trk >= 0, det2trk, num_t)
        ].set(jnp.arange(num_d, dtype=jnp.int32), mode="drop")
        return det2trk, trk2det
    return jax.jit(jax.vmap(one))


@pytest.fixture(scope="module")
def jax_assoc():
    """Every association case through the JAX functions, once."""
    out = {}
    for name in ASSOC_CASES:
        mean, boxes, alive, dvalid, thresh = _assoc_case(name)
        fn = _jax_assoc_fn(mean.shape[1], boxes.shape[1], thresh)
        out[name] = [np.asarray(a) for a in fn(mean, boxes, alive, dvalid)]
    return out


@pytest.mark.parametrize("name", ASSOC_CASES)
def test_greedy_associate_boxes_plain_equals_jax(jax_assoc, name):
    mean, boxes, alive, dvalid, thresh = _assoc_case(name)
    args = [torch.from_numpy(a) for a in (mean, boxes, alive, dvalid)]
    got = tsort.greedy_associate_boxes_plain(*args, thresh)
    want = jax_assoc[name]
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    # the wrapper takes the plain version for a CPU tensor
    for g, w in zip(tsort.greedy_associate_boxes(*args, thresh), got):
        assert torch.equal(g, w)
    if name in ("road", "equal scores", "nan and zero area", "T = D = 300"):
        assert bool((got[0] >= 0).any())
    if name.startswith("at threshold"):
        # every track has a detection at IoU 0.5 or 0.25: the threshold
        # is inclusive (>=)
        iou = tsort.iou_matrix(tsort.x_to_bbox(args[0]), args[1])
        at = (iou == thresh).any(dim=-1)
        assert at.any() and bool((got[1][at] >= 0).all())


def test_boxes_mode_refuses_what_it_cannot_take():
    mean = torch.zeros((1, 4, 7))
    boxes = torch.zeros((1, 3, 4))
    alive = torch.ones((1, 4), dtype=torch.bool)
    dvalid = torch.ones((1, 3), dtype=torch.bool)
    with pytest.raises(ValueError):
        tsort.greedy_associate_boxes(mean[0], boxes[0], alive[0],
                                     dvalid[0], 0.3)
    with pytest.raises(ValueError):
        tsort.greedy_associate_boxes(mean, boxes, alive[:, :3], dvalid, 0.3)
    with pytest.raises(ValueError):
        tnms.greedy_keep_boxes(boxes, torch.zeros((1, 2), dtype=torch.int32),
                               dvalid, 0.5)
    with pytest.raises(ValueError):
        tnms.greedy_keep_boxes(boxes, torch.zeros((1, 3), dtype=torch.int32),
                               dvalid.to(torch.uint8), 0.5)


@pytest.mark.parametrize("seed", [0, 1])
def test_default_step_equals_the_step_with_its_association_hooked(seed):
    """The default step's association (boxes mode: IoU, rounds and
    inverse map in one call) gives the states and outputs of the same
    step whose association is handed over as a hook, which takes the
    route the step took before (iou_matrix, greedy_associate, the
    inverse map)."""
    thresh = 0.35
    rng = np.random.RandomState(seed)
    num_t, num_d, frames = 16, 10, 8
    base = rng.uniform(20, 200, (num_d, 2))
    vel = rng.uniform(-5, 5, (num_d, 2))
    size = rng.uniform(15, 40, (num_d, 2))

    def hook(iou, alive, dvalid, conf, ctx):
        return tsort.greedy_associate(iou, alive, dvalid, thresh)

    default = tsort.make_sort_step(thresh, 1.2, 0.8)
    hooked = tsort.make_sort_step(thresh, 1.2, 0.8, associate_fn=hook)
    states = [tsort.init_state(num_t, "cpu") for _ in range(2)]
    for f in range(frames):
        xy = base + vel * f + rng.normal(0, 1.5, (num_d, 2))
        boxes = torch.from_numpy(np.concatenate([xy, xy + size], -1)
                                 .astype(np.float32))
        valid = torch.from_numpy(rng.rand(num_d) < 0.8)
        cls = torch.full((num_d,), 2, dtype=torch.int32)
        conf = torch.full((num_d,), 0.9)
        ts = torch.tensor(f / 30.0)
        outs = []
        for i, step in enumerate((default, hooked)):
            states[i], out = step(states[i], boxes, cls, conf, valid, ts,
                                  None)
            outs.append(out)
        for a, b in zip(outs[0], outs[1]):
            assert torch.equal(a, b) or torch.allclose(
                a, b, rtol=0, atol=0, equal_nan=True)
        for a, b in zip(*states):
            assert torch.equal(a, b) or torch.allclose(
                a, b, rtol=0, atol=0, equal_nan=True)
    assert int((outs[0].track_id > 0).sum()) > 0


# ---------------------------------------------------------------------------
# K5: the auction's boxes mode, the hungarian step, the kernel's round

AUCTION_CASES = ASSOC_CASES + ("max_iters cap",)


def _auction_case(name):
    """(mean, boxes, alive, dvalid, thresh, max_iters): the K4 cases with
    the auction's default cap, and twin tracks and detections cut after
    2 rounds."""
    if name == "max_iters cap":
        return _assoc_case("equal scores")[:4] + (0.1, 2)
    return _assoc_case(name) + (512,)


@functools.lru_cache(maxsize=None)
def _jax_auction_fn(num_t, num_d, thresh, max_iters):
    def one(mean, boxes, alive, dvalid):
        iou = jsort.iou_matrix(jsort.x_to_bbox(mean), boxes)
        det2trk = jsort.auction_associate(iou, alive, dvalid, thresh,
                                          0.01, max_iters)
        trk2det = jnp.full((num_t,), -1, jnp.int32).at[
            jnp.where(det2trk >= 0, det2trk, num_t)
        ].set(jnp.arange(num_d, dtype=jnp.int32), mode="drop")
        return det2trk, trk2det
    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("name", AUCTION_CASES)
def test_auction_associate_boxes_plain_equals_jax(name):
    mean, boxes, alive, dvalid, thresh, iters = _auction_case(name)
    fn = _jax_auction_fn(mean.shape[1], boxes.shape[1], thresh, iters)
    want = [np.asarray(a) for a in fn(mean, boxes, alive, dvalid)]
    args = [torch.from_numpy(a) for a in (mean, boxes, alive, dvalid)]
    got = tsort.auction_associate_boxes_plain(*args, thresh,
                                              max_iters=iters)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(tsort.auction_associate_boxes(*args, thresh,
                                                  max_iters=iters), got):
        assert torch.equal(g, w)
    if name != "nothing valid":
        assert bool((got[0] >= 0).any())
    if name == "max_iters cap":
        # the cap cuts the auction short: the uncapped run matches more
        full = tsort.auction_associate_boxes_plain(*args, thresh)
        assert int((full[0] >= 0).sum()) > int((got[0] >= 0).sum())


def test_hungarian_default_step_equals_jax():
    """``association: hungarian`` without hooks (K5's boxes mode on the
    card, its plain version here) against JAX's step, frame by frame:
    ids exact, the Kalman state within the tracker tests' rtol 1e-5 /
    atol 1e-4 (the area rate within 2e-2)."""
    thresh = 0.35
    rng = np.random.RandomState(5)
    num_t, num_d, frames = 16, 10, 10
    base = rng.uniform(20, 200, (num_d, 2))
    vel = rng.uniform(-5, 5, (num_d, 2))
    size = rng.uniform(15, 40, (num_d, 2))
    jstep = jax.jit(jsort.make_sort_step(thresh, 1.2, 0.8,
                                         association="hungarian"))
    tstep = tsort.make_sort_step(thresh, 1.2, 0.8, association="hungarian")
    js, ts = jsort.init_state(num_t), tsort.init_state(num_t, "cpu")
    for f in range(frames):
        xy = base + vel * f + rng.normal(0, 1.5, (num_d, 2))
        boxes = np.concatenate([xy, xy + size], -1).astype(np.float32)
        valid = rng.rand(num_d) < 0.8
        cls = np.full((num_d,), 2, np.int32)
        conf = np.full((num_d,), 0.9, np.float32)
        t = np.float32(f / 30.0)
        args = (boxes, cls, conf, valid, t)
        js, jo = jstep(js, *map(jnp.asarray, args), None)
        ts, to = tstep(ts, *(torch.from_numpy(np.asarray(a)) for a in args),
                       None)
        np.testing.assert_array_equal(to.track_id.numpy(),
                                      np.asarray(jo.track_id),
                                      err_msg=f"frame {f}")
    for k in tsort.SortState._fields:
        a, b = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        if k in ("mean", "obs_mean"):
            # the area rate of a box that keeps its size is the float
            # noise of its area over 1/30 s (tests/test_torch_raw_step.py)
            np.testing.assert_allclose(a[..., 6], b[..., 6], rtol=0,
                                       atol=2e-2, err_msg=k)
            a, b = a[..., :6], b[..., :6]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4,
                                   equal_nan=True, err_msg=k)
    assert int(np.asarray(js.next_id)) > num_d


NEG_INF_BITS = 0x007FFFFF     # the kernel's key bits of a -inf bid
NAN_BITS = 0xFFFFFFFF         # of every NaN bid


def _key_bits(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving 32 bits of float32 bids (int64):
    ±0 alike, every NaN the top."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(x == 0, torch.zeros_like(u), u)
    k = torch.where(u >= 2 ** 31, (~u) & 0xFFFFFFFF, u | 2 ** 31)
    return torch.where(torch.isnan(x), torch.full_like(k, NAN_BITS), k)


def _top2(vals: torch.Tensor, cols: torch.Tensor):
    """Each row's top two over the columns ``cols``: the first NaN, else
    the first maximum (v1 at i1), and the NaN-propagating maximum of the
    other values (v2, -inf for none); an empty set is (-inf, 2**31, -inf)."""
    rows = vals.shape[0]
    if cols.numel() == 0:
        return (torch.full((rows,), float("-inf")),
                torch.full((rows,), 2 ** 31, dtype=torch.int64),
                torch.full((rows,), float("-inf")))
    k = vals.argmax(dim=-1)
    v1 = vals.gather(-1, k[:, None])[:, 0]
    rest = vals.scatter(-1, k[:, None], float("-inf"))
    return v1, cols[k], rest.max(dim=-1).values


def _merge(a, b):
    """The kernel's top2_merge: b's first replaces a's if it ranks above
    (NaN, then larger, then lower index)."""
    a1, ai, a2 = a
    b1, bi, b2 = b
    take = torch.where(torch.isnan(a1), torch.isnan(b1) & (bi < ai),
                       torch.isnan(b1) | (b1 > a1) | ((b1 == a1) & (bi < ai)))
    return (torch.where(take, b1, a1), torch.where(take, bi, ai),
            torch.where(take, torch.maximum(a1, b2), torch.maximum(a2, b1)))


def _kernel_round(w, prices, assigned, dvalid, alive, eps):
    """K5's round in torch, for one problem of the association (values
    ``w`` (D, T + D)): the live tracks' top two per bidder, the dead
    tracks' and the dummies' once from their prices alone (-1e9 - price,
    -1 - price), merged; v2 floored at -1e9; each bid as the key
    (bits << 32 | ~bidder), a column's decision its largest key.
    → best, v2, winner, has_bid as auction_round_plain gives them."""
    num_d, num_c = w.shape
    num_t = num_c - num_d
    values = w - prices[None]
    live = torch.nonzero(alive).flatten()
    shared = torch.cat([torch.nonzero(~alive).flatten(),
                        torch.arange(num_t, num_c)])
    base = torch.where(shared < num_t, torch.tensor(-1e9), torch.tensor(-1.0))
    s1, si, s2 = _top2((base - prices[shared])[None], shared)
    top = _merge(_top2(values[:, live], live),
                 (s1.expand(num_d), si.expand(num_d), s2.expand(num_d)))
    v1, best, second = top
    v2 = torch.where(torch.isnan(second), second,
                     torch.maximum(torch.tensor(-1e9), second))
    incr = v1 - v2 + eps
    bidding = (assigned < 0) & dvalid
    d_ids = torch.arange(num_d, dtype=torch.int64)
    # the uint64 key as an int64 of the same order: top bit flipped
    key = (_key_bits(incr) - 2 ** 31) * 2 ** 32 + (0xFFFFFFFF - d_ids)
    top_key = torch.full((num_c,), -2 ** 63, dtype=torch.int64).scatter_reduce(
        0, best[bidding], key[bidding], reduce="amax")
    hi = torch.div(top_key, 2 ** 32, rounding_mode="floor") + 2 ** 31
    has_bid = (top_key > -2 ** 63) & (hi > NEG_INF_BITS) & (hi != NAN_BITS)
    winner = 0xFFFFFFFF - (top_key - (hi - 2 ** 31) * 2 ** 32)
    return best, v2, winner, has_bid, bidding


def _round_state(name, rng):
    """(iou (T, D), alive, dvalid, prices, assigned, eps): adversarial
    states of the association's auction."""
    num_t, num_d = (6, 5) if name != "wide" else (40, 33)
    pal = np.float32([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 0.5, 1.0,
                      -2e9, 3e-8])
    iou = pal[rng.randint(0, len(pal), (num_t, num_d))]
    alive = rng.rand(num_t) < 0.6
    dvalid = rng.rand(num_d) < 0.85
    prices = np.zeros(num_t + num_d, np.float32)
    eps = 0.01
    if name == "floor":
        # dummies priced above 1e9, dead tracks above 0, live tracks
        # scored below -1e9: a bidder's runner-up is under -1e9
        iou[:] = -2e9
        iou[0] = 0.25
        alive[:] = False
        alive[0] = True
        prices[1:num_t] = 1e3          # -1e9 - 1e3 < -1e9 in float32
        prices[num_t:] = 4e9
        dvalid[:] = True
    elif name == "signed zeros":
        iou = pal[rng.randint(3, 5, (num_t, num_d))]
        eps = -0.0
    elif name == "ties":
        iou = pal[rng.choice([5, 6, 3], (num_t, num_d))]
        eps = 0.0
    elif name == "prices":
        prices = pal[rng.randint(1, len(pal), num_t + num_d)] * 0.5
        prices[np.isinf(prices)] = 1e10
    assigned = np.full(num_d, -1, np.int64)
    taken = rng.permutation(num_t + num_d)[:num_d]
    own = rng.rand(num_d) < 0.3
    assigned[own] = taken[own]
    return iou, alive, dvalid, prices, assigned, eps


@pytest.mark.parametrize("name", ["random", "wide", "floor", "signed zeros",
                                  "ties", "prices"])
def test_kernel_round_model_equals_the_plain_round(name):
    """The CPU evidence for K5's bit-equality: its round, modelled in
    torch as the kernel computes it, gives auction_round_plain's best
    column and second best for every bidder that bids, and its winner and
    ``has_bid`` for every column, round after round (20 rounds from the
    plain version's own states)."""
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    iou, alive, dvalid, prices, assigned, eps = (
        torch.from_numpy(np.asarray(a)) if not isinstance(a, float) else a
        for a in _round_state(name, rng))
    w = tsort.auction_values_plain(iou, alive, dvalid)
    floor_seen = nan_bids = zero_bids = 0
    for r in range(20):
        best, v2, winner, has_bid, bidding = _kernel_round(
            w, prices, assigned, dvalid, alive, eps)
        nxt = tsort.auction_round_plain(w, prices, assigned, dvalid, eps)
        p_best, p_v2, p_winner, p_has = nxt[2:]
        assert torch.equal(best[bidding], p_best[bidding]), (name, r)
        torch.testing.assert_close(v2[bidding], p_v2[bidding], rtol=0,
                                   atol=0, equal_nan=True)
        assert torch.equal(has_bid, p_has), (name, r)
        assert torch.equal(winner[has_bid], p_winner[has_bid]), (name, r)
        incr = (w - prices).max(dim=-1).values - p_v2 + eps
        floor_seen += int((bidding & (p_v2 == -1e9)).sum())
        nan_bids += int((bidding & torch.isnan(incr)).sum())
        zero_bids += int((bidding & (incr == 0)).sum())
        prices, assigned = nxt[:2]
    if name == "floor":
        assert floor_seen > 0
    if name == "random":
        assert nan_bids > 0
    if name in ("signed zeros", "ties"):
        assert zero_bids > 0


def test_bid_keys_order_as_the_plain_column_decision():
    """The 64-bit key of every pair of bids, NaN, ±inf, ±0 and numbers
    among them, orders as the plain version's ``max`` / ``argmax`` over
    the bidders of one column: NaN above all, then larger, then the lower
    bidder; ±0 one bid."""
    bids = torch.tensor([float("nan"), float("inf"), 1.0, 0.0, -0.0, -1.0,
                         float("-inf")], dtype=torch.float32)
    for i in range(len(bids)):
        for j in range(len(bids)):
            pair = torch.stack([bids[i], bids[j]])
            key = (_key_bits(pair) - 2 ** 31) * 2 ** 32 \
                + (0xFFFFFFFF - torch.arange(2))
            top = pair.max()
            first = int(pair.argmax())
            assert int(key.argmax()) == first, (float(pair[0]),
                                                float(pair[1]))
            hi = int(_key_bits(pair[first:first + 1])[0])
            assert (hi > NEG_INF_BITS and hi != NAN_BITS) \
                == bool(top > float("-inf"))


# ---------------------------------------------------------------------------
# K6: NMS's boxes mode, through nms_batch

NC = 8


def _nms_case(name):
    """(boxes (B, N, 4), scores (B, N, NC), keyword arguments)."""
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    b, n = 2, 360
    kw = dict(conf_thres=0.25, iou_thres=0.7, max_det=100, pre_topk=300)
    scores = rng.uniform(0, 0.2, (b, n, NC)).astype(np.float32)
    if name in ("road", "nan and zero area"):
        objects = 12
        wh = rng.uniform(12, 50, (b, objects, 2))
        xy = rng.uniform(0, 200, (b, objects, 2))
        ocls = rng.randint(0, NC, (b, objects))
        who = rng.randint(0, objects, (b, n))
        c = np.take_along_axis(xy + wh / 2, who[..., None], 1) \
            + rng.normal(0, 2, (b, n, 2))
        half = np.take_along_axis(wh, who[..., None], 1) / 2 \
            * rng.uniform(0.85, 1.15, (b, n, 2))
        boxes = np.concatenate([c - half, c + half], -1).astype(np.float32)
        cls = np.take_along_axis(ocls, who, 1)
        np.put_along_axis(scores, cls[..., None],
                          rng.uniform(0.1, 0.95, (b, n, 1)).astype(
                              np.float32), -1)
        if name == "nan and zero area":
            boxes[:, 3::7, 0] = np.nan
            boxes[:, 5::11, 3] = np.inf
            boxes[:, 2::5, 2] = boxes[:, 2::5, 0]      # zero width
            boxes[:, 6::9] = boxes[:, 6::9, :1]        # a point
        return boxes, scores, kw
    # the rest: candidates on a grid of 20 px cells, four boxes a cell
    cell = (np.arange(n) // 4 * 20.0) % 240.0
    row = np.arange(n) // 48 * 20.0
    boxes = np.zeros((b, n, 4), np.float32)
    shapes = np.array([[0, 0, 10, 10], [0, 0, 10, 5], [0, 0, 5, 5],
                       [0, 0, 10, 2.5]], np.float32)
    boxes[:] = shapes[np.arange(n) % 4]
    boxes[..., ::2] += cell[:, None]
    boxes[..., 1::2] += row[:, None]
    cls = np.zeros((b, n), np.int64)
    top = rng.uniform(0.3, 0.95, (b, n)).astype(np.float32)
    if name.startswith("at threshold"):
        kw["iou_thres"] = float(name.split()[-1])
    elif name == "equal scores":
        top[:] = 0.5
        kw["iou_thres"] = 0.3
    elif name == "different classes overlapping":
        boxes[:] = boxes[:, :1]
        cls = rng.randint(0, NC, (b, n))
    elif name == "near the class offsets":
        # a class-0 box near (7680, 7680) meets a class-1 box near (0, 0)
        boxes[:, 0::2] = [7670, 7672, 7690, 7695]
        boxes[:, 1::2] = [-8, -6, 12, 16]
        boxes += rng.normal(0, 2, boxes.shape).astype(np.float32)
        cls = np.tile([0, 1], (b, n // 2))
        kw["iou_thres"] = 0.3
    elif name == "nothing valid":
        top[:] = 0.2
    else:
        raise AssertionError(name)
    np.put_along_axis(scores, cls[..., None], top[..., None], -1)
    return boxes, scores, kw


NMS_CASES = ("road", "at threshold 0.5", "at threshold 0.25",
             "equal scores", "different classes overlapping",
             "near the class offsets", "nan and zero area", "nothing valid")


@pytest.fixture(scope="module")
def jax_nms():
    """Every NMS case through JAX's nms_single, image by image, once."""
    out = {}
    for name in NMS_CASES:
        boxes, scores, kw = _nms_case(name)
        per = [jnms.nms_single(boxes[i], scores[i], return_idx=True, **kw)
               for i in range(boxes.shape[0])]
        out[name] = [np.stack([np.asarray(p[j]) for p in per])
                     for j in range(5)]
    return out


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_batch_boxes_mode_equals_jax(jax_nms, name):
    boxes, scores, kw = _nms_case(name)
    got = tnms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores),
                         return_idx=True, **kw)
    want = jax_nms[name]
    for what, g, w in zip(("boxes", "conf", "cls", "valid", "idx"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    if name != "nothing valid":
        assert bool(got[3].any())
    else:
        assert not bool(got[3].any())


@pytest.mark.parametrize("name", ["at threshold 0.5", "near the class offsets",
                                  "different classes overlapping"])
def test_greedy_keep_boxes_plain_is_the_torch_composition(name):
    """The boxes mode's plain version is the class offset, the torch IoU,
    ``> iou_thres`` and the plain keep; at IoU exactly 0.5 the strict
    test keeps both boxes of a pair."""
    boxes, scores, kw = _nms_case(name)
    sel_scores, sel_idx, sel_cls, sel_valid = tnms.select_candidates(
        torch.from_numpy(scores), kw["conf_thres"], kw["pre_topk"])
    k = sel_idx.shape[1]
    sel_boxes = torch.gather(torch.from_numpy(boxes), 1,
                             sel_idx[..., None].expand(-1, k, 4))
    off = sel_cls.to(torch.float32)[..., None] * tnms.MAX_WH
    iou = tnms.iou_matrix_xyxy(sel_boxes + off)
    want = tnms.greedy_keep_plain(iou > kw["iou_thres"], sel_valid)
    got = tnms.greedy_keep_boxes(sel_boxes, sel_cls, sel_valid,
                                 kw["iou_thres"])
    assert torch.equal(got, want)
    if name == "at threshold 0.5":
        assert bool((iou == 0.5).any())
    if name == "near the class offsets":
        # the two classes overlap once offset: suppression crosses them
        assert bool(((iou > 0.3) & (sel_cls[..., :, None]
                                    != sel_cls[..., None, :])).any())
        assert int(got.sum()) < int(sel_valid.sum())
