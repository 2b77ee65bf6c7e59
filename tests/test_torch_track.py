"""roadvision_tpu_torch SORT vs the JAX step and the scalar oracle (CPU).

Scripted scenarios drive the JAX ``make_sort_step`` and the port's step
frame by frame on identical fixed-capacity detection sets. Track ids
must be identical; distances and speeds agree within float32 noise
(rtol 1e-3: the Kalman solve and hypot round differently in the two
libraries). The same scenarios also go through
``tests/oracles/sort_oracle.py``, the float64 reading of the reference.

The host API (``SortTracker``, the registry, ``interpolate_gaps``) and
the NSA Kalman are held the same way: ids bit-equal, NSA's Kalman state
within 1e-5 relative (of each array's largest magnitude), and a state
taken over from the JAX step by ``state_from_jax`` continues with the
JAX ids.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.geometry import build_projector as jbuild_projector
from roadvision_tpu.detect.types import Detection as JDetection
from roadvision_tpu.track import build_tracker as jbuild_tracker
from roadvision_tpu.track import sort_tpu as jsort
from roadvision_tpu.track.postprocess import interpolate_gaps as jinterp
from roadvision_tpu_torch.detect import Detection
from roadvision_tpu_torch.geometry import build_projector as tbuild_projector
from roadvision_tpu_torch.track import (SortTracker, Tracker,
                                        build_device_step, build_tracker,
                                        interpolate_gaps)
from roadvision_tpu_torch.track import sort as tsort
from tests.oracles.sort_oracle import SortOracle

CFG = dict(iou_threshold=0.35, max_staleness=1.2, speed_window=0.8)
D, T = 8, 16
_JSTEP = jax.jit(jsort.make_sort_step(**CFG))


def _proj_cfg():
    return {"projector": {
        "type": "homography",
        "image_points": [[0, 480], [640, 480], [0, 80], [640, 80]],
        "world_points": [[0.0, 0.0], [6.4, 0.0], [0.0, 40.0], [6.4, 40.0]],
        "origin": [3.2, -2.0], "max_distance": 35.0}}


def _pack(boxes):
    b = np.zeros((D, 4), np.float32)
    v = np.zeros((D,), bool)
    for i, box in enumerate(boxes):
        b[i] = box
        v[i] = True
    return b, v


def _drive(seq, with_proj=True):
    """[(dt, boxes), ...] → per frame (jax ids, dist, speed), (torch ...),
    oracle outputs."""
    jstep = _JSTEP
    tstep = tsort.make_sort_step(**CFG)
    jstate, tstate = jsort.init_state(T), tsort.init_state(T, device="cpu")
    jp = tp = oproj = None
    if with_proj:
        jpr = jbuild_projector(_proj_cfg())
        jp = jpr.device_params()
        tp = tbuild_projector(_proj_cfg(), device="cpu").device_params()
        oproj = jpr
    oracle = SortOracle(CFG["max_staleness"], 3, CFG["iou_threshold"],
                        CFG["speed_window"])
    cls = np.full((D,), 2, np.int32)
    conf = np.full((D,), 0.9, np.float32)
    t = 0.0
    out = []
    for dt, boxes in seq:
        t += dt
        b, v = _pack(boxes)
        jstate, jo = jstep(jstate, jnp.asarray(b), jnp.asarray(cls),
                           jnp.asarray(conf), jnp.asarray(v),
                           jnp.float32(t), jp)
        tstate, to = tstep(tstate, torch.from_numpy(b), torch.from_numpy(cls),
                           torch.from_numpy(conf), torch.from_numpy(v),
                           torch.tensor(t, dtype=torch.float32), tp)
        want = oracle.update([tuple(x) for x in boxes], t, projector=oproj)
        out.append(([np.asarray(a) for a in jo], [a.numpy() for a in to],
                    want, len(boxes)))
    return out


def _check(out):
    for f, (j, t, oracle, n) in enumerate(out):
        np.testing.assert_array_equal(t[0], j[0], err_msg=f"ids, frame {f}")
        for k in (1, 2):
            np.testing.assert_array_equal(np.isnan(t[k]), np.isnan(j[k]))
            np.testing.assert_allclose(t[k], j[k], rtol=1e-3, atol=1e-3,
                                       equal_nan=True)
        assert [int(i) for i in t[0][:n]] == [w["id"] for w in oracle], f


def _crossing():
    seq = []
    for f in range(12):
        a = (10 + 8 * f, 100, 60 + 8 * f, 150)
        b = (110 - 8 * f, 102, 160 - 8 * f, 152)
        seq.append((1 / 30, [a, b]))
    return seq


def _random_objects():
    rng = np.random.RandomState(42)
    pos = rng.uniform(50, 400, (6, 2))
    vel = rng.uniform(-5, 5, (6, 2))
    seq = []
    for f in range(15):
        boxes = []
        for k in range(6):
            if (f > 10 and k in (1, 3)) or (f < 3 and k == 5):
                continue
            x, y = pos[k] + vel[k] * f
            boxes.append((x, y, x + 45, y + 40))
        seq.append((1 / 30, boxes))
    return seq


SCENARIOS = {
    "ids_in_det_order": [(0.0, [(0, 0, 10, 10), (50, 50, 70, 70),
                                (200, 10, 240, 60)])],
    "greedy_tie_breaking": [(0.0, [(0, 0, 40, 40), (100, 0, 140, 40)]),
                            (1 / 30, [(90, 0, 130, 40), (98, 2, 138, 42)])],
    "crossing": _crossing(),
    "missed_then_reacquired": [(1 / 30, [(100, 100, 150, 150)])] * 3
    + [(0.5, [])] + [(1 / 30, [(102, 101, 152, 151)])],
    "staleness_prunes": [(1 / 30, [(100, 100, 150, 150)])] * 2
    + [(1.5, [(100, 100, 150, 150)])],
    "approach_with_speed": [(1 / 30, [(300, 120 + 20 * f, 340, 200 + 20 * f)])
                            for f in range(8)],
    "speed_window_expiry": [(0.3, [(300, 150 + 30 * f, 340, 230 + 30 * f)])
                            for f in range(8)],
    "many_objects": _random_objects(),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sort_matches_jax_step_and_oracle(name):
    _check(_drive(SCENARIOS[name]))


def test_sort_without_projector_matches_jax():
    out = _drive(_crossing(), with_proj=False)
    for j, t, _, _ in out:
        np.testing.assert_array_equal(t[0], j[0])
        assert np.isnan(t[1]).all() and np.isnan(t[2]).all()


def test_slot_overflow_keeps_ids_and_drops_tracks():
    """More new detections than free slots: ids still count up in det
    order; the overflow gets an id but no slot (as the JAX step)."""
    jstep = jsort.make_sort_step(**CFG)
    tstep = tsort.make_sort_step(**CFG)
    boxes = np.array([[40 * i, 0, 40 * i + 30, 30] for i in range(D)],
                     np.float32)
    cls = np.zeros((D,), np.int32)
    conf = np.full((D,), 0.5, np.float32)
    v = np.ones((D,), bool)
    js, jo = jstep(jsort.init_state(4), jnp.asarray(boxes), jnp.asarray(cls),
                   jnp.asarray(conf), jnp.asarray(v), jnp.float32(0.1))
    ts_, to = tstep(tsort.init_state(4, device="cpu"),
                    torch.from_numpy(boxes),
                    torch.from_numpy(cls), torch.from_numpy(conf),
                    torch.from_numpy(v), torch.tensor(0.1))
    np.testing.assert_array_equal(to.track_id.numpy(), np.asarray(jo.track_id))
    np.testing.assert_array_equal(ts_.ids.numpy(), np.asarray(js.ids))
    assert int(ts_.next_id) == int(js.next_id) == D + 1


def test_greedy_associate_matches_jax_with_ties():
    rng = np.random.RandomState(7)
    iou = (rng.randint(0, 6, (12, 9)) / 5.0).astype(np.float32)   # ties
    alive = rng.rand(12) > 0.2
    dvalid = rng.rand(9) > 0.2
    want = np.asarray(jsort.greedy_associate(
        jnp.asarray(iou), jnp.asarray(alive), jnp.asarray(dvalid), 0.35))
    got = tsort.greedy_associate(torch.from_numpy(iou),
                                 torch.from_numpy(alive),
                                 torch.from_numpy(dvalid), 0.35)
    np.testing.assert_array_equal(got.numpy(), want)


def test_iou_matrix_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 100, (7, 4)).astype(np.float32)
    b = rng.uniform(0, 100, (5, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(
        tsort.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jsort.iou_matrix(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("cfg", [{"backend": "bytetrack"},
                                 {"association": "hungarian"},
                                 {"gmc": True}])
def test_unported_tracking_configs_raise(cfg):
    """These configs raised ``NotImplementedError`` before they were
    ported; each now builds a step that runs a frame (held against JAX in
    tests/test_torch_trackers.py)."""
    step = build_device_step(cfg)
    b, v = _pack([(0, 0, 10, 10), (50, 50, 70, 70)])
    state, out = step(tsort.init_state(T, device="cpu"),
                      torch.from_numpy(b), torch.zeros(D, dtype=torch.int32),
                      torch.full((D,), 0.9), torch.from_numpy(v),
                      torch.tensor(0.0), None, None,
                      torch.zeros(2) if cfg.get("gmc") else None)
    assert out.track_id[:2].tolist() == [1, 2]


def test_registry_names():
    from roadvision_tpu_torch.track import BotSortTracker
    assert isinstance(build_tracker({"backend": "botsort"}, device="cpu"),
                      BotSortTracker)
    with pytest.raises(ValueError, match="unknown tracking backend"):
        build_tracker({"backend": "kalman9000"}, device="cpu")
    with pytest.raises(ValueError, match="unknown tracking backend"):
        build_device_step({"backend": "kalman9000"})
    trk = build_tracker({"backend": "sort", "nsa": True}, device="cpu")
    assert isinstance(trk, SortTracker) and isinstance(trk, Tracker)
    assert trk.nsa and trk.track_slots == 100 and trk.det_capacity == 100
    assert callable(build_device_step({"nsa": True}))


def _conf_for(f, k):
    return np.float32(0.35 + 0.6 * ((7 * f + 3 * k) % 10) / 10.0)


@pytest.mark.parametrize("name", ["crossing", "many_objects",
                                  "missed_then_reacquired"])
def test_nsa_ids_bit_equal_and_kalman_state_close(name):
    """NSA on, confidences varying per detection and frame (one at 1.0
    hits the 1e-3 floor): ids bit-equal in every frame; the Kalman mean
    and covariance stay within 1e-5 of each array's largest magnitude."""
    cfg = dict(CFG, nsa=True)
    jstep = jax.jit(jsort.make_sort_step(**cfg))
    tstep = tsort.make_sort_step(**cfg)
    jstate, tstate = jsort.init_state(T), tsort.init_state(T, device="cpu")
    cls = np.full((D,), 2, np.int32)
    t = 0.0
    differs_from_plain = False
    pstate = tsort.init_state(T, device="cpu")
    pstep = tsort.make_sort_step(**CFG)
    for f, (dt, boxes) in enumerate(SCENARIOS[name]):
        t += dt
        b, v = _pack(boxes)
        conf = np.array([_conf_for(f, k) for k in range(D)], np.float32)
        conf[0] = 1.0
        jstate, jo = jstep(jstate, jnp.asarray(b), jnp.asarray(cls),
                           jnp.asarray(conf), jnp.asarray(v),
                           jnp.float32(t), None)
        args = (torch.from_numpy(b), torch.from_numpy(cls),
                torch.from_numpy(conf), torch.from_numpy(v),
                torch.tensor(t, dtype=torch.float32), None)
        tstate, to = tstep(tstate, *args)
        pstate, _ = pstep(pstate, *args)
        np.testing.assert_array_equal(to.track_id.numpy(),
                                      np.asarray(jo.track_id))
        for field in ("mean", "cov"):
            want = np.asarray(getattr(jstate, field))
            got = getattr(tstate, field).numpy()
            alive = np.asarray(jstate.alive)
            scale = np.abs(want[alive]).max() if alive.any() else 1.0
            np.testing.assert_allclose(got[alive], want[alive], rtol=0,
                                       atol=1e-5 * scale, err_msg=field)
        differs_from_plain |= not torch.equal(tstate.mean, pstate.mean)
    assert differs_from_plain        # NSA did change the update
    np.testing.assert_array_equal(
        tsort.nsa_r_scale(torch.tensor([0.0, 0.4, 0.9995, 1.0])).numpy(),
        np.asarray(jsort.nsa_r_scale(jnp.asarray([0.0, 0.4, 0.9995, 1.0]))))


def _dets(cls_type, boxes, f):
    return [cls_type(*map(float, box), float(_conf_for(f, k)), 2, "car",
                     track_id=99, distance_m=1.0, speed_kmh=2.0)
            for k, box in enumerate(boxes)]


@pytest.mark.parametrize("nsa", [False, True])
@pytest.mark.parametrize("name", ["crossing", "many_objects",
                                  "approach_with_speed"])
def test_sort_tracker_matches_jax_tracker(name, nsa):
    """The list-of-Detection API: stale enrichment cleared, ids equal,
    distance and speed as the step test (rtol 1e-3), None for None."""
    cfg = dict(CFG, min_hits=3, det_capacity=D, track_slots=T, nsa=nsa)
    jtrk = jbuild_tracker(cfg)
    ttrk = build_tracker(cfg, device="cpu")
    jp = jbuild_projector(_proj_cfg())
    tp = tbuild_projector(_proj_cfg(), device="cpu")
    t = 1.7e9
    seen_speed = False
    for f, (dt, boxes) in enumerate(SCENARIOS[name]):
        t += dt
        want = jtrk.update(_dets(JDetection, boxes, f), t, projector=jp)
        got = ttrk.update(_dets(Detection, boxes, f), t, projector=tp)
        assert len(got) == len(want) == len(boxes)
        for g, w in zip(got, want):
            assert g.track_id == w.track_id and g.track_id != 99
            for a, b in ((g.distance_m, w.distance_m),
                         (g.speed_kmh, w.speed_kmh)):
                assert (a is None) == (b is None)
                if a is not None:
                    assert abs(a - b) <= 1e-3 * max(1.0, abs(b))
            seen_speed |= g.speed_kmh is not None
    assert seen_speed
    for field in ("alive", "ids", "hits", "hit_streak", "next_id"):
        np.testing.assert_array_equal(
            getattr(ttrk.state, field).numpy(),
            np.asarray(getattr(jtrk.state, field)), err_msg=field)
    ttrk.reset()
    assert not bool(ttrk.state.alive.any()) and int(ttrk.state.next_id) == 1
    out = ttrk.update(_dets(Detection, [(0, 0, 10, 10)], 0), 5.0)
    assert out[0].track_id == 1 and out[0].distance_m is None


def test_sort_tracker_refuses_what_it_cannot_take():
    trk = SortTracker({"det_capacity": 2, "track_slots": 4}, device="cpu")
    with pytest.raises(ValueError, match="exceed det_capacity"):
        trk.update(_dets(Detection, [(0, 0, 5, 5)] * 3, 0), 0.0)
    with pytest.raises(TypeError, match="HomographyProjector"):
        trk.update([], 0.0, projector=object())
    with pytest.warns(UserWarning, match="track_slots=2 < det_capacity=8"):
        SortTracker({"det_capacity": 8, "track_slots": 2}, device="cpu")
    if torch.cuda.is_available():       # the card by default
        assert SortTracker({}).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SortTracker({})


def test_state_from_jax_continues_with_the_jax_ids():
    """Half a scenario through the JAX step, the state carried over, the
    rest through both: same ids, and the carried fields are the JAX
    state's with the dtypes ``init_state`` uses."""
    seq = SCENARIOS["many_objects"]
    jp = jbuild_projector(_proj_cfg()).device_params()
    tp = tbuild_projector(_proj_cfg(), device="cpu").device_params()
    tstep = tsort.make_sort_step(**CFG)
    jstate = jsort.init_state(T)
    cls = np.full((D,), 2, np.int32)
    conf = np.full((D,), 0.9, np.float32)
    t = 0.0
    tstate = None
    for f, (dt, boxes) in enumerate(seq):
        t += dt
        b, v = _pack(boxes)
        if f == 7:
            arrays = {k: np.asarray(a) for k, a in jstate._asdict().items()}
            tstate = tsort.state_from_jax(arrays, device="cpu")
            ref = tsort.init_state(T, device="cpu")
            for k in tsort.SortState._fields:
                got = getattr(tstate, k)
                assert got.dtype == getattr(ref, k).dtype, k
                np.testing.assert_array_equal(got.numpy(), arrays[k])
        jstate, jo = _JSTEP(jstate, jnp.asarray(b), jnp.asarray(cls),
                            jnp.asarray(conf), jnp.asarray(v),
                            jnp.float32(t), jp)
        if tstate is not None:
            tstate, to = tstep(
                tstate, torch.from_numpy(b), torch.from_numpy(cls),
                torch.from_numpy(conf), torch.from_numpy(v),
                torch.tensor(t, dtype=torch.float32), tp)
            np.testing.assert_array_equal(to.track_id.numpy(),
                                          np.asarray(jo.track_id))
            np.testing.assert_allclose(to.speed_kmh.numpy(),
                                       np.asarray(jo.speed_kmh), rtol=1e-3,
                                       atol=1e-3, equal_nan=True)
    assert int(tstate.next_id) == int(jstate.next_id) > 6
    with pytest.raises(ValueError, match="missing fields"):
        tsort.state_from_jax({"mean": np.zeros((T, 7), np.float32)},
                             device="cpu")


@pytest.mark.parametrize("max_gap", [0, 1, 3, 10])
def test_interpolate_gaps_equals_jax(max_gap):
    rng = np.random.RandomState(max_gap)
    frames = []
    for f in range(14):
        rows = []
        for tid in (1, 2, 3, 7):
            if (f * 3 + tid) % 5 < 2 or (tid == 7 and 3 < f < 9):
                continue               # gaps of several lengths
            x, y = rng.uniform(0, 300, 2)
            rows.append((x, y, x + 30, y + 20, tid, rng.uniform(), x / 10))
        frames.append(rows)
    assert interpolate_gaps(frames, max_gap) == jinterp(frames, max_gap)
    if max_gap >= 3:
        assert sum(map(len, interpolate_gaps(frames, max_gap))) \
            > sum(map(len, frames))
