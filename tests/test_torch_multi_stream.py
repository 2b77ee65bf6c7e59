"""The port's camera fleet vs the JAX package and vs single-stream runs
(CPU).

``track/multi.py``: the stacked-state step for S = 3 streams against
JAX's ``vmap`` on seeded detection sequences, greedy SORT with and
without a projector and OC-SORT through ``make_multi_step``: ids equal,
the whole state within the tracker tests' rtol 1e-5 / atol 1e-4 but the
Kalman area rate (atol 2e-2: these boxes keep their size, so the rate
is the float noise of the area over 1/30 s, as in the single-stream
step against JAX's); and each stream's slice bit-equal to the port's
single-stream step.

``MultiStreamEngine`` (the fleet step of ``parallel/inference.py``:
S·B frames folded into one preprocess + detector batch, one tracker tail
on the stacked state): against S independent port engines on two device groups
on the CPU (S = 3, padded to 4, the warning logged): counts, classes
and ids equal, boxes within 1e-4 px and confidences within 1e-5 (the
detector's batch-fold gap, see ``_fold_close``); against JAX's
``MultiStreamEngine`` on a 2-device virtual CPU mesh
(``tpu.mesh.devices: 2``; JAX pads to 4 too), B = 2 frames of 64 × 96,
``tile_grid`` 4, ``track_slots`` 8, float32: ids, classes and
counts equal, boxes within 0.05 px, confidences within 2e-3; the fleet
time origin; the fleet gate's three scenarios of
``tests/test_multi_engine.py``; per-stream GMC with BoT-SORT in one
stacked step (each stream's shifts and thumbnails equal the
single-stream engine's); the
lockstep ``stream``; and the entry points: ``Pipeline.streams``, the
multi-camera preview with ``--record``, the multi-camera server's
``/stats`` and bench ``--mode streams --device cpu``.
"""
import json
import logging

import numpy as np
import pytest
import torch

import jax

from roadvision_tpu.config import DEFAULTS as JDEFAULTS
from roadvision_tpu.config import merge as jmerge
from roadvision_tpu.geometry import build_projector as jbuild_projector
from roadvision_tpu.runtime import MultiStreamEngine as JMulti
from roadvision_tpu.track import multi as jmulti
from roadvision_tpu.track import registry as jreg
from roadvision_tpu_torch import Pipeline
from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.geometry import build_projector as tbuild_projector
from roadvision_tpu_torch.io_video import SyntheticRoadSource, VideoSource
from roadvision_tpu_torch.runtime import (MultiStreamEngine, PipelineEngine,
                                          build_sources)
from roadvision_tpu_torch.runtime import multi_engine
from roadvision_tpu_torch.track import multi as tmulti
from roadvision_tpu_torch.track.gmc import GMC_SIZE
from roadvision_tpu_torch.track import registry as treg
from roadvision_tpu_torch.track import sort as tsort
from roadvision_tpu_torch.tools import bench, preview, serve

NPZ = "assets/yolov8n_synthetic_256.npz"
S, B, H, W = 3, 2, 64, 96
T, D, FRAMES = 16, 8, 14
KF_RTOL, KF_ATOL = 1e-5, 1e-4
AREA_RATE_ATOL = 2e-2      # ~1.3 ulp of the largest area (4.9e-4) / (1/30 s)
BOX_TOL, CONF_TOL = 0.05, 2e-3
FOLD_BOX_TOL, FOLD_CONF_TOL = 1e-4, 1e-5   # fleet vs single stream, CPU


def _proj_cfg():
    return {"projector": {
        "type": "homography",
        "image_points": [[0, 480], [640, 480], [0, 80], [640, 80]],
        "world_points": [[0.0, 0.0], [6.4, 0.0], [0.0, 40.0], [6.4, 40.0]],
        "origin": [3.2, -2.0], "max_distance": 35.0}}


def _sequences():
    """FRAMES frames of (S, D) detections: six objects a stream moving
    linearly, one hidden for 4 frames, confidences above and below the
    start thresholds; stamps that differ per stream."""
    rng = np.random.RandomState(3)
    out = []
    pos = rng.uniform(40, 500, (S, 6, 2))
    vel = rng.uniform(-8, 8, (S, 6, 2))
    size = rng.uniform(30, 80, (S, 6, 2))
    conf = rng.uniform(0.3, 0.95, (S, 6))
    for f in range(FRAMES):
        boxes = np.zeros((S, D, 4), np.float32)
        valid = np.zeros((S, D), bool)
        cf = np.zeros((S, D), np.float32)
        for s in range(S):
            for k in range(6):
                if k == 2 and 5 <= f < 9:
                    continue
                xy = pos[s, k] + vel[s, k] * f
                boxes[s, k] = (*xy, *(xy + size[s, k]))
                valid[s, k] = True
                cf[s, k] = conf[s, k]
        ts = (f / 30.0 + np.arange(S) * 0.01).astype(np.float32)
        out.append((boxes, np.full((S, D), 2, np.int32), cf, valid, ts))
    return out


def _assert_state(got, want, what=""):
    for k in tsort.SortState._fields:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape, f"{what} {k}"
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
            continue
        if k in ("mean", "obs_mean"):
            # the area rate: these boxes keep their size, so it is the
            # float noise of the area s ≈ 1e3..6e3 (an ulp is up to
            # 4.9e-4) over dt = 1/30 s, the same in the single-stream
            # step against JAX's; held at AREA_RATE_ATOL
            np.testing.assert_allclose(a[..., 6], b[..., 6], rtol=0,
                                       atol=AREA_RATE_ATOL,
                                       err_msg=f"{what} {k} area rate")
            a, b = a[..., :6], b[..., :6]
        np.testing.assert_allclose(a, b, rtol=KF_RTOL, atol=KF_ATOL,
                                   equal_nan=True, err_msg=f"{what} {k}")


@pytest.mark.parametrize("backend,proj", [("sort", True), ("sort", False),
                                          ("ocsort", True)])
def test_multi_sort_step_matches_jax(backend, proj):
    if backend == "sort":
        jstep = jmulti.make_multi_sort_step(0.3, 1.2, 0.8,
                                            with_projector=proj)
        tstep = tmulti.make_multi_sort_step(0.3, 1.2, 0.8,
                                            with_projector=proj)
    else:
        # JAX's vmap lifts any hook-based backend; the port's lift is
        # make_multi_step
        cfg = {"backend": backend, "max_staleness": 1.2,
               "speed_window": 0.8, "iou_threshold": 0.3}
        one = jreg.build_device_step(cfg)
        jstep = jax.jit(jax.vmap(
            lambda st, b, c, cf, v, t, p: one(st, b, c, cf, v, t, p),
            in_axes=(0, 0, 0, 0, 0, 0, None)))
        tstep = tmulti.make_multi_step(treg.build_device_step(cfg),
                                       with_projector=True)
    jproj = jbuild_projector(_proj_cfg()).device_params() if proj else None
    tproj = tbuild_projector(_proj_cfg(), device="cpu").device_params() \
        if proj else None
    jst = jmulti.init_multi_state(S, T)
    tst = tmulti.init_multi_state(S, T, device="cpu")
    # the lift is exact: each stream's slice equals the single-stream step
    one_t = treg.build_device_step({"backend": backend, "max_staleness": 1.2,
                                    "speed_window": 0.8,
                                    "iou_threshold": 0.3})
    singles = [tsort.init_state(T, "cpu") for _ in range(S)]
    for f, (boxes, cls, conf, valid, ts) in enumerate(_sequences()):
        args = (boxes, cls, conf, valid, ts)
        if proj:
            jst, jout = jstep(jst, *args, jproj)
            tst, tout = tstep(tst, *map(torch.from_numpy, args), tproj)
        else:
            jst, jout = jstep(jst, *args)
            tst, tout = tstep(tst, *map(torch.from_numpy, args))
        for i in range(S):
            singles[i], o = one_t(singles[i], *(torch.from_numpy(
                np.asarray(x[i])) for x in args), tproj)
            assert torch.equal(o.track_id, tout.track_id[i])
        np.testing.assert_array_equal(tout.track_id.numpy(),
                                      np.asarray(jout.track_id),
                                      err_msg=f"frame {f}")
        for name in ("distance_m", "speed_kmh"):
            np.testing.assert_allclose(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                rtol=1e-3, atol=1e-4, equal_nan=True, err_msg=name)
    _assert_state(tst, jst, backend)
    for a, b in zip(tmulti.stack_states(singles), tst):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    # ids are per stream: every stream numbers its own tracks from 1
    assert (tst.next_id.numpy() > 1).all()
    wrong = () if proj else (
        tbuild_projector(_proj_cfg(), device="cpu").device_params(),)
    with pytest.raises(ValueError, match="with_projector"):
        tstep(tst, *map(torch.from_numpy, args), *wrong)


def test_stream_states_round_trip():
    st = tmulti.init_multi_state(S, T, device="cpu")
    assert st.next_id.shape == (S,) and st.cov.shape == (S, T, 7, 7)
    per = tmulti.stream_states(st)
    assert len(per) == S
    back = tmulti.stack_states(per)
    for a, b in zip(back, st):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert tmulti.stack_states([None] * S) is None


# ----------------------------------------------------------------------
# the fleet engine

def _cfg(**over):
    base = {
        "camera": {"width": W, "height": H, "fps_request": 30,
                   "sources": [f"synthetic:{2 + i}" for i in range(S)]},
        "preprocess": {"enabled": True, "chain": [
            {"name": "CLAHEDehaze",
             "params": {"space": "YCrCb", "clip_limit": 2.0,
                        "tile_grid": 4}}]},
        "detect": {"enabled": True, "model": NPZ, "device": "cpu",
                   "max_det": 8, "imgsz": 96, "classes_keep": [],
                   "conf_thres": 0.02, "compute_dtype": "float32"},
        "tracking": {"enabled": True},
        "tpu": {"batch_size": B, "track_slots": 8,
                "compute_dtype": "float32",
                "mesh": {"enable": True, "axis": "data", "devices": 2}},
    }
    return merge(merge(DEFAULTS, base), over)


def _frames(k=0, s=S, b=B):
    return np.stack([np.stack([
        SyntheticRoadSource(W, H, num_vehicles=6, seed=i).render(k * b + j)
        for j in range(b)]) for i in range(s)])


def _stamps(k=0, s=S, b=B):
    return 1000.0 + (k * b + np.arange(b))[None] / 30.0 \
        + 0.004 * np.arange(s)[:, None]


def _close(got, want, what=""):
    """Detection lists: counts, classes and ids equal, boxes and
    confidences within the stated tolerance."""
    n = 0
    for g, w in zip(got, want):
        assert len(g.detections) == len(w.detections), what
        for dg, dw in zip(g.detections, w.detections):
            assert (dg.cls_id, dg.track_id) == (dw.cls_id, dw.track_id), what
            assert max(abs(p - q) for p, q in zip(
                (dg.x1, dg.y1, dg.x2, dg.y2),
                (dw.x1, dw.y1, dw.x2, dw.y2))) < BOX_TOL, what
            assert abs(dg.conf - dw.conf) < CONF_TOL, what
            n += 1
    return n


def _fold_close(got, want, what=""):
    """A fleet stream against its single-stream run: the detector sees an
    S·B batch instead of B, and oneDNN may reduce in another order there
    (measured on this CPU: ≤ 7.6e-6 px, confidences ≤ 9.2e-7, none below
    8 streams with one thread). Counts, classes, ids and RAW frames
    equal; boxes within FOLD_BOX_TOL, confidences within FOLD_CONF_TOL,
    distance and speed within 1e-3 relative."""
    n = 0
    for g, w in zip(got, want):
        assert np.array_equal(g.raw, w.raw), what
        assert len(g.detections) == len(w.detections), what
        for dg, dw in zip(g.detections, w.detections):
            assert (dg.cls_id, dg.track_id) == (dw.cls_id, dw.track_id), what
            assert max(abs(p - q) for p, q in zip(
                (dg.x1, dg.y1, dg.x2, dg.y2),
                (dw.x1, dw.y1, dw.x2, dw.y2))) <= FOLD_BOX_TOL, what
            assert abs(dg.conf - dw.conf) <= FOLD_CONF_TOL, what
            for a, b in ((dg.distance_m, dw.distance_m),
                         (dg.speed_kmh, dw.speed_kmh)):
                assert (a is None) == (b is None), what
                assert a is None or a == pytest.approx(b, rel=1e-3), what
            n += 1
    return n


@pytest.fixture(scope="module")
def fleets():
    """The port's fleet on two CPU groups and JAX's on a 2-device mesh,
    each over the same two batches (JAX compiles its step once)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 (virtual) JAX devices")
    cfg = _cfg()
    tm = MultiStreamEngine(cfg, S, devices=["cpu", "cpu"])
    jm = JMulti(jmerge(JDEFAULTS, cfg), S)
    out = {"t": [], "j": []}
    for k in range(2):
        frames, ts = _frames(k), _stamps(k)
        out["t"].append(tm.process_batch(frames, ts))
        out["j"].append(jm.process_batch(frames, ts))
    return tm, jm, out


def test_fleet_matches_jax_multi_engine(fleets):
    tm, jm, out = fleets
    assert tm.padded_streams == jm.padded_streams == 4
    n = 0
    for k in range(2):
        for s in range(S):
            n += _close(out["t"][k][s], out["j"][k][s], f"batch {k} {s}")
    assert n > 0
    assert tm._t0 == jm._t0 == 1000.0
    np.testing.assert_array_equal(tm.states.next_id.numpy(),
                                  np.asarray(jm.states.next_id)[:2])


def test_fleet_matches_single_stream_engines(fleets, caplog):
    tm, _, out = fleets
    assert [g.engine.device.type for g in tm.groups] == ["cpu", "cpu"]
    assert [(g.lo, g.hi) for g in tm.groups] == [(0, 2), (2, 4)]
    n = 0
    for s in range(S):
        single = PipelineEngine(_cfg(), device="cpu")
        single._t0 = 1000.0             # the fleet's time origin
        for k in range(2):
            ref = single.process_batch(_frames(k)[s], _stamps(k)[s])
            n += _fold_close(out["t"][k][s], ref, (s, k))
    assert n > 0
    log = logging.getLogger("roadvision.multi")   # does not propagate
    log.addHandler(caplog.handler)
    try:
        MultiStreamEngine(_cfg(), 5, devices=["cpu"] * 2)
    finally:
        log.removeHandler(caplog.handler)
    assert "padding to 6 streams" in caplog.text


def test_fleet_time_origin_is_the_fleet_minimum():
    eng = MultiStreamEngine(_cfg(tracking={"enabled": False}), S,
                            devices=["cpu"])
    ts = _stamps() + np.array([[5.0], [2.0], [7.0]])
    eng.process_batch(_frames(), ts)
    assert eng._t0 == float(ts.min()) == ts[1, 0]
    eng.reset()
    assert eng._t0 is None and eng.states is None


def _gate_cfg(**gate):
    return _cfg(preprocess={"enabled": False},
                detect={"imgsz": 64, "conf_thres": 1e-6, "temporal_gate": {
                    "enable": True, "thresh": 1.5, "max_skip_batches": 3,
                    **gate}},
                tpu={"mesh": {"devices": 1}})


def _static(s=S, b=B):
    rng = np.random.RandomState(0)
    frame = rng.randint(0, 256, (48, 64, 3), dtype=np.uint8)
    return np.broadcast_to(frame, (s, b) + frame.shape).copy()


def test_fleet_gate_coasts_when_all_streams_static():
    eng = MultiStreamEngine(_gate_cfg(), S, devices=["cpu"])
    frames = _static()
    ts0 = np.arange(B, dtype=np.float64)[None].repeat(S, 0) / 30.0
    r1 = eng.process_batch(frames, ts0)
    assert eng.gate_frames_coasted == 0
    tsort.reset_host_syncs()
    r2 = eng.process_batch(frames, ts0 + B / 30.0)
    assert eng.gate_frames_coasted == S * B
    assert sum(len(r.detections) for r in r1[0]) > 0
    # coasted detections are the held last-frame set, per stream
    for si in range(S):
        held = [(d.x1, d.y1, d.x2, d.y2, d.cls_id)
                for d in r1[si][-1].detections]
        for fr in r2[si]:
            assert [(d.x1, d.y1, d.x2, d.y2, d.cls_id)
                    for d in fr.detections] == held
    # max_skip budget: after 3 coasted batches the 5th runs full again
    eng.process_batch(frames, ts0 + 2 * B / 30.0)
    eng.process_batch(frames, ts0 + 3 * B / 30.0)
    c_before = eng.gate_frames_coasted
    eng.process_batch(frames, ts0 + 4 * B / 30.0)
    assert eng.gate_frames_coasted == c_before == 3 * S * B


def test_fleet_gate_one_moving_stream_wakes_the_fleet():
    eng = MultiStreamEngine(_gate_cfg(), S, devices=["cpu"] * 3)
    frames = _static()
    ts0 = np.arange(B, dtype=np.float64)[None].repeat(S, 0) / 30.0
    eng.process_batch(frames, ts0)
    moving = frames.copy()
    moving[1, -1] = np.random.RandomState(1).randint(0, 256, (48, 64, 3))
    eng.process_batch(moving, ts0 + B / 30.0)
    assert eng.gate_frames_coasted == 0
    # the decision is the fleet's: a batch that is static on every
    # stream coasts on every device group at once
    still = np.repeat(moving[:, -1:], B, axis=1)
    eng.process_batch(still, ts0 + 2 * B / 30.0)
    assert eng.gate_frames_coasted == S * B


def test_fleet_gate_full_batches_match_ungated_engine():
    base = _gate_cfg()
    gated = MultiStreamEngine(base, S, devices=["cpu"])
    plain = MultiStreamEngine(merge(base, {"detect": {"temporal_gate": {
        "enable": False}}}), S, devices=["cpu"])
    rng = np.random.RandomState(2)
    frames = rng.randint(0, 256, (S, B, 48, 64, 3), dtype=np.uint8)
    ts0 = np.arange(B, dtype=np.float64)[None].repeat(S, 0) / 30.0
    rg = gated.process_batch(frames, ts0)
    rp = plain.process_batch(frames, ts0)
    assert gated.gate_frames_coasted == 0    # noisy frames: motion
    for si in range(S):
        for fg, fp in zip(rg[si], rp[si]):
            assert fg.detections == fp.detections


def test_fleet_gmc_botsort_shifts_equal_single_stream():
    """Per-stream GMC in one stacked step: each stream carries its own
    thumbnail in the fleet's (S, G, G) tensor (one flag for all, kept in
    the same tensors across batches); the one phase correlation a fleet
    batch gives each stream the shifts, thumbnail and tracks of the
    single-stream engine."""
    cfg = _cfg(tracking={"backend": "botsort", "gmc": True},
               tpu={"mesh": {"devices": 1}})
    eng = MultiStreamEngine(cfg, S, devices=["cpu"])
    seen = []
    grp = eng.groups[0].engine
    real = grp._shifts
    grp._shifts = lambda f, p, v: seen.append(real(f, p, v)) or seen[-1]
    pans = [np.roll(_frames(k), 3 * k, axis=3) for k in range(3)]
    got = [eng.process_batch(p, _stamps(k)) for k, p in enumerate(pans)]
    assert len(seen) == 3 and seen[0][0].shape == (S, B, 2)
    carry = eng.groups[0].gmc_prev
    assert carry.shape == (S, GMC_SIZE, GMC_SIZE)
    assert float(eng.groups[0].gmc_valid) == 1.0
    for s in range(S):
        single = PipelineEngine(cfg, device="cpu")
        single._t0 = 1000.0
        mine = []
        real1 = single._shifts
        single._shifts = lambda f, p, v: mine.append(real1(f, p, v)) \
            or mine[-1]
        for k, p in enumerate(pans):
            ref = single.process_batch(p[s], _stamps(k)[s])
            _fold_close(got[k][s], ref, (s, k))
        for k in range(3):
            assert torch.equal(seen[k][0][s], mine[k][0])
        assert torch.equal(eng.groups[0].gmc_prev[s], single.gmc_prev)
    assert any(float(sh[0].abs().max()) > 0 for sh in seen[1:])
    # where the fleet step replays a graph, reset keeps the tensors
    eng.groups[0].engine.step_mode = "graph"
    eng.reset()
    assert eng.groups[0].gmc_prev is carry and not carry.any()
    assert float(eng.groups[0].gmc_valid) == 0.0


class _Src:
    """A VideoSource stand-in over fixed frames; ``fail_at`` raises on
    that batch."""

    def __init__(self, frames, fail_at=None):
        self.frames, self.k, self.fail_at = frames, 0, fail_at
        self.pos = 0
        self.released = False

    def read_batch(self, n):
        if self.k == self.fail_at:
            raise OSError("camera unplugged")
        f = self.frames[self.pos:self.pos + n]
        ts = 1000.0 + (self.pos + np.arange(len(f))) / 30.0
        self.k += 1
        self.pos += len(f)
        return f, ts, len(f)

    def release(self):
        self.released = True


def test_stream_lockstep_and_failures(caplog):
    eng = MultiStreamEngine(_cfg(tpu={"mesh": {"devices": 1}}), S,
                            devices=["cpu"])
    clips = [np.concatenate([_frames(k)[s] for k in range(3)])
             for s in range(S)]
    # lockstep: the stream ends with the shortest source
    srcs = [_Src(c[:2 * B] if s == 1 else c) for s, c in enumerate(clips)]
    batches = list(eng.stream(srcs, max_frames=3 * B))
    assert len(batches) == 2 and all(len(b) == S for b in batches)
    assert eng.states.next_id.shape == (S,)
    want = MultiStreamEngine(_cfg(tpu={"mesh": {"devices": 1}}), S,
                             devices=["cpu"])
    for k, got in enumerate(batches):
        ref = want.process_batch(_frames(k), 1000.0 + (
            k * B + np.arange(B))[None].repeat(S, 0) / 30.0)
        for s in range(S):
            assert [r.detections for r in got[s]] == \
                [r.detections for r in ref[s]]
    # a failing source is logged and ends the stream
    eng.reset()
    log = logging.getLogger("roadvision.multi")
    log.addHandler(caplog.handler)
    try:
        srcs = [_Src(c, fail_at=1 if s == 2 else None)
                for s, c in enumerate(clips)]
        assert len(list(eng.stream(srcs))) == 1
    finally:
        log.removeHandler(caplog.handler)
    assert "frame source failed" in caplog.text
    # sources of different shapes cannot run in lockstep
    eng.reset()
    odd = [_Src(c) for c in clips[:2]] + [_Src(clips[2][:, :, :64])]
    with pytest.raises(ValueError, match="one frame shape"):
        list(eng.stream(odd))
    with pytest.raises(ValueError, match="3 streams"):
        list(eng.stream(srcs[:2]))
    with pytest.raises(ValueError, match="expected 3 streams"):
        eng.process_batch(_frames(s=2), _stamps(s=2))


def test_stream_ends_on_a_short_last_batch():
    """max_frames = 1.5 batches: the fleet's last batch holds B // 2
    frames a stream, and gives what ``process_batch`` gives for them."""
    cfg = _cfg(tpu={"mesh": {"devices": 1}})
    eng = MultiStreamEngine(cfg, S, devices=["cpu"])
    clips = [np.concatenate([_frames(k)[s] for k in range(2)])
             for s in range(S)]
    m = B // 2
    got = list(eng.stream([_Src(c) for c in clips], max_frames=B + m))
    assert [len(g[0]) for g in got] == [B, m]
    ref = MultiStreamEngine(cfg, S, devices=["cpu"])
    for k, n in enumerate((B, m)):
        frames = np.stack([c[k * B:k * B + n] for c in clips])
        ts = 1000.0 + (k * B + np.arange(n))[None].repeat(S, 0) / 30.0
        want = ref.process_batch(frames, ts)
        for s in range(S):
            assert [r.detections for r in got[k][s]] == \
                [r.detections for r in want[s]]
            assert all(np.array_equal(r.raw, f)
                       for r, f in zip(got[k][s], frames[s]))


def test_build_sources_and_devices(monkeypatch):
    cam = {"source": 0, "width": 64, "height": 48, "fps_request": 15,
           "backend": "auto",
           "sources": ["synthetic:3", {"source": "synthetic:5", "width": 32}]}
    srcs = build_sources(cam, max_frames=4)
    f0, f1 = srcs[0].read(), srcs[1].read()
    assert f0.ok and f0.image.shape == (48, 64, 3)
    assert f1.ok and f1.image.shape == (48, 32, 3)   # per-stream override
    for s in srcs:
        s.release()
    dev = multi_engine.devices_from_config
    assert dev({"mesh": {"devices": 2}}, "cpu") == [torch.device("cpu")] * 2
    assert dev({"mesh": {"devices": None}}, "cpu") == [torch.device("cpu")]
    assert dev({"mesh": {"devices": 2, "axis": "model"}}, "cpu") == \
        [torch.device("cpu")]
    with pytest.raises(ValueError, match="not a mesh axis"):
        dev({"mesh": {"axis": "streams"}}, "cpu")
    # the cards: null is every visible card, more than visible is refused
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert dev({"mesh": {"devices": None}}) == [torch.device("cuda", 0),
                                               torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="2 card"):
        dev({"mesh": {"devices": 4}})
    with pytest.raises(ValueError, match="at least one stream"):
        MultiStreamEngine(_cfg(), 0, devices=["cpu"])


def test_pipeline_streams():
    cfg = _cfg(tpu={"mesh": {"devices": 1}})
    pipe = Pipeline(cfg, device="cpu")
    got = list(pipe.streams(max_frames=2 * B))
    assert len(got) == 2 and all(len(b) == S for b in got)
    fleet = pipe._multi_engines[S]
    want = MultiStreamEngine(cfg, S, devices=["cpu"])
    for k, batch in enumerate(got):
        frames = np.stack([[r.raw for r in batch[s]] for s in range(S)])
        ts = np.array([[r.ts for r in batch[s]] for s in range(S)])
        ref = want.process_batch(frames, ts)
        for s in range(S):
            assert [r.detections for r in batch[s]] == \
                [r.detections for r in ref[s]]
    # caller-owned sources stay open; the engine is cached per count
    vss = [VideoSource(f"synthetic:{i}", W, H, num_frames=B)
           for i in (2, 3)]
    released = []
    for v in vss:
        v.release = lambda v=v: released.append(v)
    assert len(list(pipe.streams(vss, max_frames=B))) == 1
    assert released == []
    assert set(pipe._multi_engines) == {S, 2}
    assert pipe._multi_engines[S] is fleet
    pipe.reset()
    assert fleet.states is None and fleet._t0 is None


def _multi_yaml(tmp_path, **over):
    import yaml
    cfgd = merge({
        "camera": {"width": 64, "height": 48,
                   "sources": ["synthetic:2", "synthetic:3"]},
        "preprocess": {"enabled": False},
        "detect": {"enabled": True, "model": NPZ, "imgsz": 64,
                   "max_det": 8, "conf_thres": 0.02, "classes_keep": []},
        "tracking": {"enabled": True},
        "analytics": {"enabled": True, "lines": [
            {"name": "mid", "p1": [0, 24], "p2": [64, 24]}]},
        "vis": {"draw": {"trails": 4}},
        "tpu": {"batch_size": 2, "mesh": {"enable": True, "axis": "data"}},
    }, over)
    path = tmp_path / "multi.yaml"
    path.write_text(yaml.safe_dump(cfgd))
    return str(path)


def test_run_multi_records_the_grid(tmp_path):
    out = tmp_path / "fleet.avi"
    assert preview.main(["--config", _multi_yaml(tmp_path), "--no-show",
                         "--max-frames", "4", "--record", str(out),
                         "--device", "cpu"]) == 0
    data = out.read_bytes()
    assert data[:4] == b"RIFF"
    assert data.count(b"\xff\xd8\xff") == 4   # one tiled canvas a frame
    gated = tmp_path / "gated.avi"
    assert preview.main(["--config", _multi_yaml(
        tmp_path, preview={"record": {"events_only": True, "pre_roll": 1,
                                      "post_roll": 1}}),
        "--no-show", "--max-frames", "4", "--record", str(gated),
        "--device", "cpu"]) == 0
    assert gated.read_bytes()[:4] == b"RIFF"


def test_multi_serve_stats(tmp_path):
    from roadvision_tpu_torch.config import load_config
    cfg = load_config(_multi_yaml(tmp_path))
    server, hub, worker = serve.serve_background(cfg, port=0, max_frames=4,
                                                 device="cpu")
    host, port = server.server_address[:2]
    try:
        parts = serve.read_stream_parts(host, port, 1, timeout=60.0)
        worker.join(timeout=120)
        import urllib.request
        with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                    timeout=10) as resp:
            stats = json.loads(resp.read())
    finally:
        hub.close()
        server.shutdown()
        server.server_close()
        worker.join(timeout=60)
        server.thread.join(timeout=60)
    assert hub.error is None and len(parts) == 1
    assert stats["frames"] == 4 and stats["done"]
    assert len(stats["analytics"]) == 2          # one summary a stream
    assert not worker.is_alive() and not server.thread.is_alive()


def test_bench_streams_rehearsal(monkeypatch, capsys):
    monkeypatch.setenv("RVT_BENCH_STREAMS", "2")
    monkeypatch.setenv("RVT_BENCH_RES", "64")
    assert bench.main(["--mode", "streams", "--device", "cpu", "--batch",
                       "2", "--iters", "1", "--windows", "2",
                       "--warmup", "1", "--dtype", "float32"]) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["metric"] == "streams2_64p_fps" and line["res"] == 64
    assert "per_chip" not in line["metric"]
    assert line["device"]["platform"] == "cpu" and line["card"] is None
    assert line["streams"] == 2 and line["streams_fps"]["median"] > 0
    assert line["per_stream_fps"]["median"] == pytest.approx(
        line["streams_fps"]["median"] / 2)
    assert set(line["stage_ms"]) == {"preprocess", "letterbox", "forward",
                                     "nms", "sort_geometry"}
    assert line["host_syncs_per_batch"] > 0
