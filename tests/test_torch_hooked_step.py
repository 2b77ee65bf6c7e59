"""The hooked trackers and camera-motion compensation inside the port's
one-program step, against single-stream runs and the JAX package (CPU).

* Every hooked backend's step (bytetrack; ocsort with ORU; deepsort and
  botsort with descriptors and camera shifts; strongsort, NSA, with
  both) over a stacked state of S = 3 streams against three
  single-stream runs of the same step on the streams' slices: ids exact,
  distance, speed and every float of the state within 1e-4 absolute and
  1e-5 relative (``tests/test_torch_multi_stream.py``'s limits), the
  integer fields exact. Each stream: objects moving under a camera pan,
  one detected twice (ties), one hidden for two frames (ORU's
  re-activation on its return), confidences on both sides of
  ByteTrack's stages, per-identity descriptors with noise.
* The port's fleet step (``parallel/inference.py::make_stream_step``:
  the S·B frames through the detector, one stacked tracker scan, GMC
  with an (S, G, G) carry) against JAX's vmapped one
  (``make_sharded_stream_step`` on a one-device CPU mesh) for deepsort
  and for botsort + GMC, S = 2 panned streams of 2 frames at 128 × 128,
  two fleet batches: validity, classes and ids exact, boxes within 0.05
  px, confidences within 2e-3, distance and speed within 1e-3 relative
  (the pipeline tests' limits), the carried thumbnails within 1.22e-4.
* ``PipelineEngine.build_raw_step`` with GMC's carry against JAX's
  ``build_raw_step(...)(params, state, frames, ts, gmc_prev,
  gmc_valid)`` under ``jit``, strongsort (GMC on by default) on a clip
  panned by known shifts: a first batch (flag 0) and a panned second
  one: the shifts equal JAX's and the pan, the outputs at the pipeline
  limits, the state within the tracker engine test's rtol 1e-3 / atol
  1e-3 but the Kalman area rate (atol 2e-2, as
  ``tests/test_torch_raw_step.py``: the float noise of an area over
  1/30 s), the last thumbnail within 1.22e-4.
* The graph path's plumbing (an eager stand-in for the capture, as the
  CPU has no graphs): the engine and the fleet, run as they run a
  captured step (``step_state`` in, the state copied back), give the
  eager step's results and carry, in the same tensors.
* ``reset``, ``save_state`` and ``load_state`` copy GMC's carry into the
  engine's own tensors, and the file keeps the JAX format (``gmc_prev``
  once a batch has set it).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from roadvision_tpu.config import DEFAULTS as JDEFAULTS
from roadvision_tpu.config import merge as jmerge
from roadvision_tpu.parallel.inference import make_sharded_stream_step
from roadvision_tpu.runtime.engine import PipelineEngine as JEngine
from roadvision_tpu.track import gmc as jgmc
from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.geometry import build_projector
from roadvision_tpu_torch.io_video import SyntheticRoadSource
from roadvision_tpu_torch.parallel.inference import make_stream_step
from roadvision_tpu_torch.runtime import (MultiStreamEngine, PipelineEngine,
                                          engine as tengine)
from roadvision_tpu_torch.track import multi as tmulti
from roadvision_tpu_torch.track import registry as treg
from roadvision_tpu_torch.track import sort as tsort
from roadvision_tpu_torch.track.appearance import EMB_DIM
from roadvision_tpu_torch.track.gmc import GMC_SIZE

from tests.test_torch_raw_step import _EagerCapture

S, T, D, F = 3, 16, 10, 12
STATE_ATOL, STATE_RTOL = 1e-4, 1e-5
BOX_TOL, CONF_TOL, METRIC_RTOL = 0.05, 2e-3, 1e-3
GRAY_TOL = 1.22e-4
ENGINE_RTOL = ENGINE_ATOL = 1e-3
AREA_RATE_ATOL = 2e-2
NPZ = "assets/yolov8n_synthetic_256.npz"


def _proj_cfg(w=640, h=480):
    return {"projector": {
        "type": "homography",
        "image_points": [[0, h], [w, h], [0, h // 6], [w, h // 6]],
        "world_points": [[0.0, 0.0], [6.4, 0.0], [0.0, 40.0], [6.4, 40.0]],
        "origin": [3.2, -2.0], "max_distance": 35.0}}


def _stream(seed, n=7):
    """F frames of D detections of one stream under a camera pan: object
    0 detected twice (ties), object 3 hidden in frames 5 and 6,
    confidences high and low, descriptors per identity with noise. →
    (boxes, cls, conf, valid, ts, emb, shift), frames first."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(40, 400, (n, 2))
    vel = rng.uniform(-6, 6, (n, 2))
    size = rng.uniform(30, 80, (n, 2))
    ident = rng.normal(size=(n, EMB_DIM))
    cam = np.zeros(2)
    out = [[] for _ in range(7)]
    for f in range(F):
        shift = rng.uniform(-4, 4, 2).round() if f else np.zeros(2)
        cam += shift
        boxes = np.zeros((D, 4), np.float32)
        conf = np.zeros(D, np.float32)
        emb = np.zeros((D, EMB_DIM), np.float32)
        valid = np.zeros(D, bool)
        slots = [k for k in range(n) if not (k == 3 and f in (5, 6))] + [0]
        for slot, k in enumerate(slots):
            xy = pos[k] + vel[k] * f + cam
            boxes[slot] = (*xy, *(xy + size[k]))
            conf[slot] = rng.choice([rng.uniform(0.62, 0.98),
                                     rng.uniform(0.15, 0.45)], p=[.75, .25])
            e = ident[k] + rng.normal(0, 0.15, EMB_DIM)
            emb[slot] = e / np.linalg.norm(e)
            valid[slot] = True
        for lst, a in zip(out, (boxes, np.full(D, 2, np.int32), conf, valid,
                                np.float32(0.01 * seed + f / 30.0), emb,
                                shift.astype(np.float32))):
            lst.append(a)
    return [np.stack(a) for a in out]


@pytest.fixture(scope="module")
def streams():
    """(S, F, ...) arrays of S streams."""
    per = [_stream(s) for s in range(S)]
    return [torch.from_numpy(np.stack([p[i] for p in per]))
            for i in range(7)]


def _close_state(got, want, what):
    for k, a, b in zip(tsort.SortState._fields, got, want):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       equal_nan=True, err_msg=f"{what} {k}")
        else:
            assert torch.equal(a, b), f"{what} {k}"


@pytest.mark.parametrize("backend,extras", [
    ("bytetrack", False), ("ocsort", False), ("deepsort", True),
    ("botsort", True), ("strongsort", True)])
def test_stacked_hooked_step_equals_single_streams(streams, backend,
                                                   extras):
    step = treg.build_device_step({"backend": backend, "max_staleness": 1.2,
                                   "speed_window": 0.8,
                                   "iou_threshold": 0.3})
    proj = build_projector(_proj_cfg(), device="cpu").device_params()
    boxes, cls, conf, valid, ts, emb, shift = streams
    stacked = tmulti.init_multi_state(S, T, device="cpu")
    singles = [tsort.init_state(T, "cpu") for _ in range(S)]
    ids = []
    for f in range(F):
        e = emb[:, f] if extras else None
        sh = shift[:, f] if extras else None
        stacked, out = step(stacked, boxes[:, f], cls[:, f], conf[:, f],
                            valid[:, f], ts[:, f], proj, e, sh)
        for s in range(S):
            singles[s], one = step(
                singles[s], boxes[s, f], cls[s, f], conf[s, f], valid[s, f],
                ts[s, f], proj, None if e is None else e[s],
                None if sh is None else sh[s])
            assert torch.equal(out.track_id[s], one.track_id), (f, s)
            for k in ("distance_m", "speed_kmh"):
                np.testing.assert_allclose(
                    getattr(out, k)[s].numpy(), getattr(one, k).numpy(),
                    rtol=STATE_RTOL, atol=STATE_ATOL, equal_nan=True,
                    err_msg=f"{k} frame {f} stream {s}")
        ids.append(out.track_id.numpy())
    for s in range(S):
        _close_state([t[s] for t in stacked], singles[s], f"stream {s}")
    ids = np.stack(ids, 1)                           # (S, F, D)
    assert (ids[..., 0] > 0).all()
    if backend == "ocsort":
        # the hidden object came back under its id (ORU re-activated it)
        assert (ids[:, 7, 3] == ids[:, 4, 3]).all()
    if backend in ("bytetrack", "botsort"):
        # low detections were matched, and none of them started a track
        low = (conf.numpy() < 0.5) & valid.numpy()
        assert (ids[low] > 0).any()


# ----------------------------------------------------------------------
# the fleet step against JAX's vmapped one

FS, FB, FH, FW = 2, 2, 128, 128


def _fleet_cfg(tracking):
    return {
        "camera": {"width": FW, "height": FH},
        "preprocess": {"enabled": False},
        "detect": {"enabled": True, "model": NPZ, "imgsz": 128,
                   "max_det": 10, "conf_thres": 0.05, "classes_keep": [],
                   "compute_dtype": "float32"},
        "tracking": {"enabled": True, "max_staleness": 1.2,
                     "speed_window": 0.8, "iou_threshold": 0.3,
                     **tracking},
        "geometry": {"enabled": True, **_proj_cfg(FW, FH)},
        "tpu": {"batch_size": FB, "track_slots": 12,
                "compute_dtype": "float32"}}


def _fleet_batches(n=2):
    """n fleet batches of FS streams of FB frames under per-stream pans
    (whole thumbnail px: one source px at 128²)."""
    srcs = [SyntheticRoadSource(FW, FH, num_vehicles=4, seed=s)
            for s in range(FS)]
    rng = np.random.RandomState(4)
    cams = np.zeros((FS, 2), int)
    out = []
    for k in range(n):
        frames = np.zeros((FS, FB, FH, FW, 3), np.uint8)
        for s, src in enumerate(srcs):
            for i in range(FB):
                cams[s] += rng.randint(-3, 4, 2) if k or i else 0
                frames[s, i] = np.roll(src.render(k * FB + i),
                                       tuple(cams[s][::-1]), axis=(0, 1))
        ts = ((k * FB + np.arange(FB))[None] / 30.0
              + 0.004 * np.arange(FS)[:, None]).astype(np.float32)
        out.append((frames, ts))
    return out


FLEETS = {"deepsort": {"backend": "deepsort"},
          "botsort_gmc": {"backend": "botsort", "gmc": True}}


@pytest.fixture(scope="module", params=list(FLEETS))
def jax_fleet(request):
    """JAX's vmapped fleet step over the batches (one compile a backend):
    → (name, config, batches, [(outs, next_id, thumbnails | None)])."""
    cfg = _fleet_cfg(FLEETS[request.param])
    jeng = JEngine(jmerge(JDEFAULTS, cfg))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    step, init = make_sharded_stream_step(jeng, (FB, FH, FW), mesh)
    states = init(FS)
    batches = _fleet_batches()
    gmc = jeng.gmc_enabled
    gprev = jnp.zeros((FS, GMC_SIZE, GMC_SIZE), jnp.float32)
    gvalid = jnp.float32(0.0)
    runs = []
    for frames, ts in batches:
        if gmc:
            outs, states, gprev = step(jeng.detector.params, states,
                                       jnp.asarray(frames), jnp.asarray(ts),
                                       gprev, gvalid)
            gvalid = jnp.float32(1.0)
        else:
            outs, states = step(jeng.detector.params, states,
                                jnp.asarray(frames), jnp.asarray(ts))
        runs.append(([np.asarray(a) for a in outs],
                      np.asarray(states.next_id),
                      np.asarray(gprev) if gmc else None))
    return request.param, cfg, batches, runs


def _same_outputs(got, want, what):
    tb, tc, tk, tv, tids, td, tsp = got
    jb, jc, jk, jv, jids, jd, js = want
    np.testing.assert_array_equal(tv, jv, err_msg=what)
    np.testing.assert_array_equal(tk[tv], jk[jv], err_msg=what)
    np.testing.assert_array_equal(tids[tv], jids[jv], err_msg=what)
    np.testing.assert_allclose(tb[tv], jb[jv], rtol=0, atol=BOX_TOL,
                               err_msg=what)
    np.testing.assert_allclose(tc[tv], jc[jv], rtol=0, atol=CONF_TOL,
                               err_msg=what)
    for g, w in ((td, jd), (tsp, js)):
        np.testing.assert_allclose(g[tv], w[jv], rtol=METRIC_RTOL,
                                   atol=1e-4, equal_nan=True, err_msg=what)
    return int((tids[tv] > 0).sum())


def test_fleet_step_matches_jax_vmapped_step(jax_fleet):
    name, cfg, batches, runs = jax_fleet
    teng = PipelineEngine(merge(DEFAULTS, cfg), device="cpu")
    step, init = make_stream_step(teng, (FB, FH, FW))
    states = init(FS)
    gmc = teng.gmc_enabled
    assert gmc == (name == "botsort_gmc")
    gprev = torch.zeros((FS, GMC_SIZE, GMC_SIZE))
    gvalid = torch.zeros(())
    n_ids = 0
    for k, ((frames, ts), (jouts, jnext, jgray)) in enumerate(
            zip(batches, runs)):
        args = (states, torch.from_numpy(frames), torch.from_numpy(ts))
        if gmc:
            outs, states, gprev = step(*args, gprev, gvalid)
            gvalid = torch.ones(())
            np.testing.assert_allclose(gprev.numpy(), jgray, rtol=0,
                                       atol=GRAY_TOL)
        else:
            outs, states = step(*args)
        n_ids += _same_outputs([a.numpy() for a in outs], jouts,
                               f"{name} batch {k}")
        np.testing.assert_array_equal(states.next_id.numpy(), jnext)
    assert n_ids >= 8


# ----------------------------------------------------------------------
# the raw step with GMC's carry against JAX's

GB, GH, GW = 4, 256, 256


def _gmc_cfg(**tracking):
    return {
        "detect": {"enabled": True, "model": NPZ, "imgsz": 256,
                   "conf_thres": 0.25, "iou_thres": 0.7, "max_det": 20,
                   "classes_keep": [2], "compute_dtype": "float32"},
        "tracking": {"enabled": True, "max_staleness": 1.2,
                     "iou_threshold": 0.35, "speed_window": 0.8,
                     "backend": "strongsort", **tracking},
        "tpu": {"batch_size": GB, "compute_dtype": "float32",
                "track_slots": 24}}


def _panning_clip(n, seed=1):
    """``n`` frames of the synthetic road, each rolled by a cumulative
    known shift (even source px: whole thumbnail px at 256 → 128) →
    (frames, shifts (n, 2) source px)."""
    src = SyntheticRoadSource(GW, GH, num_vehicles=4, seed=seed)
    rng = np.random.RandomState(seed)
    cam = np.zeros(2, int)
    frames, shifts = [], []
    for k in range(n):
        d = 2 * rng.randint(-4, 5, 2) if k else np.zeros(2, int)
        cam += d
        frames.append(np.roll(src.render(k), (cam[1], cam[0]), axis=(0, 1)))
        shifts.append(d)
    return np.stack(frames), np.array(shifts, np.float32)


def test_raw_step_with_gmc_carry_matches_jax():
    cfg = _gmc_cfg()
    jeng = JEngine(jmerge(JDEFAULTS, cfg))
    teng = PipelineEngine(merge(DEFAULTS, cfg), device="cpu")
    assert teng.gmc_enabled and jeng.gmc_enabled
    jraw = jax.jit(jeng.build_raw_step((GB, GH, GW), want_proc=False))
    traw = teng.build_raw_step((GB, GH, GW), want_proc=False)
    frames, known = _panning_clip(2 * GB)
    jprev = jnp.zeros((GMC_SIZE, GMC_SIZE), jnp.float32)
    jvalid = jnp.float32(0.0)
    tprev, tvalid = torch.zeros((GMC_SIZE, GMC_SIZE)), torch.zeros(())
    jst, tst = jeng.sort_state, teng.sort_state
    n_ids = 0
    for b in range(2):
        fb = frames[b * GB:(b + 1) * GB]
        ts = ((b * GB + np.arange(GB)) / 30.0).astype(np.float32)
        got = teng._shifts(torch.from_numpy(fb), tprev, tvalid)[0].numpy()
        want = np.asarray(jgmc.batch_shifts(
            jprev, jax.vmap(jgmc.gray_thumbnail)(jnp.asarray(fb)), jvalid,
            (GW // GMC_SIZE, GH // GMC_SIZE)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, known[b * GB:(b + 1) * GB])
        _, jouts, jst, jgray = jraw(jeng.detector.params, jst,
                                    jnp.asarray(fb), jnp.asarray(ts), jprev,
                                    jvalid)
        before = [t.clone() for t in tst]
        _, touts, new, tgray = traw(tst, torch.from_numpy(fb),
                                    torch.from_numpy(ts), tprev, tvalid)
        for a, c in zip(before, tst):           # the input left as it was
            assert torch.equal(a.nan_to_num(), c.nan_to_num())
        tst = new
        n_ids += _same_outputs([a.numpy() for a in touts],
                               [np.asarray(a) for a in jouts], f"batch {b}")
        np.testing.assert_allclose(tgray.numpy(), np.asarray(jgray), rtol=0,
                                   atol=GRAY_TOL)
        jprev, jvalid = jgray, jnp.float32(1.0)
        tprev, tvalid = tgray, torch.ones(())
    assert n_ids >= 10
    for k, a in zip(tsort.SortState._fields, tst):
        a, b = a.numpy(), np.asarray(getattr(jst, k))
        if k in ("mean", "obs_mean"):
            np.testing.assert_allclose(a[..., 6], b[..., 6], rtol=0,
                                       atol=AREA_RATE_ATOL, err_msg=k)
            a, b = a[..., :6], b[..., :6]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=ENGINE_RTOL,
                                       atol=ENGINE_ATOL, equal_nan=True,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


# ----------------------------------------------------------------------
# the graph path's plumbing, and the state file

def _dets(results):
    return [r.detections for r in results]


def test_graph_path_carries_gmc_as_the_eager_step(monkeypatch):
    """The engine as it runs a captured step (``step_state`` in, the
    state and GMC's carry copied back) against its eager step, strongsort
    on the pan; then the fleet the same way, botsort + GMC."""
    monkeypatch.setattr(tengine, "CapturedStep", _EagerCapture)
    monkeypatch.setattr(_EagerCapture, "made", [])
    cfg = merge(DEFAULTS, _gmc_cfg())
    graph, eager = (PipelineEngine(cfg, device="cpu") for _ in range(2))
    graph.step_mode = "graph"
    held = list(graph.step_state())
    assert len(held) == len(tsort.SortState._fields) + 2
    frames, _ = _panning_clip(2 * GB)
    for b in range(2):
        fb = frames[b * GB:(b + 1) * GB]
        ts = 100.0 + (b * GB + np.arange(GB)) / 30.0
        assert _dets(graph.process_batch(fb, ts)) \
            == _dets(eager.process_batch(fb, ts))
    assert all(a is b for a, b in zip(held, graph.step_state()))
    assert len(graph._graphs) == 1 and float(graph.gmc_valid) == 1.0
    for a, b in zip(graph.step_state(), eager.step_state()):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())

    fcfg = merge(DEFAULTS, _fleet_cfg(FLEETS["botsort_gmc"]))
    fleets = [MultiStreamEngine(fcfg, FS, devices=["cpu"])
              for _ in range(2)]
    fleets[0].groups[0].engine.step_mode = "graph"
    for k, (frames, ts) in enumerate(_fleet_batches()):
        stamps = 50.0 + ts.astype(np.float64)
        got, want = (f.process_batch(frames, stamps) for f in fleets)
        for g, w in zip(got, want):
            assert _dets(g) == _dets(w), k
        if k == 0:
            grp = fleets[0].groups[0]
            kept = list(grp.step_state())
    assert all(a is b for a, b in zip(kept, grp.step_state()))
    assert torch.equal(grp.gmc_prev, fleets[1].groups[0].gmc_prev)


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_graph_path_resets_in_place(monkeypatch, name):
    """The fleet as it runs a captured step, a ``reset()`` between two
    passes over the same batches: the group's state (GMC's (S, G, G)
    carry too) keeps its tensors and the step is not captured again; the
    second pass equals the first, and both the eager fleet's."""
    monkeypatch.setattr(tengine, "CapturedStep", _EagerCapture)
    monkeypatch.setattr(_EagerCapture, "made", [])
    fcfg = merge(DEFAULTS, _fleet_cfg(FLEETS[name]))
    graph, eager = (MultiStreamEngine(fcfg, FS, devices=["cpu"])
                    for _ in range(2))
    graph.groups[0].engine.step_mode = "graph"
    batches = [(f, 50.0 + t.astype(np.float64))
               for f, t in _fleet_batches()]
    runs = {"graph": [], "eager": []}
    held = None
    for mode, fleet in (("graph", graph), ("eager", eager)):
        for rep in range(2):
            if rep:
                fleet.reset()
            runs[mode].append([[_dets(r) for r in fleet.process_batch(f, t)]
                               for f, t in batches])
            if mode == "graph" and not rep:
                held = graph.groups[0].step_state()
    grp = graph.groups[0]
    assert grp.step_state() is held and len(_EagerCapture.made) == 1
    assert (grp.gmc_prev is held[-2]) == (name == "botsort_gmc")
    assert runs["graph"][0] == runs["graph"][1] == runs["eager"][0] \
        == runs["eager"][1]
    assert sum(len(d) for batch in runs["graph"][0] for stream in batch
               for d in stream) > 0


def test_gmc_carry_stays_in_the_engines_tensors(tmp_path):
    """``reset``, ``save_state`` and ``load_state`` copy GMC's carry into
    the engine's own tensors; the file holds ``gmc_prev`` once a batch has
    set it, as the JAX engine's does, and loads there."""
    cfg = merge(DEFAULTS, _gmc_cfg())
    eng = PipelineEngine(cfg, device="cpu")
    prev, valid = eng.gmc_prev, eng.gmc_valid
    assert prev.shape == (GMC_SIZE, GMC_SIZE) and float(valid) == 0.0
    eng.save_state(tmp_path / "fresh.npz")
    frames, _ = _panning_clip(GB)
    eng.process_batch(frames, 10.0 + np.arange(GB) / 30.0)
    assert float(valid) == 1.0 and prev.any()
    last = prev.clone()
    eng.save_state(tmp_path / "run.npz")
    with np.load(tmp_path / "fresh.npz") as z0, \
            np.load(tmp_path / "run.npz") as z1:
        assert "gmc_prev" not in z0.files and "gmc_prev" in z1.files
        assert set(z1.files) == {f"sort_{k}" for k in
                                 tsort.SortState._fields} | {"gmc_prev",
                                                             "t0"}
        np.testing.assert_array_equal(z1["gmc_prev"], last.numpy())
    eng.reset()
    assert eng.gmc_prev is prev and eng.gmc_valid is valid
    assert float(valid) == 0.0 and not prev.any()
    eng.load_state(tmp_path / "run.npz")
    assert eng.gmc_prev is prev and float(valid) == 1.0
    assert torch.equal(prev, last)
    eng.load_state(tmp_path / "fresh.npz")
    assert eng.gmc_prev is prev and float(valid) == 0.0 and not prev.any()
    jeng = JEngine(jmerge(JDEFAULTS, _gmc_cfg()))
    jeng.load_state(tmp_path / "run.npz")
    np.testing.assert_array_equal(np.asarray(jeng._gmc_prev), last.numpy())
