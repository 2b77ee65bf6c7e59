"""The port's host-free device step against the JAX package (CPU).

* ``track/sort.py::make_sort_scan`` against JAX's ``make_sort_scan`` on
  the same detections, with IoU ties (every object detected twice at the
  same box) and a dependency chain (four boxes 12 px apart sliding under
  their tracks, one hidden for two frames): ids exact, the Kalman state
  within the tracker tests' rtol 1e-5 / atol 1e-4 but the Kalman area
  rate (atol 2e-2: boxes that keep their size have a rate that is the
  float noise of the area over 1/30 s, as in
  ``tests/test_torch_multi_stream.py``), distance and speed within rtol
  1e-3.
* The stacked step (every state field with a stream axis, one
  association for all streams) against JAX's vmapped
  ``track/multi.py::make_multi_sort_step`` and against S single-stream
  runs of the port's step, greedy and ε-auction: ids exact, the stacked
  state equal to the single-stream states.
* The batched plain association (``greedy_associate_plain``,
  ``auction_associate_plain`` over a leading problem axis) equal to one
  problem at a time, ties and NaN scores included.
* ``PipelineEngine.build_raw_step`` against JAX's under ``jax.jit`` at
  2 × 48 × 64 (``assets/yolov8n_synthetic_256.npz`` at imgsz 64, a
  confidence threshold of 1e-6, as ``tests/test_temporal_gate.py``
  drives the JAX raw step), three batches carrying each package's state:
  counts, classes and ids equal, boxes within 0.05 px, confidences
  within 2e-3, distances and speeds within rtol 1e-3; the step leaves its
  input state as it was.
* The same for RT-DETR-L (``assets/rtdetr_l_synthetic_256.npz``) with
  ``configs/rtdetr_demo.yaml``'s auto-gated chain, ``classes_keep``,
  SORT and homography, at 2 × 128 × 128 (imgsz 128, two decoder layers,
  float32, the bf16 gather values off in both packages), one frame of
  each batch carrying impulse noise so that the gate runs the chain on
  it: processed frames equal, and the detections and tracks under the
  same limits.
* ``step_mode``: the static choice of graph or eager, from the
  configuration (RT-DETR and the auto-gate replay a graph, RT-DETR in
  int8 stays eager); the engine's state stays in its own tensors
  through ``step``, ``reset`` and ``load_state``; a recalibrated gate
  drops the captured steps (an eager stand-in for the capture here).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.config import load_config as jload_config
from roadvision_tpu.geometry import build_projector as jbuild_projector
from roadvision_tpu.models import rtdetr as jrtdetr
from roadvision_tpu.runtime.engine import PipelineEngine as JEngine
from roadvision_tpu.track import multi as jmulti
from roadvision_tpu.track import sort_tpu as jsort
from roadvision_tpu_torch.config import load_config, merge
from roadvision_tpu_torch.geometry import build_projector as tbuild_projector
from roadvision_tpu_torch.io_video import SyntheticRoadSource
from roadvision_tpu_torch.models import rtdetr as trtdetr
from roadvision_tpu_torch.ops.color import bgr_to_gray_u8
from roadvision_tpu_torch.runtime import engine as tengine
from roadvision_tpu_torch.runtime.engine import PipelineEngine
from roadvision_tpu_torch.runtime.graph import CapturedStep
from roadvision_tpu_torch.tools.bench import bench_cfg
from roadvision_tpu_torch.track import multi as tmulti
from roadvision_tpu_torch.track import sort as tsort

CFG = (0.35, 1.2, 0.8)        # iou_threshold, max_staleness, speed_window
T, D, F, S = 16, 8, 12, 3
KF_RTOL, KF_ATOL = 1e-5, 1e-4
AREA_RATE_ATOL = 2e-2
BOX_TOL, CONF_TOL, METRIC_RTOL = 0.05, 2e-3, 1e-3
NPZ = "assets/yolov8n_synthetic_256.npz"
RTDETR_NPZ = "assets/rtdetr_l_synthetic_256.npz"
SHAPE = (2, 48, 64)
RT_SHAPE = (2, 128, 128)


def _proj_cfg():
    return {"projector": {
        "type": "homography",
        "image_points": [[0, 480], [640, 480], [0, 80], [640, 80]],
        "world_points": [[0.0, 0.0], [6.4, 0.0], [0.0, 40.0], [6.4, 40.0]],
        "origin": [3.2, -2.0], "max_distance": 35.0}}


def _frames(seed: int, n: int = F):
    """n frames of (D,) detections: two objects detected twice each at
    the same box (ties in rows and columns), and a chain of four boxes 12
    px apart, each overlapping its neighbours, sliding 6 px a frame, the
    last one hidden in frames 5 and 6. → (boxes (n, D, 4), cls, conf,
    valid, ts (n,))."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(60, 400, (2, 2))
    vel = rng.uniform(-6, 6, (2, 2))
    boxes = np.zeros((n, D, 4), np.float32)
    valid = np.zeros((n, D), bool)
    for f in range(n):
        for o in range(2):
            xy = base[o] + vel[o] * f
            boxes[f, 2 * o:2 * o + 2] = (*xy, *(xy + 40))
            valid[f, 2 * o:2 * o + 2] = True
        x0 = 200 + 6 * f + 20 * seed
        for j in range(4):
            if j == 3 and f in (5, 6):
                continue
            boxes[f, 4 + j] = (x0 + 12 * j, 300, x0 + 12 * j + 30, 330)
            valid[f, 4 + j] = True
    conf = (rng.uniform(0.3, 0.95, (n, D)) * valid).astype(np.float32)
    cls = np.full((n, D), 2, np.int32)
    ts = (np.arange(n) / 30.0 + 0.01 * seed).astype(np.float32)
    return boxes, cls, conf, valid, ts


def _assert_state(got, want, what=""):
    for k in tsort.SortState._fields:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape, f"{what} {k}"
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
            continue
        if k in ("mean", "obs_mean"):
            np.testing.assert_allclose(a[..., 6], b[..., 6], rtol=0,
                                       atol=AREA_RATE_ATOL,
                                       err_msg=f"{what} {k} area rate")
            a, b = a[..., :6], b[..., :6]
        np.testing.assert_allclose(a, b, rtol=KF_RTOL, atol=KF_ATOL,
                                   equal_nan=True, err_msg=f"{what} {k}")


def _assert_metrics(got, want):
    np.testing.assert_array_equal(got.track_id.numpy(),
                                  np.asarray(want.track_id))
    for k in ("distance_m", "speed_kmh"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)),
                                   rtol=METRIC_RTOL, atol=1e-4,
                                   equal_nan=True, err_msg=k)


@pytest.fixture(scope="module")
def projectors():
    jp = jbuild_projector(_proj_cfg()).device_params()
    tp = tbuild_projector(_proj_cfg(), device="cpu").device_params()
    return jp, tp


@pytest.mark.parametrize("proj", [True, False])
def test_sort_scan_matches_jax(projectors, proj):
    jp, tp = projectors if proj else (None, None)
    arrays = _frames(0)
    jstate, jout = jsort.make_sort_scan(*CFG, with_projector=proj)(
        jsort.init_state(T), *map(jnp.asarray, arrays), jp)
    tstate, tout = tsort.make_sort_scan(*CFG, with_projector=proj)(
        tsort.init_state(T, "cpu"), *map(torch.from_numpy, arrays), tp)
    assert tout.track_id.shape == (F, D)
    _assert_metrics(tout, jout)
    _assert_state(tstate, jstate, "scan")
    # the ties and the chain were there: more detections than objects
    # kept an id, and the hidden box came back under its old id
    ids = tout.track_id.numpy()
    assert (ids[:, :4] > 0).all() and ids[7, 7] == ids[4, 7] > 0


@pytest.fixture(scope="module")
def stacked_inputs():
    per = [_frames(s) for s in range(S)]
    return tuple(np.stack([p[i] for p in per]) for i in range(5))


@pytest.mark.parametrize("association", ["greedy", "hungarian"])
def test_stacked_step_matches_jax_vmap_and_single_streams(
        projectors, stacked_inputs, association):
    jp, tp = projectors
    boxes, cls, conf, valid, ts = stacked_inputs
    jstep = jmulti.make_multi_sort_step(*CFG, with_projector=True,
                                        association=association)
    tstep = tmulti.make_multi_sort_step(*CFG, with_projector=True,
                                        association=association)
    one = tsort.make_sort_step(*CFG, association=association)
    jst = jmulti.init_multi_state(S, T)
    tst = tmulti.init_multi_state(S, T, device="cpu")
    singles = [tsort.init_state(T, "cpu") for _ in range(S)]
    for f in range(F):
        frame = [a[:, f] for a in (boxes, cls, conf, valid, ts)]
        jst, jout = jstep(jst, *map(jnp.asarray, frame), jp)
        tst, tout = tstep(tst, *map(torch.from_numpy, frame), tp)
        _assert_metrics(tout, jout)
        for s in range(S):
            singles[s], sout = one(singles[s], *(torch.as_tensor(a[s])
                                                 for a in frame), tp)
            np.testing.assert_array_equal(tout.track_id[s].numpy(),
                                          sout.track_id.numpy())
    _assert_state(tst, jst, "stacked")
    for s in range(S):
        for k, v in zip(tsort.SortState._fields, singles[s]):
            np.testing.assert_array_equal(getattr(tst, k)[s].numpy(),
                                          v.numpy(), err_msg=k)
    if association == "greedy":
        # the stacked scan gives what the stacked steps gave
        st2, out2 = tsort.make_sort_scan(*CFG, with_projector=True)(
            tmulti.init_multi_state(S, T, device="cpu"),
            *map(torch.from_numpy, (boxes, cls, conf, valid, ts)), tp)
        assert out2.track_id.shape == (S, F, D)
        for k, v in zip(tsort.SortState._fields, st2):
            np.testing.assert_array_equal(v.numpy(), getattr(tst, k).numpy(),
                                          err_msg=k)


def test_hooked_step_refuses_a_stacked_state():
    """A hooked step takes a stacked state (as every step does) and
    refuses one only with detections that lack the stream axis."""
    from roadvision_tpu_torch.track import registry
    step = registry.build_device_step({"backend": "bytetrack"})
    st = tmulti.init_multi_state(2, T, device="cpu")
    z = torch.zeros((2, D))
    st2, out = step(st, torch.zeros((2, D, 4)), z.int(), z, z.bool(),
                    torch.zeros(2))
    assert out.track_id.shape == (2, D) and st2.mean.shape == (2, T, 7)
    with pytest.raises(ValueError, match="stacked state"):
        step(st, torch.zeros((D, 4)), z[0].int(), z[0], z[0].bool(),
             torch.zeros(2))


def _problems(seed: int, p: int = 6, t: int = 12, d: int = 9):
    rng = np.random.RandomState(seed)
    # quantised scores: many ties within rows and columns
    iou = (rng.randint(0, 8, (p, t, d)) / 8.0).astype(np.float32)
    alive = rng.rand(p, t) < 0.8
    dvalid = rng.rand(p, d) < 0.8
    alive[0] = False                   # a problem with no live track
    dvalid[1] = False                  # and one with no valid detection
    return iou, alive, dvalid


@pytest.mark.parametrize("nan", [False, True])
def test_batched_plain_association_equals_one_problem_at_a_time(nan):
    iou, alive, dvalid = _problems(7)
    if nan:
        iou[2, 3, 4] = iou[4, 0, 0] = iou[4, 5, 2] = np.nan
    args = tuple(map(torch.from_numpy, (iou, alive, dvalid)))
    for fn in (tsort.greedy_associate_plain, tsort.auction_associate_plain):
        batched = fn(*args, 0.3)
        assert batched.shape == dvalid.shape and batched.dtype == torch.int32
        for i in range(iou.shape[0]):
            assert torch.equal(batched[i], fn(*(a[i] for a in args), 0.3))
    if not nan:     # and the JAX greedy, problem by problem
        jg = jax.jit(jsort.greedy_associate, static_argnums=3)
        for i in range(iou.shape[0]):
            want = np.asarray(jg(*(jnp.asarray(a[i])
                                   for a in (iou, alive, dvalid)), 0.3))
            np.testing.assert_array_equal(
                tsort.greedy_associate(*(a[i] for a in args), 0.3).numpy(),
                want)


def _raw_cfg():
    return {"detect": {"enabled": True, "model": NPZ, "imgsz": 64,
                       "conf_thres": 1e-6, "max_det": 8,
                       "compute_dtype": "float32"},
            "tracking": {"enabled": True, "backend": "sort"},
            "geometry": {"enabled": True, **_proj_cfg()},
            "preprocess": {"enabled": False},
            "tpu": {"batch_size": 2, "compute_dtype": "float32"}}


def _noise_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (SHAPE[1], SHAPE[2], 3), np.uint8)
    return [(np.stack([np.roll(base, (i * 2 + j) * 3, axis=1)
                       for j in range(2)]),
             (i * 2 + np.arange(2)) / 30.0) for i in range(n)]


def test_raw_step_matches_jax_raw_step():
    jeng = JEngine(_raw_cfg())
    teng = PipelineEngine(_raw_cfg(), device="cpu")
    jraw = jax.jit(jeng.build_raw_step(SHAPE, want_proc=False))
    traw = teng.build_raw_step(SHAPE, want_proc=False)
    jstate, tstate = jeng.sort_state, teng.sort_state
    n_ids = 0
    for frames, ts in _noise_batches(3):
        ts32 = ts.astype(np.float32)
        _, jouts, jstate = jraw(jeng.detector.params, jstate,
                                jnp.asarray(frames), jnp.asarray(ts32))
        before = [t.numpy().copy() for t in tstate]
        _, touts, new = traw(tstate, torch.from_numpy(frames),
                             torch.from_numpy(ts32))
        for a, b in zip(before, tstate):      # the input left as it was
            np.testing.assert_array_equal(a, b.numpy())
        tstate = new
        jb, jc, jk, jv, jids, jd, js = (np.asarray(a) for a in jouts)
        tb, tc, tk, tv, tids, td, tsp = (a.numpy() for a in touts)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tk[tv], jk[jv])
        np.testing.assert_array_equal(tids[tv], jids[jv])
        np.testing.assert_allclose(tb[tv], jb[jv], rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(tc[tv], jc[jv], rtol=0, atol=CONF_TOL)
        for g, w in ((td, jd), (tsp, js)):
            np.testing.assert_allclose(g[tv], w[jv], rtol=METRIC_RTOL,
                                       atol=1e-4, equal_nan=True)
        n_ids += int((tids[tv] > 0).sum())
    assert n_ids >= 12


def _rtdetr_demo_cfg(load):
    """configs/rtdetr_demo.yaml at 128 × 128, batch 2, imgsz 128, two
    decoder layers, float32."""
    cfg = load("configs/rtdetr_demo.yaml")
    cfg["detect"].update(model=RTDETR_NPZ, imgsz=128, decoder_layers=2,
                         compute_dtype="float32")
    cfg["camera"].update(width=RT_SHAPE[2], height=RT_SHAPE[1])
    cfg["tpu"].update(batch_size=2, compute_dtype="float32")
    return cfg


def _road_batches(n, seed=1):
    """n batches of two synthetic road frames (impulse statistic 1.8-2.0
    at 128², under the demo's 2.5), the second of each with impulse noise
    on 8 % of its pixels (10-12: the gate's chain runs on it)."""
    src = SyntheticRoadSource(RT_SHAPE[2], RT_SHAPE[1], num_vehicles=3,
                              seed=seed)
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        frames = np.stack([src.render(2 * i + j) for j in range(2)])
        hit = rng.rand(*RT_SHAPE[1:]) < 0.08
        frames[1][hit] = rng.choice([0, 255], (int(hit.sum()), 1))
        out.append((frames, ((2 * i + np.arange(2)) / 30.0)
                    .astype(np.float32)))
    return out


def test_rtdetr_raw_step_matches_jax_raw_step(monkeypatch):
    monkeypatch.setattr(jrtdetr, "_BF16_VALS", False)
    monkeypatch.setattr(trtdetr, "_BF16_VALS", False)
    jeng = JEngine(_rtdetr_demo_cfg(jload_config))
    teng = PipelineEngine(_rtdetr_demo_cfg(load_config), device="cpu")
    batches = _road_batches(3)
    # the demo's gate keys on the impulse statistic alone (contrast 0)
    for frames, _ in batches:
        stats = teng.pipeline.gate_stats(bgr_to_gray_u8(
            torch.from_numpy(frames)))[1]
        assert float(stats[0]) < 2.2 and float(stats[1]) > 8.0
    jraw = jax.jit(jeng.build_raw_step(RT_SHAPE, want_proc=True))
    traw = teng.build_raw_step(RT_SHAPE, want_proc=True)
    jstate, tstate = jeng.sort_state, teng.sort_state
    n_ids = 0
    for frames, ts in batches:
        jproc, jouts, jstate = jraw(jeng.detector.params, jstate,
                                    jnp.asarray(frames), jnp.asarray(ts))
        tproc, touts, tstate = traw(tstate, torch.from_numpy(frames),
                                    torch.from_numpy(ts))
        np.testing.assert_array_equal(tproc.numpy(), np.asarray(jproc))
        assert not np.array_equal(tproc.numpy()[1], frames[1])
        np.testing.assert_array_equal(tproc.numpy()[0], frames[0])
        jb, jc, jk, jv, jids, jd, js = (np.asarray(a) for a in jouts)
        tb, tc, tk, tv, tids, td, tsp = (a.numpy() for a in touts)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tk[tv], jk[jv])
        np.testing.assert_array_equal(tids[tv], jids[jv])
        np.testing.assert_allclose(tb[tv], jb[jv], rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(tc[tv], jc[jv], rtol=0, atol=CONF_TOL)
        for g, w in ((td, jd), (tsp, js)):
            np.testing.assert_allclose(g[tv], w[jv], rtol=METRIC_RTOL,
                                       atol=1e-4, equal_nan=True)
        assert (tk[tv] == 2).all()
        n_ids += int((tids[tv] > 0).sum())
    assert n_ids >= 8


def _as_on_card(cfg):
    """The engine's static choice, read as it would be on the card."""
    eng = PipelineEngine(cfg, device="cpu")
    assert eng.step_mode == "eager" and "CPU" in eng.eager_reason
    eng.device = torch.device("cuda")
    return eng._eager_reason()


def _main_cfg(**over):
    return merge(bench_cfg(64, 96, 2, NPZ, "float32"), over)


@pytest.mark.parametrize("over,graph", [
    ({}, True),
    ({"tracking": {"association": "hungarian"}}, True),
    ({"tracking": {"enabled": False}}, True),
    ({"tpu": {"sampled_preprocess": True}}, True),
    ({"detect": {"temporal_gate": {"enable": True}}}, False),
    ({"tracking": {"backend": "ocsort"}}, True),
    ({"tracking": {"gmc": True}}, True),
    ({"tracking": {"backend": "bytetrack"}}, True),
    ({"tracking": {"backend": "deepsort",
                   "reid_weights": "assets/reid_synthetic.npz"}}, True),
    ({"tracking": {"backend": "strongsort"}}, True),
    ({"tracking": {"backend": "botsort", "gmc": True}}, True),
    ({"detect": {"tta": True}}, False),
    ({"preprocess": {"auto_gate": {"enable_low_contrast_gate": True}}},
     True),
    ({"detect": {"model": RTDETR_NPZ}}, True),
    ({"detect": {"model": RTDETR_NPZ, "compute_dtype": "int8"}}, False),
])
def test_step_mode_is_chosen_from_the_configuration(over, graph):
    reason = _as_on_card(_main_cfg(**over))
    assert (reason is None) == graph, reason


@pytest.mark.parametrize("gmc", [False, True])
@pytest.mark.parametrize("tracking", [
    {}, {"association": "hungarian"}, {"backend": "bytetrack"},
    {"backend": "ocsort"}, {"backend": "deepsort"},
    {"backend": "deepsort", "reid_weights": "assets/reid_synthetic.npz"},
    {"backend": "strongsort"}, {"backend": "botsort"}],
    ids=["sort", "hungarian", "bytetrack", "ocsort", "deepsort",
         "deepsort_reid", "strongsort", "botsort"])
def test_every_tracking_backend_replays_a_graph(tracking, gmc):
    """Every backend, with GMC on and off, and the fleet of it: the only
    reasons left to run eagerly are the temporal gate, the detector
    variants and int8."""
    cfg = _main_cfg(tracking=dict(tracking, gmc=gmc))
    assert _as_on_card(cfg) is None
    eng = PipelineEngine(cfg, device="cpu")
    assert eng.gmc_enabled == gmc


def test_analytics_demo_config_replays_a_graph():
    """configs/analytics_demo.yaml (deepsort with the learned re-id):
    the last shipped config that ran eagerly."""
    cfg = load_config("configs/analytics_demo.yaml")
    assert cfg["tracking"]["backend"] == "deepsort"
    assert _as_on_card(cfg) is None


def test_rtdetr_demo_config_replays_a_graph():
    assert _as_on_card(load_config("configs/rtdetr_demo.yaml")) is None


def test_rtdetr_int8_names_its_eager_reason():
    cfg = _main_cfg(detect={"model": RTDETR_NPZ, "compute_dtype": "int8"})
    assert "RTDETRTorch" in _as_on_card(cfg) and "int8" in _as_on_card(cfg)


class _EagerCapture:
    """An eager stand-in for ``CapturedStep`` (the CPU has no graphs):
    calls the step on every replay, writing the new state in place."""
    made = []

    def __init__(self, fn, state, args):
        self.fn, self.state = fn, state
        _EagerCapture.made.append(self)

    def __call__(self, *args):
        outs, new = self.fn(self.state, *args)
        for dst, src in zip(self.state or (), new or ()):
            dst.copy_(src)
        return outs


def test_recalibrated_gate_drops_the_captured_steps(monkeypatch):
    """An "auto" gate resolved from the first batch before its capture;
    a later ``calibrate_gate`` drops the graph, and the next batch runs
    a new one with the new threshold."""
    monkeypatch.setattr(tengine, "CapturedStep", _EagerCapture)
    monkeypatch.setattr(_EagerCapture, "made", [])
    cfg = _main_cfg(preprocess={"auto_gate": {
        "enable_low_contrast_gate": True, "contrast_thresh": "auto"}},
        detect={"enabled": False}, tracking={"enabled": False})
    eng = PipelineEngine(cfg, device="cpu")
    eng.step_mode = "graph"
    frames = torch.from_numpy(_noise_batches(1)[0][0])
    ts = torch.zeros(2)
    eng.step_batch(frames, ts)
    eng.step_batch(frames, ts)
    assert eng.pipeline.gate_epoch == 1 and len(_EagerCapture.made) == 1
    eng.pipeline.calibrate_gate(stats=np.array([0.0]))      # never runs
    proc, _ = eng.step_batch(frames, ts)
    assert len(_EagerCapture.made) == 2 and len(eng._graphs) == 1
    assert torch.equal(proc, frames)
    eng.pipeline.calibrate_gate(stats=np.array([1e6]))      # always runs
    proc, _ = eng.step_batch(frames, ts)
    assert len(_EagerCapture.made) == 3
    assert torch.equal(proc, eng.pipeline.apply_batch(frames))
    assert not torch.equal(proc, frames)


def test_multi_stream_config_replays_a_graph():
    cfg = load_config("configs/multi_stream.yaml")
    cfg["detect"]["model"] = NPZ
    cfg["detect"]["imgsz"] = 64
    assert _as_on_card(cfg) is None


def test_state_stays_in_the_engines_tensors(tmp_path):
    """``step``, ``reset`` and ``load_state`` copy into the engine's own
    state tensors (a captured graph reads and writes those)."""
    eng = PipelineEngine(_raw_cfg(), device="cpu")
    held = list(eng.sort_state)
    for frames, ts in _noise_batches(2):
        eng.process_batch(frames, 1000.0 + ts, want_proc=False)
    assert all(a is b for a, b in zip(held, eng.sort_state))
    assert int(eng.sort_state.next_id) > 1
    eng.save_state(tmp_path / "s.npz")
    eng.reset()
    assert all(a is b for a, b in zip(held, eng.sort_state))
    assert int(eng.sort_state.next_id) == 1 and not eng.sort_state.alive.any()
    eng.load_state(tmp_path / "s.npz")
    assert all(a is b for a, b in zip(held, eng.sort_state))
    assert int(eng.sort_state.next_id) > 1


def test_run_step_calls_the_step_where_it_runs_eagerly():
    """``run_step`` on an eager engine (the CPU) calls the step and
    hands back its state; it captures nothing."""
    eng = PipelineEngine(_raw_cfg(), device="cpu")
    state = (torch.zeros(3),)
    outs, new = eng.run_step(("fleet", (3,)),
                             lambda st, a: ((a + 1,), (st[0] + a,)), state,
                             (torch.ones(3),))
    assert torch.equal(outs[0], torch.full((3,), 2.0))
    assert torch.equal(new[0], torch.ones(3)) and not eng._graphs


def test_captured_step_needs_the_card():
    x = torch.zeros(2)
    with pytest.raises(ValueError, match="card"):
        CapturedStep(lambda st, a: (a, st), None, (x,))
