"""The port's tracker family vs the JAX package and the float64 oracles
(CPU).

Recorded detection sequences (T = 24 slots, D = 12 detections, 28
frames: crossing objects, an occlusion gap, low-confidence frames,
per-identity descriptors with noise, a camera pan) go through each JAX
backend's step, jitted once per module, and the port's step on the same
seeded numpy inputs. Held, for every frame: track ids bit-equal;
distance and speed within rtol 1e-3 (as ``tests/test_torch_track.py``);
and after the last frame the whole ``SortState``: the Kalman mean and
covariance and the observation posterior within rtol 1e-5, atol 1e-4,
the appearance memory within atol 1e-5, every integer and boolean field
equal. ByteTrack and OC-SORT also match their float64 oracles' ids;
OC-SORT's OCM score matrix (which carries the arccos penalty) is held to
atol 1e-4: near cos = ±1 an ulp of cos (6e-8) moves arccos by up to
sqrt(2·6e-8) ≈ 3.5e-4 rad, 2.2e-5 in the score at vdc_weight 0.2.
The ε-auction (``association: hungarian``) is held equal to the JAX one
on random sparse IoU matrices, its ``max_iters`` cap included.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.detect.types import Detection as JDetection
from roadvision_tpu.geometry import build_projector as jbuild_projector
from roadvision_tpu.track import ocsort as jocs
from roadvision_tpu.track import registry as jreg
from roadvision_tpu.track import sort_tpu as jsort
from roadvision_tpu_torch.detect import Detection
from roadvision_tpu_torch.geometry import build_projector as tbuild_projector
from roadvision_tpu_torch.track import ocsort as tocs
from roadvision_tpu_torch.track import registry as treg
from roadvision_tpu_torch.track import sort as tsort
from roadvision_tpu_torch.track.appearance import EMB_DIM
from tests.oracles.byte_oracle import ByteOracle
from tests.oracles.ocsort_oracle import OcSortOracle

T, D, FRAMES = 24, 12, 28
BASE = dict(max_staleness=1.2, speed_window=0.8, iou_threshold=0.3)
KF_RTOL, KF_ATOL, APP_ATOL = 1e-5, 1e-4, 1e-5
BACKENDS = {
    "sort": dict(backend="sort"),
    "hungarian": dict(backend="sort", association="hungarian"),
    "bytetrack": dict(backend="bytetrack"),
    "ocsort": dict(backend="ocsort"),
    "deepsort": dict(backend="deepsort"),
    "strongsort": dict(backend="strongsort"),
    "botsort": dict(backend="botsort"),
}
# which cases feed descriptors / camera shifts to the step
EMB = {"deepsort", "strongsort", "botsort"}
SHIFT = {"strongsort", "botsort", "sort"}


def _proj_cfg():
    return {"projector": {
        "type": "homography",
        "image_points": [[0, 480], [640, 480], [0, 80], [640, 80]],
        "world_points": [[0.0, 0.0], [6.4, 0.0], [0.0, 40.0], [6.4, 40.0]],
        "origin": [3.2, -2.0], "max_distance": 35.0}}


@functools.lru_cache(maxsize=None)
def _jstep(name):
    """The JAX backend's step, jitted once per module."""
    return jax.jit(jreg.build_device_step(dict(BASE, **BACKENDS[name])))


@functools.lru_cache(maxsize=None)
def _sequence(pan: bool):
    """28 frames of 9 objects: linear motion with distinct sizes, two
    crossing, one hidden for 5 frames, one reappearing after 9; a
    confidence per detection and frame (some low, some under the start
    thresholds); descriptors per identity with noise; with ``pan`` every
    box moves by the frame's camera shift. Returns per frame (boxes (D,
    4), conf (D,), valid (D,), emb (D, E), shift (2,), ts)."""
    rng = np.random.RandomState(7)
    n = 9
    pos = rng.uniform(40, 520, (n, 2))
    vel = rng.uniform(-7, 7, (n, 2))
    size = np.stack([rng.uniform(30, 90, n), rng.uniform(25, 70, n)], 1)
    pos[0], vel[0] = (100, 200), (9, 0.5)           # the crossing pair
    pos[1], vel[1] = (330, 205), (-9, 0.0)
    ident = rng.normal(size=(n, EMB_DIM))
    ident /= np.linalg.norm(ident, axis=1, keepdims=True)
    cam = np.zeros(2)
    out, t = [], 0.0
    for f in range(FRAMES):
        shift = rng.uniform(-6, 6, 2).round() if pan and f else np.zeros(2)
        cam += shift
        t += 1 / 30 if f % 9 else 0.1
        boxes = np.zeros((D, 4), np.float32)
        conf = np.zeros((D,), np.float32)
        valid = np.zeros((D,), bool)
        emb = np.zeros((D, EMB_DIM), np.float32)
        slot = 0
        for k in rng.permutation(n):
            if (k == 3 and 8 <= f < 13) or (k == 5 and 4 <= f < 13):
                continue
            xy = pos[k] + vel[k] * f + cam
            boxes[slot] = (*xy, *(xy + size[k] + 0.4 * f))
            conf[slot] = rng.choice([rng.uniform(0.62, 0.98),
                                     rng.uniform(0.15, 0.45),
                                     rng.uniform(0.5, 0.6)], p=[.7, .2, .1])
            valid[slot] = True
            e = ident[k] + rng.normal(0, 0.15, EMB_DIM)
            emb[slot] = e / np.linalg.norm(e)
            slot += 1
        out.append((boxes, conf, valid, emb, shift.astype(np.float32), t))
    return out


def _inputs(frame, name, pan):
    boxes, conf, valid, emb, shift, t = frame
    cls = np.full((D,), 2, np.int32)
    return ((boxes, cls, conf, valid, np.float32(t)),
            emb if name in EMB else None,
            shift if (pan and name in SHIFT) else None)


def _assert_state(got: tsort.SortState, want, what=""):
    for k in tsort.SortState._fields:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        elif k == "app":
            np.testing.assert_allclose(a, b, rtol=0, atol=APP_ATOL,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b, rtol=KF_RTOL, atol=KF_ATOL,
                                       equal_nan=True, err_msg=f"{what} {k}")


@functools.lru_cache(maxsize=None)
def _drive(name, pan):
    """Both steps over the sequence; returns the per-frame ids of JAX
    (numpy) after asserting the port's equal, frame by frame."""
    jstep = _jstep(name)
    tstep = treg.build_device_step(dict(BASE, **BACKENDS[name]))
    jp = jbuild_projector(_proj_cfg()).device_params()
    tp = tbuild_projector(_proj_cfg(), device="cpu").device_params()
    js, ts = jsort.init_state(T), tsort.init_state(T, device="cpu")
    ids = []
    for f, frame in enumerate(_sequence(pan)):
        args, emb, shift = _inputs(frame, name, pan)
        js, jo = jstep(js, *map(jnp.asarray, args), jp,
                       None if emb is None else jnp.asarray(emb),
                       None if shift is None else jnp.asarray(shift))
        ts, to = tstep(ts, *(torch.from_numpy(np.asarray(a)) for a in args),
                       tp, None if emb is None else torch.from_numpy(emb),
                       None if shift is None else torch.from_numpy(shift))
        np.testing.assert_array_equal(to.track_id.numpy(),
                                      np.asarray(jo.track_id),
                                      err_msg=f"{name} ids, frame {f}")
        for k in (1, 2):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       rtol=1e-3, atol=1e-3, equal_nan=True)
        ids.append(np.asarray(jo.track_id))
    _assert_state(ts, js, name)
    return ids, js


@pytest.mark.parametrize("pan", [False, True], ids=["still", "pan"])
@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_backend_matches_jax_step(name, pan):
    ids, state = _drive(name, pan)
    n_ids = len({int(i) for f in ids for i in f if i > 0})
    assert n_ids >= 6, n_ids                 # the run did track objects
    if name in EMB:                           # the appearance memory moved
        app = np.asarray(state.app)[np.asarray(state.alive)]
        assert np.allclose(np.linalg.norm(app, axis=1), 1.0, atol=1e-5)


def test_backends_differ_where_they_should():
    """The strategies are not all SORT in disguise: on the still sequence
    each backend's ids differ from greedy SORT's somewhere (hungarian
    and deepsort excepted where the IoU matrix leaves no choice)."""
    base = _drive("sort", False)[0]
    for name in ("bytetrack", "ocsort", "botsort", "strongsort"):
        got = _drive(name, False)[0]
        assert any(not np.array_equal(a, b) for a, b in zip(got, base)), name


def _oracle_ids(oracle, pan):
    out = []
    for boxes, conf, valid, _, _, t in _sequence(pan):
        n = int(valid.sum())
        res = oracle.update([tuple(map(float, b)) for b in boxes[:n]],
                            [float(c) for c in conf[:n]], t)
        out.append([r["id"] or 0 for r in res])
    return out


@pytest.mark.parametrize("name", ["bytetrack", "ocsort"])
def test_backend_matches_float64_oracle(name):
    ids, _ = _drive(name, False)
    if name == "bytetrack":
        oracle = ByteOracle(BASE["max_staleness"], BASE["speed_window"],
                            match_iou=BASE["iou_threshold"])
    else:
        oracle = OcSortOracle(BASE["max_staleness"], BASE["speed_window"],
                              iou_threshold=BASE["iou_threshold"])
    for f, (got, want) in enumerate(zip(ids, _oracle_ids(oracle, False))):
        assert [int(i) for i in got[:len(want)]] == want, f


def test_ocm_score_matrix_matches_jax():
    """OC-SORT's stage-1 score, 2 + IoU − w·angle/π on gated pairs, from
    the same post-predict states: within atol 1e-4 (arccos near ±1
    amplifies an ulp of cos, see the module docstring), and the
    association equal."""
    assoc_j = jocs.make_oc_associate(0.3, 0.2, 0.3)
    assoc_t = tocs.make_oc_associate(0.3, 0.2, 0.3)

    def jscore(state, boxes, dvalid, conf):
        seen = []
        orig = jocs.greedy_associate

        def spy(score, alive, dv, thr):
            seen.append(score)
            return orig(score, alive, dv, thr)
        jocs.greedy_associate = spy
        try:
            iou = jsort.iou_matrix(jsort.x_to_bbox(state.mean), boxes)
            d2t = assoc_j(iou, state.alive, dvalid, conf,
                          (state, boxes, 0.0, None))
        finally:
            jocs.greedy_associate = orig
        return d2t, seen[0]
    jscore = jax.jit(jscore)

    seen_t = []
    orig_t = tocs.greedy_associate
    jstep = _jstep("ocsort")
    js = jsort.init_state(T)
    checked = 0
    for f, frame in enumerate(_sequence(False)):
        (boxes, cls, conf, valid, t), _, _ = _inputs(frame, "ocsort", False)
        if f >= 2:
            # the state the step's association sees: the predict at t
            dt = jnp.maximum(1e-3, t - js.last_predict_ts)
            pm, pc = jsort._kf_predict(js.mean, js.cov, dt)
            pre = js._replace(mean=jnp.where(js.alive[:, None], pm, js.mean))
            d2t_j, score_j = jscore(pre, jnp.asarray(boxes),
                                    jnp.asarray(valid), jnp.asarray(conf))
            tpre = tsort.state_from_jax(
                {k: np.asarray(v) for k, v in pre._asdict().items()},
                device="cpu")
            tb = torch.from_numpy(boxes)
            iou = tsort.iou_matrix(tsort.x_to_bbox(tpre.mean), tb)
            seen_t.clear()
            tocs.greedy_associate = lambda s, *a: (seen_t.append(s),
                                                   orig_t(s, *a))[1]
            try:
                d2t_t = assoc_t(iou, tpre.alive, torch.from_numpy(valid),
                                torch.from_numpy(conf), (tpre, tb, t, None))
            finally:
                tocs.greedy_associate = orig_t
            np.testing.assert_allclose(seen_t[0].numpy(),
                                       np.asarray(score_j), rtol=0,
                                       atol=1e-4)
            np.testing.assert_array_equal(d2t_t.numpy(), np.asarray(d2t_j))
            checked += int((np.asarray(score_j) > 1.0).sum())
        js, _ = jstep(js, *map(jnp.asarray, (boxes, cls, conf, valid, t)),
                      jbuild_projector(_proj_cfg()).device_params(),
                      None, None)
    assert checked > 50


def _sparse_iou(rng, nt, nd):
    iou = rng.uniform(0, 1, (nt, nd)).astype(np.float32)
    iou[rng.uniform(size=(nt, nd)) < 0.7] = 0.0
    return iou


@pytest.mark.parametrize("seed", range(4))
def test_auction_matches_jax(seed):
    """The ε-auction in blocks of AUCTION_BLOCK rounds, one host read a
    block, against the JAX ``while_loop``: same assignment, with the
    ``max_iters`` cap at a count that is not a multiple of the block."""
    rng = np.random.RandomState(seed)
    nt, nd = (16, 12) if seed % 2 else (10, 14)
    iou = _sparse_iou(rng, nt, nd)
    alive = rng.uniform(size=nt) < 0.85
    dvalid = rng.uniform(size=nd) < 0.9
    jfn = jax.jit(jsort.auction_associate, static_argnums=(3, 4, 5))
    for thresh, eps, iters in ((0.3, 0.01, 512), (0.1, 0.05, 13),
                               (0.0, 0.01, 3)):
        want = np.asarray(jfn(jnp.asarray(iou), jnp.asarray(alive),
                              jnp.asarray(dvalid), thresh, eps, iters))
        tsort.reset_host_syncs()
        got = tsort.auction_associate(
            torch.from_numpy(iou), torch.from_numpy(alive),
            torch.from_numpy(dvalid), thresh, eps, iters).numpy()
        np.testing.assert_array_equal(got, want, err_msg=(thresh, iters))
        assert 1 <= tsort.host_syncs <= -(-iters // tsort.AUCTION_BLOCK) + 1


def test_greedy_rounds_are_counted():
    tsort.reset_host_syncs()
    _drive.__wrapped__("sort", False)
    assert tsort.host_syncs >= FRAMES


def test_state_fields_are_the_jax_fields():
    assert tsort.SortState._fields == jsort.SortState._fields
    assert len(tsort.SortState._fields) == 25
    assert tsort._EMB_DIM == jsort._EMB_DIM == EMB_DIM
    assert tsort.APP_EMA == jsort.APP_EMA
    _assert_state(tsort.init_state(T, device="cpu"), jsort.init_state(T))


def test_registry_names_and_flags():
    for name in treg.BACKENDS:
        step = treg.build_device_step({"backend": name})
        jstep = jreg.build_device_step({"backend": name})
        assert getattr(step, "needs_embeddings", False) \
            == getattr(jstep, "needs_embeddings", False), name
        assert type(treg.build_tracker({"backend": name}, device="cpu")) \
            .__name__ == type(jreg.build_tracker({"backend": name})).__name__
    assert set(treg.BACKENDS) == set(jreg.BACKENDS)
    assert treg.build_tracker({"backend": "strongsort"}, device="cpu").nsa
    with pytest.raises(ValueError, match="unknown tracking backend"):
        treg.build_device_step({"backend": "kalman9000"})
    with pytest.raises(ValueError, match="vdc_weight"):
        treg.build_device_step({"backend": "ocsort", "vdc_weight": 2.0})
    with pytest.raises(ValueError, match="unknown association"):
        treg.build_device_step({"association": "nosuch"})


def _dets(cls_type, boxes, conf, n):
    return [cls_type(*map(float, b), float(c), 2, "car", track_id=99)
            for b, c in zip(boxes[:n], conf[:n])]


@pytest.mark.parametrize("name", ["bytetrack", "ocsort", "deepsort",
                                  "botsort"])
def test_host_tracker_matches_jax_tracker(name):
    """The list API of each backend (no descriptors, as in JAX): ids equal
    frame by frame, stale enrichment cleared."""
    cfg = dict(BASE, backend=name, det_capacity=D, track_slots=T)
    jtrk = jreg.build_tracker(cfg)
    jtrk._step = _jstep(name)                  # the module's compiled step
    ttrk = treg.build_tracker(cfg, device="cpu")
    jp = jbuild_projector(_proj_cfg())
    tp = tbuild_projector(_proj_cfg(), device="cpu")
    seen = 0
    for boxes, conf, valid, _, _, t in _sequence(False):
        n = int(valid.sum())
        want = jtrk.update(_dets(JDetection, boxes, conf, n), 1.7e9 + t,
                           projector=jp)
        got = ttrk.update(_dets(Detection, boxes, conf, n), 1.7e9 + t,
                          projector=tp)
        assert [g.track_id for g in got] == [w.track_id for w in want]
        seen += sum(g.track_id is not None for g in got)
    assert seen > 50


def test_state_file_crosses_packages_ocsort_gmc(tmp_path):
    """OC-SORT with GMC on a panned clip, two batches in each package;
    the port's state file loads in the JAX engine (every array exactly as
    saved) and the JAX one in the port's, and every engine continues
    three batches with the ids of the uninterrupted run. After them the
    loaded JAX engine's Kalman state is held to the port's within rtol
    1e-3, atol 1e-3: the two detectors' boxes differ by float noise
    (≤ 1e-4 px here, 0.05 px allowed), which the velocity terms divide
    by 1/30 s; the steps themselves are held at rtol 1e-5, atol 1e-4 on
    identical detections above. A port file of the 18 fields of before
    (no observation or appearance memory) is refused by name."""
    from roadvision_tpu.config import DEFAULTS as JDEFAULTS
    from roadvision_tpu.config import merge as jmerge
    from roadvision_tpu.runtime import PipelineEngine as JEngine
    from roadvision_tpu_torch.config import DEFAULTS, merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    from tests.test_torch_gmc_reid import (_panning_clip, engine_cfg,
                                           same_results)
    over = engine_cfg(backend="ocsort", gmc=True)
    jcfg, tcfg = jmerge(JDEFAULTS, over), merge(DEFAULTS, over)
    jeng, teng = JEngine(jcfg), PipelineEngine(tcfg, device="cpu")
    frames, _ = _panning_clip(20, seed=2)
    batches = [(frames[4 * i: 4 * i + 4], 50.0 + (4 * i + np.arange(4)) / 30)
               for i in range(5)]
    for f, t in batches[:2]:
        same_results(teng.process_batch(f, t), jeng.process_batch(f, t))
    p_port, p_jax = tmp_path / "port.npz", tmp_path / "jax.npz"
    teng.save_state(p_port)
    jeng.save_state(p_jax)
    with np.load(p_port) as z, np.load(p_jax) as zj:
        assert sorted(z.files) == sorted(zj.files)
        assert {f"sort_{k}" for k in jsort.SortState._fields} \
            | {"gmc_prev", "t0"} == set(z.files)
    j2 = JEngine(jcfg)
    j2.load_state(p_port)
    for k in jsort.SortState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j2.sort_state, k)),
                                      getattr(teng.sort_state, k).numpy())
    t2 = PipelineEngine(tcfg, device="cpu")
    t2.load_state(p_jax)
    n, seen = 0, set()
    for f, t in batches[2:]:
        want = jeng.process_batch(f, t)
        for eng in (teng, j2, t2):
            n += same_results(eng.process_batch(f, t), want)
        seen |= {d.track_id for r in want for d in r.detections}
    assert n > 30 and len(seen - {None}) >= 3
    for k in ("mean", "cov", "obs_mean", "obs_cov", "last_obs"):
        np.testing.assert_allclose(getattr(teng.sort_state, k).numpy(),
                                   np.asarray(getattr(j2.sort_state, k)),
                                   rtol=1e-3, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(t2.gmc_prev.numpy(),
                               np.asarray(jeng._gmc_prev), atol=1e-4)
    with np.load(p_port) as z:
        old = {k: z[k] for k in z.files
               if k[5:] not in ("last_obs", "last_obs_ts", "prev_obs",
                                "prev_obs_ts", "obs_mean", "obs_cov", "app")}
    np.savez(tmp_path / "old.npz", **old)
    for eng in (PipelineEngine(tcfg, device="cpu"), JEngine(jcfg)):
        with pytest.raises(ValueError, match="missing tracker arrays.*"
                           "last_obs.*app"):
            eng.load_state(tmp_path / "old.npz")
