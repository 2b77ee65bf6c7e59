"""The port's temporal gate, its bench mode and MOT scoring vs the JAX
package (CPU).

Held on the same inputs: the motion score and the carried thumbnail
within atol 1e-4 (the thumbnail's block means sum in another order),
and every gate decision equal; the coast step's outputs (ids equal,
distance and speed within rtol 1e-3); the host policy through
``PipelineEngine.stream`` and ``dispatch_batch`` / ``collect_batch``
(score read at collect, one batch of lag, skips counted at dispatch):
``gate_frames_coasted`` equal, > 0 on a static scene and 0 on a moving
one, ids equal on every frame, coasted or not; the gated scan step (the
bench's gate: one host read a batch here, ``lax.cond`` in JAX): the same
coast flags and outputs. Detections come from
``assets/yolov8n_synthetic_256.npz`` at imgsz 64 with a confidence
threshold of 1e-6 on 48 × 64 noise frames, as ``tests/test_temporal_gate.py``
drives the JAX gate, in float32: boxes within 0.05 px, confidences
within 2e-3. MOT scoring (``track/eval.py``, ``tools/track.py --gt``)
equals the JAX functions exactly.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.runtime import engine as jengine
from roadvision_tpu.runtime.engine import PipelineEngine as JEngine
from roadvision_tpu.track import eval as jeval
from roadvision_tpu_torch.io_video import SyntheticRoadSource
from roadvision_tpu_torch.runtime import engine as tengine
from roadvision_tpu_torch.runtime.engine import PipelineEngine
from roadvision_tpu_torch.track import eval as teval
from roadvision_tpu_torch.tools import bench
from roadvision_tpu_torch.tools import track as ttrack

NPZ = "assets/yolov8n_synthetic_256.npz"
SHAPE = (2, 48, 64)


def _cfg(extra_detect=None, extra_tracking=None):
    det = {"enabled": True, "model": NPZ, "imgsz": 64, "conf_thres": 1e-6,
           "max_det": 8, "compute_dtype": "float32",
           "temporal_gate": {"enable": True, "max_skip_batches": 3}}
    det.update(extra_detect or {})
    trk = {"enabled": True, "backend": "sort"}
    trk.update(extra_tracking or {})
    return {"detect": det, "tracking": trk, "preprocess": {"enabled": False},
            "tpu": {"batch_size": 2, "compute_dtype": "float32"}}


def _batches(n, move=False, seed=0, b=2, h=48, w=64, t0=0.0):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (h, w, 3), np.uint8)
    out, t = [], t0
    for i in range(n):
        frames = [np.roll(base, (i * b + j) * 5, axis=1) if move else base
                  for j in range(b)]
        out.append((np.stack(frames), t + np.arange(b) / 30.0))
        t += b / 30.0
    return out


def _same(got, want, what=""):
    for g, w in zip(got, want):
        assert len(g.detections) == len(w.detections), what
        for dg, dw in zip(g.detections, w.detections):
            assert (dg.cls_id, dg.track_id) == (dw.cls_id, dw.track_id), what
            assert max(abs(p - q) for p, q in zip(
                (dg.x1, dg.y1, dg.x2, dg.y2),
                (dw.x1, dw.y1, dw.x2, dw.y2))) < 0.05
            assert abs(dg.conf - dw.conf) < 2e-3


@pytest.fixture(scope="module")
def engines():
    """One JAX and one port engine with the gate on (JAX compiles its
    full and coast steps once for the module)."""
    return JEngine(_cfg()), PipelineEngine(_cfg(), device="cpu")


def test_motion_score_matches_jax():
    rng = np.random.RandomState(3)
    base = rng.randint(0, 255, (4, 96, 160, 3), np.uint8)
    still = np.repeat(base[:1], 4, axis=0)
    dot = still.copy()
    dot[2, 40:48, 60:70] = 255                    # a small moving object
    prev = rng.uniform(0, 255, (128, 128)).astype(np.float32)
    jscore = jax.jit(jengine._motion_score)
    for frames in (base, still, dot, base[:1]):
        for pv in (0.0, 1.0):
            want_s, want_t = jscore(jnp.asarray(frames), jnp.asarray(prev),
                                    jnp.float32(pv))
            got_s, got_t = tengine._motion_score(
                torch.from_numpy(frames), torch.from_numpy(prev), pv)
            np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                       atol=1e-4)
            ws, gs = float(want_s), float(got_s)
            assert np.isinf(ws) == np.isinf(gs)
            if np.isfinite(ws):
                assert abs(ws - gs) <= 1e-4, (ws, gs)
            for thresh in (0.5, 1.5, 5.0):
                assert (gs < thresh) == (ws < thresh)
    s, _ = tengine._motion_score(torch.from_numpy(still),
                                 torch.zeros((128, 128)), 0.0)
    assert float(s) == 0.0 and tengine.GATE_BLOCK == jengine.GATE_BLOCK


def test_coast_step_matches_jax(engines):
    jeng, teng = engines
    (frames, ts), = _batches(1, t0=0.5)
    state = jeng.sort_state
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 40, (8, 2)).astype(np.float32)
    dets = (np.concatenate([xy, xy + 12], 1), rng.uniform(0.3, 0.9, 8)
            .astype(np.float32), np.full(8, 2, np.int32),
            np.arange(8) < 6)
    prev = rng.uniform(0, 255, (128, 128)).astype(np.float32)
    jstep = jax.jit(jeng.build_coast_step(SHAPE, want_proc=False))
    _, jouts, jstate, (jscore, _) = jstep(
        jeng.detector.params, state, jnp.asarray(frames),
        jnp.asarray(ts.astype(np.float32)), *map(jnp.asarray, dets),
        jnp.asarray(prev), jnp.float32(1.0))
    teng.reset()
    step = teng.build_coast_step(SHAPE, want_proc=False)
    proc, touts, (tscore, _) = step(
        torch.from_numpy(frames), torch.from_numpy(ts.astype(np.float32)),
        *map(torch.from_numpy, dets), torch.from_numpy(prev), 1.0)
    assert proc is None
    for k in range(4):                                 # the held set
        np.testing.assert_array_equal(touts[k].numpy(), np.asarray(jouts[k]))
    np.testing.assert_array_equal(touts[4].numpy(), np.asarray(jouts[4]))
    assert (touts[4].numpy()[:, :6] > 0).all()
    for k in (5, 6):
        np.testing.assert_allclose(touts[k].numpy(), np.asarray(jouts[k]),
                                   rtol=1e-3, atol=1e-3, equal_nan=True)
    assert abs(float(tscore) - float(jscore)) <= 1e-4
    teng.reset()


def test_host_policy_matches_jax_static_then_moving(engines):
    """Through ``stream`` (two batches in flight: the score of batch i
    gates batch i + 2) and through ``process_batch`` (it gates i + 1):
    the same coasted frames and ids as the JAX engine."""
    jeng, teng = engines

    class Clip:
        def __init__(self, batches):
            self.batches = list(batches)

        def read_batch(self, n):
            if not self.batches:
                return None, None, 0
            f, t = self.batches.pop(0)
            return f, t, len(f)

    for move, mode in ((False, "stream"), (False, "process"),
                       (True, "stream")):
        jeng.reset()
        teng.reset()
        clip = _batches(8, move=move, t0=10.0)
        if mode == "stream":
            want = list(jeng.stream(Clip(clip)))
            got = list(teng.stream(Clip(clip)))
        else:
            want = [r for f, t in clip for r in jeng.process_batch(f, t)]
            got = [r for f, t in clip for r in teng.process_batch(f, t)]
        assert len(got) == len(want) == 16
        _same(got, want, (move, mode))
        assert teng.gate_frames_coasted == jeng.gate_frames_coasted
        assert (teng.gate_frames_coasted > 0) != move, (move, mode)
        assert any(d.track_id for r in got for d in r.detections)
    # the skip budget holds in the pipelined interleaving
    teng.reset()
    flags, inflight = [], None
    for f, t in _batches(10, t0=20.0):
        nxt = teng.dispatch_batch(f, t, want_proc=False)
        flags.append(nxt[5][2])
        if inflight is not None:
            teng.collect_batch(inflight)
        inflight = nxt
    teng.collect_batch(inflight)
    run = 0
    for c in flags:
        run = run + 1 if c else 0
        assert run <= 3
    assert any(flags)
    teng.reset()
    assert (teng.gate_frames_coasted, teng._gate_score, teng._gate_dets,
            teng._gate_thumb, teng._gate_skips) == (0, None, None, None, 0)


def test_gated_scan_step_matches_jax(engines):
    jeng, teng = engines
    jeng.reset()
    teng.reset()
    jstep, jinit = jeng.build_gated_scan_step(SHAPE)
    jstep = jax.jit(jstep)
    tstep, tinit = teng.build_gated_scan_step(SHAPE)
    jc, tc = jinit(), tinit()
    flags = []
    for f, t in _batches(6, t0=30.0) + _batches(3, move=True, t0=31.0):
        t32 = t.astype(np.float32)
        jouts, jcoast, jc = jstep(jeng.detector.params, jc, jnp.asarray(f),
                                  jnp.asarray(t32))
        touts, tcoast, tc = tstep(tc, torch.from_numpy(f),
                                  torch.from_numpy(t32))
        assert tcoast == bool(jcoast)
        flags.append(tcoast)
        for k in (2, 3, 4):
            np.testing.assert_array_equal(touts[k].numpy(),
                                          np.asarray(jouts[k]))
        np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]),
                                   atol=0.05)
        np.testing.assert_allclose(touts[1].numpy(), np.asarray(jouts[1]),
                                   atol=2e-3)
    assert flags == [False, True, True, True, False, True,
                     False, False, False]


def test_gate_rejects_unsupported_combinations():
    with pytest.raises(ValueError, match="mutually exclusive"):
        PipelineEngine(_cfg(extra_tracking={"gmc": True}), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        PipelineEngine(_cfg(extra_tracking={"backend": "strongsort"}),
                       device="cpu")
    with pytest.raises(ValueError, match="detect task"):
        PipelineEngine(_cfg(extra_detect={"model": "missing-pose.pt"}),
                       device="cpu")
    with pytest.raises(ValueError, match="detect task"):
        PipelineEngine(_cfg(extra_detect={"tiling": {"enable": True,
                                                     "tile": 64}}),
                       device="cpu")
    off = PipelineEngine(_cfg(extra_detect={"temporal_gate": {}}),
                         device="cpu")
    with pytest.raises(ValueError, match="not enabled"):
        off.build_gated_scan_step(SHAPE)


def test_bench_gate_mode_rehearsal(capsys):
    """``tools/bench.py --mode gate`` at a toy size on the CPU: the static
    scene coasts, the moving one does not, and the staleness probe saw
    coasted detections. Its numbers are CPU numbers, named so."""
    assert bench.main(["--device", "cpu", "--mode", "gate", "--res", "144",
                       "--batch", "2", "--iters", "2", "--windows", "1",
                       "--warmup", "1", "--dtype", "float32"]) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["mode"] == "gate" and line["device"]["platform"] == "cpu"
    assert line["metric"] == "gate_static_144p_fps"
    assert line["static"]["coasted_share"] > 0
    assert line["moving"]["coasted_share"] == 0
    # every coasted batch, warm-up and staleness probe included
    assert line["coasted_batches"] >= line["static"]["frames_coasted"] // 2
    for scene in ("static", "moving"):
        for key in ("gated_fps", "ungated_fps"):
            assert line[scene][key]["median"] > 0
    assert line["staleness"]["n_dets"] > 0
    assert 0 < line["staleness"]["iou_mean"] <= 1.0


def _mot_rows(frames):
    return [[(x1, y1, x2, y2, int(i)) for x1, y1, x2, y2, i in rows]
            for rows in frames]


def test_eval_metrics_equal_jax():
    rng = np.random.RandomState(0)
    gt, pred = [], []
    for f in range(20):
        g = [(x, y, x + 30, y + 20, k) for k, (x, y) in
             enumerate(rng.uniform(0, 200, (5, 2)))]
        gt.append(g)
        pred.append([(x1 + rng.normal(0, 3), y1, x2, y2 + rng.normal(0, 3),
                      k + (f > 12 and k == 2) * 10)
                     for x1, y1, x2, y2, k in g if rng.uniform() > 0.15]
                    + [(500, 500, 520, 530, 99)] * (f % 4 == 0))
    for iou in (0.3, 0.5):
        assert teval.evaluate_all(gt, pred, iou) == \
            jeval.evaluate_all(gt, pred, iou)


def test_track_gt_scoring_matches_jax(tmp_path, capsys):
    """``tools.track --gt``: the synthetic clip's ground truth as a MOT
    file, the port's run scored in-process; the JAX reader and metrics on
    the same two files give the same numbers."""
    import tools.track as jtrack
    n = 12
    src = SyntheticRoadSource(256, 256, num_vehicles=4)
    gt = tmp_path / "gt.txt"
    gt.write_text("".join(
        f"{f + 1},{v + 1},{x1:.2f},{y1:.2f},{x2 - x1:.2f},{y2 - y1:.2f},1,"
        f"-1,-1,-1\n" for f in range(n)
        for x1, y1, x2, y2, v in src.gt_boxes(f)))
    out = tmp_path / "t.txt"
    assert ttrack.main(["--source", "synthetic:4", "--frames", str(n),
                        "--out", str(out), "--config",
                        "configs/synthetic_demo.yaml", "--width", "256",
                        "--height", "256", "--gt", str(gt), "--eval-iou",
                        "0.4", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ttrack.read_mot(gt, n) == jtrack.read_mot(gt, n)
    want = jeval.evaluate_all(jtrack.read_mot(gt, n),
                              jtrack.read_mot(out, n), iou_thres=0.4)
    assert got == {k: round(v, 4) if isinstance(v, float) else v
                   for k, v in want.items()}
    assert got["matches"] > 0 and {"mota", "idf1", "hota"} <= set(got)
    assert _mot_rows(ttrack.read_mot(out, n)) == ttrack.read_mot(out, n)
