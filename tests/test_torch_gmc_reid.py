"""The port's appearance descriptor, camera-motion compensation and
learned re-id embedder vs the JAX package (CPU).

Held on the same seeded numpy inputs: the grid sampler and descriptor
within atol 1e-5; the gray thumbnail within atol 1e-4 (its block means
sum in another order); the phase-correlation surface within 1e-6 up to
a constant of at most 2/G² (the DC bin's float noise, normalised); the
shifts equal, and equal to the known shift of a
textured frame rolled by it; the re-id network's output within atol
1e-5 from parameters drawn by the same numpy calls (or converted from
the JAX tree, HWIO → OIHW), with XLA's SAME padding of a stride-2 conv
(0, 1) and not (1, 1); the weight file's checks and messages as JAX's.
The engine-level comparison: DeepSORT with the learned embedder and GMC
on a clip panned by known shifts, the port's engine against the JAX
engine: ids equal, boxes within 0.05 px, confidences within 2e-3 (as
``tests/test_torch_pipeline.py``), the carried thumbnail within 1e-4.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from roadvision_tpu.config import DEFAULTS as JDEFAULTS
from roadvision_tpu.config import merge as jmerge
from roadvision_tpu.runtime import PipelineEngine as JEngine
from roadvision_tpu.track import appearance as japp
from roadvision_tpu.track import gmc as jgmc
from roadvision_tpu.track import reid as jreid
from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.io_video import SyntheticRoadSource
from roadvision_tpu_torch.runtime import PipelineEngine
from roadvision_tpu_torch.track import appearance as tapp
from roadvision_tpu_torch.track import gmc as tgmc
from roadvision_tpu_torch.track import reid as treid

REID_NPZ = "assets/reid_synthetic.npz"
DET_NPZ = "assets/yolov8n_synthetic_256.npz"


def _frame(seed=0, h=96, w=160):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def _boxes(seed, n, h=96, w=160):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-10, [w - 20, h - 20], (n, 2))
    wh = rng.uniform(3, 60, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    b[0] = (-5, -5, 3, 4)                   # clamped at the frame's corner
    return b


def test_grid_descriptor_matches_jax():
    frames = np.stack([_frame(0), _frame(1)])
    boxes = np.stack([_boxes(2, 9), _boxes(3, 9)])
    valid = np.ones((2, 9), bool)
    valid[1, 4] = False
    for size in (tapp.EMB_GRID, treid.REID_CROP):
        want = np.asarray(japp.sample_box_grid(jnp.asarray(frames[0]),
                                               jnp.asarray(boxes[0]), size))
        got = tapp.sample_box_grid(torch.from_numpy(frames[0]),
                                   torch.from_numpy(boxes[0]), size).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got = tapp.box_embeddings(torch.from_numpy(frames), torch.from_numpy(
        boxes), torch.from_numpy(valid)).numpy()
    for i in range(2):
        want = np.asarray(japp.box_embeddings(
            jnp.asarray(frames[i]), jnp.asarray(boxes[i]),
            jnp.asarray(valid[i])))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)
    assert (got[1, 4] == 0).all() and tapp.EMB_DIM == japp.EMB_DIM == 108


def _textured(h, w, seed=5):
    """A smooth random texture: noise blurred by a box filter."""
    x = np.random.RandomState(seed).rand(h + 8, w + 8, 3) * 255
    k = np.ones(9) / 9
    x = np.apply_along_axis(np.convolve, 0, x, k, "valid")
    x = np.apply_along_axis(np.convolve, 1, x, k, "valid")
    return x.astype(np.uint8)


@pytest.mark.parametrize("h,w,step", [(256, 384, 1), (128, 128, 2),
                                      (512, 640, 1)])
def test_gmc_shifts_equal_the_known_roll_and_jax(h, w, step):
    """A textured frame rolled by known (dx, dy) source px, multiples of
    the thumbnail's block, within the clamp: the shifts equal the roll,
    on the port and in JAX; the thumbnails and the correlation surface
    agree within 1e-4."""
    base = _textured(h, w)
    sy, sx = max(1, h // tgmc.GMC_SIZE), max(1, w // tgmc.GMC_SIZE)
    rolls = [(0, 0), (3, -2), (-7, 5), (8, 0), (0, -7)]
    frames = np.stack([np.roll(base, (dy * sy * step, dx * sx * step),
                               axis=(0, 1)) for dx, dy in rolls])
    tg = tgmc.gray_thumbnail(torch.from_numpy(frames))
    jg = np.stack([np.asarray(jgmc.gray_thumbnail(jnp.asarray(f)))
                   for f in frames])
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-4)
    prev = torch.from_numpy(jg[0])
    got = tgmc.batch_shifts(prev, torch.from_numpy(jg[1:]),
                            torch.tensor(1.0), (sx, sy)).numpy()
    want = np.asarray(jgmc.batch_shifts(jnp.asarray(jg[0]),
                                        jnp.asarray(jg[1:]),
                                        jnp.float32(1.0), (sx, sy)))
    np.testing.assert_array_equal(got, want)
    known = np.diff(np.array(rolls, np.float32) * step, axis=0) \
        * np.array([sx, sy], np.float32)
    lim = tgmc.GMC_SIZE * tgmc.MAX_SHIFT_FRAC
    assert (np.abs(np.diff(np.array(rolls), axis=0) * step) <= lim).all()
    np.testing.assert_array_equal(got, known)
    # the surface against the one gmc.phase_shift takes its argmax of,
    # computed by its jnp expressions (jgmc does not return it)
    p0, p1 = jnp.asarray(jg[0]), jnp.asarray(jg[1])
    cross = jnp.fft.rfft2(p1 - p1.mean()) * jnp.conj(jnp.fft.rfft2(
        p0 - p0.mean()))
    want_r = np.asarray(jnp.fft.irfft2(
        cross / jnp.maximum(jnp.abs(cross), 1e-9), s=p0.shape))
    assert np.unravel_index(want_r.argmax(), want_r.shape) == tuple(
        int(v) % tgmc.GMC_SIZE for v in (rolls[1][1] * step,
                                         rolls[1][0] * step))
    got_r = tgmc.correlation_surface(torch.from_numpy(jg[0]),
                                     torch.from_numpy(jg[1])).numpy()
    # after the mean is removed the DC bin of the cross-power holds only
    # float noise, which the normalisation lifts to magnitude 1 in one
    # library and not in the other: a constant of at most 2/G² between
    # the surfaces; beyond it they agree within 1e-6
    g2 = tgmc.GMC_SIZE ** 2
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=2.0 / g2 + 1e-6)
    np.testing.assert_allclose(got_r - got_r.mean(), want_r - want_r.mean(),
                               rtol=0, atol=1e-6)
    # the first frame of a stream has no past: its shift is 0
    z = tgmc.batch_shifts(prev, torch.from_numpy(jg[1:]), torch.tensor(0.0),
                          (sx, sy)).numpy()
    assert (z[0] == 0).all() and np.array_equal(z[1:], got[1:])


def test_gmc_clamps_a_scene_cut():
    g = torch.from_numpy(_textured(128, 128)[..., 0].astype(np.float32))
    s = tgmc.phase_shift(g, torch.roll(g, (0, 60), (0, 1))).numpy()
    j = np.asarray(jgmc.phase_shift(jnp.asarray(g.numpy()),
                                    jnp.asarray(np.roll(g.numpy(), 60, 1))))
    np.testing.assert_array_equal(s, j)
    assert s[0] == 32.0 and s[1] == 0.0       # |60| > G/4, clamped


def test_reid_params_and_forward_match_jax():
    jp = jreid.init_reid_params(3)
    tp = treid.init_reid_params(3, device="cpu")
    conv = treid.reid_params_from_jax(jp, device="cpu")
    assert set(tp) == set(jp) == set(conv)
    for k in tp:
        np.testing.assert_array_equal(tp[k].numpy(), conv[k].numpy())
    assert tuple(tp["w1"].shape) == (16, 3, 3, 3)        # OIHW
    crops = np.random.RandomState(4).uniform(
        0, 255, (6, treid.REID_CROP, treid.REID_CROP, 3)).astype(np.float32)
    want = np.asarray(jreid.forward_crops(jp, jnp.asarray(crops)))
    got = treid.forward_crops(tp, torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # XLA's SAME pads a stride-2 conv of an even side by (0, 1): the
    # symmetric padding=1 computes something else
    x = torch.from_numpy(crops).permute(0, 3, 1, 2) * (2.0 / 255.0) - 1.0
    same = F.conv2d(F.pad(x, (0, 1, 0, 1)), tp["w1"], tp["b1"], stride=2)
    sym = F.conv2d(x, tp["w1"], tp["b1"], stride=2, padding=1)
    assert same.shape == sym.shape == (6, 16, 16, 16)
    assert (same - sym).abs().max() > 1e-2
    assert treid._same_pad(32) == (0, 1) and treid._same_pad(31) == (1, 1)


def test_reid_embeddings_and_weight_file_match_jax(tmp_path):
    jp = jreid.load_reid_params(REID_NPZ)
    tp = treid.load_reid_params(REID_NPZ, device="cpu")
    frame, boxes = _frame(8), _boxes(9, 7)
    valid = np.array([1, 1, 0, 1, 1, 1, 1], bool)
    want = np.asarray(jreid.reid_embeddings(
        jp, jnp.asarray(frame), jnp.asarray(boxes), jnp.asarray(valid)))
    embed = treid.make_reid_embed(tp)
    got = embed(torch.from_numpy(frame), torch.from_numpy(boxes),
                torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[2] == 0).all()
    # saved by the port, read by JAX (HWIO), and the other way round
    out = tmp_path / "r.npz"
    treid.save_reid_params(out, tp)
    back = jreid.load_reid_params(out)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(jp[k]))
    # the checks and their messages
    with np.load(REID_NPZ) as z:
        arrays = {k: z[k] for k in z.files}
    bad = {"missing": {k: v for k, v in arrays.items() if k != "b2"},
           "shapes": dict(arrays, b1=np.zeros(3, np.float32)),
           "width": dict(arrays, wd=np.zeros((64, 5), np.float32))}
    for name, arr in bad.items():
        path = tmp_path / f"{name}.npz"
        np.savez(path, **arr)
        with pytest.raises(ValueError) as je:
            jreid.load_reid_params(path)
        with pytest.raises(ValueError) as te:
            treid.load_reid_params(path, device="cpu")
        assert str(te.value) == str(je.value)


def _panning_clip(n, h=256, w=256, seed=1):
    """``n`` frames of the synthetic road, each rolled by a cumulative
    known shift (even source px, so whole thumbnail px at 256 → 128)."""
    src = SyntheticRoadSource(w, h, num_vehicles=4, seed=seed)
    rng = np.random.RandomState(seed)
    cam = np.zeros(2, int)
    frames, shifts = [], []
    for k in range(n):
        d = 2 * rng.randint(-4, 5, 2) if k else np.zeros(2, int)
        cam += d
        frames.append(np.roll(src.render(k), (cam[1], cam[0]), axis=(0, 1)))
        shifts.append(d)
    return np.stack(frames), np.array(shifts, np.float32)


def engine_cfg(**tracking):
    return {
        "detect": {"enabled": True, "model": DET_NPZ, "imgsz": 256,
                   "conf_thres": 0.25, "iou_thres": 0.7, "max_det": 20,
                   "classes_keep": [2], "compute_dtype": "float32"},
        "tracking": {"enabled": True, "max_staleness": 1.2,
                     "iou_threshold": 0.35, "speed_window": 0.8,
                     **tracking},
        "tpu": {"batch_size": 4, "compute_dtype": "float32",
                "track_slots": 24}}


def same_results(got, want, what=""):
    n = 0
    for f, (g, w) in enumerate(zip(got, want)):
        assert len(g.detections) == len(w.detections), (what, f)
        for dg, dw in zip(g.detections, w.detections):
            assert (dg.cls_id, dg.track_id) == (dw.cls_id, dw.track_id), \
                (what, f)
            assert max(abs(p - q) for p, q in zip(
                (dg.x1, dg.y1, dg.x2, dg.y2),
                (dw.x1, dw.y1, dw.x2, dw.y2))) < 0.05
            assert abs(dg.conf - dw.conf) < 2e-3
            n += 1
    return n


def test_engine_deepsort_reid_gmc_on_a_pan_matches_jax():
    over = engine_cfg(backend="deepsort", reid_weights=REID_NPZ, gmc=True)
    jeng = JEngine(jmerge(JDEFAULTS, over))
    teng = PipelineEngine(merge(DEFAULTS, over), device="cpu")
    assert teng.gmc_enabled and jeng.gmc_enabled
    assert teng._embed_fn is not tapp.box_embeddings   # the learned one
    frames, shifts = _panning_clip(12)
    n, ids = 0, set()
    for bi in range(3):
        fb = frames[4 * bi: 4 * bi + 4]
        ts = 100.0 + (4 * bi + np.arange(4)) / 30.0
        # the engine's shifts for this batch are the known ones
        if bi:
            assert float(teng.gmc_valid) == 1.0
            got_s = tgmc.batch_shifts(
                teng.gmc_prev, tgmc.gray_thumbnail(torch.from_numpy(fb)),
                torch.tensor(1.0), (2, 2)).numpy()
            np.testing.assert_array_equal(got_s, shifts[4 * bi: 4 * bi + 4])
        want = jeng.process_batch(fb, ts)
        got = teng.process_batch(fb, ts)
        n += same_results(got, want, bi)
        ids |= {d.track_id for r in got for d in r.detections}
        np.testing.assert_allclose(teng.gmc_prev.numpy(),
                                   np.asarray(jeng._gmc_prev), atol=1e-4)
    assert n >= 20 and len(ids - {None}) >= 3
    np.testing.assert_allclose(teng.sort_state.app.numpy(),
                               np.asarray(jeng.sort_state.app), atol=1e-5)


def test_engine_reid_weights_soft_fail(tmp_path, monkeypatch):
    from roadvision_tpu_torch.runtime import engine as tengine
    said = []
    monkeypatch.setattr(tengine.log, "warning",
                        lambda msg, *a: said.append(msg % a))
    bad = tmp_path / "bad.npz"
    np.savez(bad, w1=np.zeros((3, 3, 3, 16), np.float32))
    eng = PipelineEngine(merge(DEFAULTS, engine_cfg(
        backend="botsort", reid_weights=str(bad))), device="cpu")
    assert eng._embed_fn is tapp.box_embeddings
    assert said and "unusable" in said[0] \
        and said[0].endswith("using the grid descriptor")
    sort_eng = PipelineEngine(merge(DEFAULTS, engine_cfg(
        reid_weights=REID_NPZ)), device="cpu")
    assert sort_eng._embed_fn is None and not sort_eng.gmc_enabled
    strong = PipelineEngine(merge(DEFAULTS, engine_cfg(
        backend="strongsort")), device="cpu")
    assert strong.gmc_enabled and strong._embed_fn is tapp.box_embeddings
