"""The port's preprocess layer vs the JAX package, on the CPU.

Inputs are made with seeded numpy and go through the JAX function and
its port. LAB in both directions, the gate's decisions, the gated and
the sampled chains and ``finish_letterbox`` are integer-exact or select
whole frames, so they must be bit-equal; the impulse statistic is a
float32 mean over a frame's subsample, summed in another order by torch
than by XLA, and is held to 1e-4 relative. The engine tests compare
``Detection`` lists with the tolerances of ``tests/test_torch_pipeline.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.config import DEFAULTS as JDEFAULTS
from roadvision_tpu.config import merge as jmerge
from roadvision_tpu.io_video.capture import SyntheticRoadSource as JSource
from roadvision_tpu.ops import clahe as jclahe
from roadvision_tpu.ops import color as jcolor
from roadvision_tpu.ops import letterbox as jlb
from roadvision_tpu.ops import median as jmedian
from roadvision_tpu.preprocess import PreprocessPipeline as JPipeline
from roadvision_tpu.preprocess import pipeline as jpipe
from roadvision_tpu.preprocess.ops import CLAHEDehaze as JCLAHEDehaze
from roadvision_tpu.preprocess.ops import MedianDerain as JMedianDerain
from roadvision_tpu.runtime import PipelineEngine as JEngine
from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.ops import clahe as tclahe
from roadvision_tpu_torch.ops import color as tcolor
from roadvision_tpu_torch.ops import letterbox as tlb
from roadvision_tpu_torch.ops import median as tmedian
from roadvision_tpu_torch.preprocess import PreprocessPipeline
from roadvision_tpu_torch.preprocess import pipeline as tpipe
from roadvision_tpu_torch.preprocess.ops import CLAHEDehaze, MedianDerain
from roadvision_tpu_torch.runtime import PipelineEngine

CLAHE = {"name": "CLAHEDehaze",
         "params": {"space": "YCrCb", "clip_limit": 2.0, "tile_grid": 4}}
CLAHE_LAB = {"name": "CLAHEDehaze",
             "params": {"space": "LAB", "clip_limit": 2.0, "tile_grid": 4}}
MEDIAN = {"name": "MedianDerain", "params": {"ksize": 3}}
BOX_TOL, CONF_TOL = 0.05, 2e-3


def _frames(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# colour: LAB both ways, channel-last gray

LAB_FNS = ["bgr_to_lab_u8_fixed", "lab_to_bgr_u8_fixed"]


@pytest.mark.parametrize("fn", LAB_FNS)
def test_lab_bit_equal_random_frames(fn):
    x = _frames((3, 41, 57, 3), 5)
    want = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
    got = getattr(tcolor, fn)(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", LAB_FNS)
@pytest.mark.parametrize("start", [0, 3])
def test_lab_bit_equal_strided_sweep_of_the_u8_cube(fn, start):
    """Every 7th of the 256^3 triples from ``start`` on (2.4 M of them):
    7 is coprime to 256, so each channel takes every value against
    many values of the other two."""
    v = np.arange(start, 256 ** 3, 7, dtype=np.int64)
    x = np.stack([(v >> s) & 255 for s in (16, 8, 0)], -1).astype(np.uint8)
    want = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
    got = getattr(tcolor, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_lab_tables_equal_the_jax_tables():
    for want, got in zip(jcolor._lab_tables(), tcolor.lab_tables()):
        np.testing.assert_array_equal(got, want)
    for want, got in zip(jcolor._lab_inv_tables(), tcolor.lab_inv_tables()):
        np.testing.assert_array_equal(got, want)


def test_gray_u8_channel_last_bit_equal():
    x = _frames((2, 33, 47, 3), 8)
    want = np.asarray(jcolor.bgr_to_gray_u8(jnp.asarray(x)))
    got = tcolor.bgr_to_gray_u8(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# ops: apply_batch, sampled planes

@pytest.mark.parametrize("shape", [(4, 96, 128, 3), (2, 97, 131, 3)])
@pytest.mark.parametrize("space", ["LAB", "YCrCb"])
def test_clahe_dehaze_apply_batch_bit_equal(shape, space):
    x = _frames(shape, shape[1])
    params = {"space": space, "clip_limit": 2.0, "tile_grid": 4}
    want = np.asarray(JCLAHEDehaze(**params).apply_batch(jnp.asarray(x)))
    op = CLAHEDehaze(**params)
    assert op.supports_planar() == (space != "LAB")
    assert op.supports_planar_sampled() == (space != "LAB")
    np.testing.assert_array_equal(
        op.apply_batch(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("ksize", [3, 4])
def test_median_derain_apply_batch_and_single_frame(ksize):
    x = _frames((2, 37, 53, 3), ksize)
    want = np.asarray(JMedianDerain(ksize=ksize).apply_batch(jnp.asarray(x)))
    op = MedianDerain(ksize=ksize)
    np.testing.assert_array_equal(
        op.apply_batch(torch.from_numpy(x)).numpy(), want)
    # numpy in and out; the card unless the caller names the CPU
    np.testing.assert_array_equal(op(x[0], device="cpu"), want[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            op(x[0])


PLANS = [((3, 1, 32), (3, 1, 42)),       # 96 x 128 at stride 3
         ((5, 2, 19), (1, 0, 128))]      # another stride, one axis whole


@pytest.mark.parametrize("blend", ["cv2", "fixed"])
@pytest.mark.parametrize("shape,grid,plans", [
    ((4, 96, 128), (4, 4), PLANS[0]),
    ((2, 96, 128), (8, 8), PLANS[1]),
    ((2, 97, 131), (8, 8), ((3, 1, 32), (3, 1, 43))),   # ragged: padded LUTs
])
def test_clahe_planar_sampled_bit_equal(blend, shape, grid, plans):
    p = np.random.RandomState(shape[1] + grid[0]).randint(
        0, 256, shape).astype(np.int32)
    py, px = plans
    want = np.asarray(jclahe.clahe_planar_sampled_i32(
        jnp.asarray(p), py, px, 2.0, grid, blend=blend))
    got = tclahe.clahe_planar_sampled(torch.from_numpy(p), py, px, 2.0, grid,
                                      blend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    full = tclahe.clahe_planar(torch.from_numpy(p), 2.0, grid, blend)
    np.testing.assert_array_equal(
        got.numpy(), full.numpy()[:, py[1]::py[0], px[1]::px[0]]
        [:, :py[2], :px[2]])


def test_clahe_apply_refuses_a_sample_grid_that_does_not_fit():
    x = torch.zeros((1, 10, 10), dtype=torch.uint8)
    luts = torch.zeros((1, 2, 2, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sample grid"):
        tclahe.clahe_apply(x, luts, 15, 15, sample=(30, 30, (3, 1, 9),
                                                    (3, 1, 10)))
    with pytest.raises(ValueError, match="leaves"):
        tclahe.clahe_apply(x, luts, 15, 15, sample=(30, 30, (3, 1, 10),
                                                    (3, 4, 10)))


@pytest.mark.parametrize("k", [3, 5])
def test_median_planar_strided_bit_equal(k):
    x = np.random.RandomState(k).randint(0, 256, (3, 50, 67)).astype(np.int32)
    py, px = (3, 1, 16), (3, 1, 22)
    want = np.asarray(jmedian.median_planar_strided_i32(jnp.asarray(x), k,
                                                        py, px))
    got = tmedian.median_planar_strided(torch.from_numpy(x), k, py, px)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rect", [True, False])
def test_finish_letterbox_bit_equal(rect):
    """Against the JAX function under ``jit``, which is how the JAX
    engine runs it (XLA turns its ``/ 255.0`` into a multiply there)."""
    small = _frames((2, 96, 160, 3), 9)
    ji, jr, jp = jax.jit(lambda f: jlb.finish_letterbox(
        f, (288, 480), size=160, rect=rect))(jnp.asarray(small))
    ti, tr, tp = tlb.finish_letterbox(torch.from_numpy(small), (288, 480),
                                      size=160, rect=rect)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert float(tr) == float(jr)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # and it is the letterbox of a frame whose stride-3 grid this is
    big = np.repeat(np.repeat(small, 3, axis=1), 3, axis=2)
    lb = tlb.letterbox_rect_u8 if rect else tlb.letterbox_u8
    np.testing.assert_array_equal(
        lb(torch.from_numpy(big), size=160)[0].numpy(), ti.numpy())
    with pytest.raises(ValueError, match="letterboxes to"):
        tlb.finish_letterbox(torch.from_numpy(small), (300, 480), size=160)


# ---------------------------------------------------------------------------
# the gate

def _gate_batch(h=96, w=128, seed=0):
    """Six frames: two clean (full span), two of low contrast, one clean
    with impulse noise on 3 % of its pixels, one of low contrast with a
    single bright pixel (defeats "span", not "pspan")."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 2 + yy) % 256).astype(np.uint8)
    clean = np.stack([base, np.roll(base, 7, 1), np.roll(base, 13, 0)], -1)
    low = (clean // 16 + 100).astype(np.uint8)
    rain = clean.copy()
    hit = rng.rand(h, w) < 0.03
    rain[hit] = rng.choice([0, 255], size=(int(hit.sum()), 1))
    spiked = low.copy()
    spiked[5, 5] = 255
    return np.stack([clean, low, np.roll(clean, 31, 1), rain,
                     (low + 20).astype(np.uint8), spiked])


GATES = {
    "span": {"stat": "span", "contrast_thresh": 20.0},
    "pspan": {"stat": "pspan", "contrast_thresh": 20.0},
    "impulse": {"stat": "span", "contrast_thresh": 0.0,
                "impulse_thresh": 2.5},
    "span+impulse": {"stat": "span", "contrast_thresh": 20.0,
                     "impulse_thresh": 2.5},
    "pspan+impulse": {"stat": "pspan", "contrast_thresh": 20.0,
                      "impulse_thresh": 2.5},
}
GATE_RUNS = {                    # which of _gate_batch's frames the chain takes
    "span": [0, 1, 0, 0, 1, 0],
    "pspan": [0, 1, 0, 0, 1, 1],
    "impulse": [0, 0, 0, 1, 0, 0],
    "span+impulse": [0, 1, 0, 1, 1, 0],
    "pspan+impulse": [0, 1, 0, 1, 1, 1],
}


def _gated_cfg(gate, chain):
    return {"enabled": True, "chain": chain,
            "auto_gate": dict(GATES[gate], enable_low_contrast_gate=True)}


@pytest.mark.parametrize("chain", [[CLAHE, MEDIAN], [CLAHE_LAB, MEDIAN]],
                         ids=["planar", "lab"])
@pytest.mark.parametrize("gate", sorted(GATES))
def test_gated_apply_batch_bit_equal(gate, chain):
    frames = _gate_batch()
    cfg = _gated_cfg(gate, chain)
    want = np.asarray(JPipeline(cfg).apply_batch(jnp.asarray(frames)))
    tp = PreprocessPipeline(cfg)
    got = tp.apply_batch(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, want)
    # the decisions are the ones the batch was built for, frame by frame
    ungated = PreprocessPipeline({"enabled": True, "chain": chain}) \
        .apply_batch(torch.from_numpy(frames)).numpy()
    for i, run in enumerate(GATE_RUNS[gate]):
        np.testing.assert_array_equal(got[i], ungated[i] if run else frames[i])
        assert not np.array_equal(ungated[i], frames[i])
    assert not tp.supports_sampled()


def test_gate_single_frame_call_matches_jax():
    frames = _gate_batch()
    cfg = _gated_cfg("span+impulse", [CLAHE, MEDIAN])
    jp, tp = JPipeline(cfg), PreprocessPipeline(cfg, device="cpu")
    for i in (0, 1, 3):
        np.testing.assert_array_equal(tp(frames[i], ts=1.0),
                                      jp(frames[i], ts=1.0))
    off = PreprocessPipeline({"enabled": False, "chain": [CLAHE]},
                             device="cpu")
    one = frames[0]
    assert off(one) is one


def _jax_impulse_device(frames):
    """The statistic as ``pipeline.py:212-221`` computes it on the device."""
    x = jnp.asarray(frames).astype(jnp.int16)
    gray = jcolor.gray_from_bgr_planes(x[..., 0], x[..., 1], x[..., 2])
    sub = gray[..., ::4, ::4]
    h, w = sub.shape[-2], sub.shape[-1]
    p = jnp.pad(sub, [(0, 0), (1, 1), (1, 1)], mode="edge")
    neigh = jnp.stack([p[..., dy:dy + h, dx:dx + w]
                       for dy in range(3) for dx in range(3)], axis=-1)
    med = jnp.sort(neigh, axis=-1)[..., 4]
    return np.asarray(jnp.abs(sub - med).astype(jnp.float32)
                      .mean(axis=(-2, -1)))


def test_impulse_statistic_matches_jax_and_the_host_mirror():
    frames = _gate_batch(192, 256, seed=3)
    frames = np.concatenate([frames, _frames((2, 192, 256, 3), 4)])
    tp = PreprocessPipeline(_gated_cfg("span+impulse", [MEDIAN]))
    x = torch.from_numpy(frames)
    gray = tcolor.gray_from_bgr_planes(x[..., 0], x[..., 1], x[..., 2])
    contrast, impulse = tp.gate_stats(gray)
    np.testing.assert_allclose(impulse.numpy(), _jax_impulse_device(frames),
                               rtol=1e-4)
    # the host mirrors are copies: equal to the JAX package's to the bit
    host = tpipe.host_impulse_stats(frames)
    np.testing.assert_array_equal(host, jpipe.host_impulse_stats(frames))
    # on gray frames (b = g = r) the device statistic is the host
    # formula on the frame's own values: held to a float64 mean
    g3 = np.repeat(frames[..., 1:2], 3, axis=-1)
    x3 = torch.from_numpy(g3)
    gray3 = tcolor.gray_from_bgr_planes(x3[..., 0], x3[..., 1], x3[..., 2])
    np.testing.assert_array_equal(gray3.numpy(), g3[..., 0])
    sub = g3[:, ::4, ::4, 0].astype(np.int32)
    pad = np.pad(sub, ((0, 0), (1, 1), (1, 1)), mode="edge")
    h, w = sub.shape[1:]
    med = np.median(np.stack([pad[:, dy:dy + h, dx:dx + w] for dy in range(3)
                              for dx in range(3)], -1), axis=-1)
    np.testing.assert_allclose(tp.gate_stats(gray3)[1].numpy(),
                               np.abs(sub - med).mean(axis=(1, 2)), rtol=1e-4)
    # a single frame is a batch of one (the JAX function fails on it)
    np.testing.assert_array_equal(tpipe.host_impulse_stats(frames[3]),
                                  host[3:4])
    with pytest.raises(ValueError, match="expected"):
        tpipe.host_impulse_stats(frames[..., 0])
    # span is an integer: exact
    want_span = (gray.numpy().astype(np.int32).max(axis=(1, 2))
                 - gray.numpy().astype(np.int32).min(axis=(1, 2)))
    np.testing.assert_array_equal(contrast.numpy(), want_span)


@pytest.mark.parametrize("stat", ["span", "pspan"])
def test_host_contrast_stats_equal_the_jax_mirror(stat):
    frames = _gate_batch(seed=6)
    np.testing.assert_array_equal(tpipe.host_contrast_stats(frames, stat),
                                  jpipe.host_contrast_stats(frames, stat))
    cfg = _gated_cfg(stat, [MEDIAN])
    np.testing.assert_array_equal(PreprocessPipeline(cfg).host_gate_stats(frames),
                                  JPipeline(cfg).host_gate_stats(frames))


@pytest.mark.parametrize("stat", ["span", "pspan"])
def test_auto_threshold_calibrates_to_the_jax_value(stat):
    frames = _gate_batch(seed=2)
    gate = {"enable_low_contrast_gate": True, "stat": stat,
            "contrast_thresh": "auto", "auto_ratio": 0.8, "auto_pct": 25.0}
    cfg = {"enabled": True, "chain": [CLAHE, MEDIAN], "auto_gate": gate}
    jp, tp = JPipeline(cfg), PreprocessPipeline(cfg)
    with pytest.raises(RuntimeError, match="unresolved"):
        tp._gate_thresh()
    with pytest.raises(ValueError, match="frames_u8 or stats"):
        tp.calibrate_gate()
    clean = frames[[0, 2, 3]]
    want = jp.calibrate_gate(clean)
    assert tp.calibrate_gate(clean) == want
    assert tp.calibrate_gate(stats=tp.host_gate_stats(clean)) == want
    assert tp._gate_thresh() == want
    np.testing.assert_array_equal(
        tp.apply_batch(torch.from_numpy(frames)).numpy(),
        np.asarray(jp.apply_batch(jnp.asarray(frames))))


def test_auto_threshold_resolves_from_the_first_batch():
    frames = _gate_batch(seed=2)
    gate = {"enable_low_contrast_gate": True, "contrast_thresh": "auto"}
    cfg = {"enabled": True, "chain": [MEDIAN], "auto_gate": gate}
    jp, tp = JPipeline(cfg), PreprocessPipeline(cfg)
    got = tp.apply_batch(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jp.apply_batch(jnp.asarray(frames))))
    assert tp._auto_thresh == jp._auto_thresh
    first = tp._auto_thresh
    tp.ensure_gate_calibrated(frames[:1])          # resolved: a no-op
    assert tp._auto_thresh == first
    # an ungated pipeline never calibrates
    free = PreprocessPipeline({"enabled": True, "chain": [MEDIAN],
                               "auto_gate": {"contrast_thresh": "auto"}})
    free.apply_batch(torch.from_numpy(frames))
    assert free._auto_thresh is None


@pytest.mark.parametrize("gate,err,match", [
    ({"stat": "entropy"}, ValueError, "auto_gate.stat"),
    ({"contrast_thresh": "high"}, ValueError, "contrast_thresh"),
])
def test_gate_config_is_validated(gate, err, match):
    with pytest.raises(err, match=match):
        PreprocessPipeline({"enabled": True, "chain": [MEDIAN],
                            "auto_gate": gate})
    with pytest.raises(err):
        JPipeline({"enabled": True, "chain": [MEDIAN], "auto_gate": gate})


# ---------------------------------------------------------------------------
# the sampled terminal-op path

@pytest.mark.parametrize("chain", [
    [CLAHE], [MEDIAN], [CLAHE, MEDIAN], [MEDIAN, CLAHE],
    [CLAHE, {"name": "MedianDerain", "params": {"ksize": 5}}],
], ids=["clahe", "median", "clahe-median3", "median-clahe", "clahe-median5"])
@pytest.mark.parametrize("shape", [(4, 96, 128, 3), (2, 97, 131, 3)])
def test_sampled_planes_equal_full_then_slice_and_jax(chain, shape):
    frames = _frames(shape, shape[2])
    h, w = shape[1:3]
    py, px = (3, 1, h // 3), (3, 1, w // 3)
    cfg = {"enabled": True, "chain": chain}
    jp, tp = JPipeline(cfg), PreprocessPipeline(cfg)
    assert tp.supports_sampled() and jp.supports_sampled()
    got = torch.stack(tp.sampled_planes_fn(py, px)(torch.from_numpy(frames)),
                      dim=-1)
    assert got.dtype == torch.uint8
    full = tp.apply_batch(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(
        got.numpy(), full[:, 1::3, 1::3][:, :py[2], :px[2]])
    want = np.stack([np.asarray(p) for p in
                     jp.sampled_planes_fn(py, px)(jnp.asarray(frames))], -1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_supports_sampled_is_false_when_gated_lab_or_identity():
    def sampled(cfg):
        a, b = PreprocessPipeline(cfg), JPipeline(cfg)
        assert a.supports_sampled() == b.supports_sampled()
        return a.supports_sampled()

    assert sampled({"enabled": True, "chain": [CLAHE, MEDIAN]})
    assert not sampled(_gated_cfg("span", [CLAHE, MEDIAN]))
    assert not sampled({"enabled": True, "chain": [CLAHE_LAB, MEDIAN]})
    assert not sampled({"enabled": True, "chain": [CLAHE_LAB]})
    assert not sampled({"enabled": False, "chain": [CLAHE]})
    assert not sampled({"enabled": True, "chain": []})
    with pytest.raises(ValueError, match="no sampled path"):
        PreprocessPipeline(_gated_cfg("span", [MEDIAN])) \
            .sampled_planes_fn((3, 1, 4), (3, 1, 4))


# ---------------------------------------------------------------------------
# the engine: float32, the JAX engine beside it

H, W = 288, 480


def _engine_cfg(pre, tpu):
    return {
        "preprocess": pre,
        "detect": {"enabled": True,
                   "model": "assets/yolov8n_synthetic_256.npz",
                   "imgsz": 160, "conf_thres": 0.25, "iou_thres": 0.7,
                   "max_det": 20, "classes_keep": [2], "device": "cpu",
                   "compute_dtype": "float32"},
        "tracking": {"enabled": True, "max_staleness": 1.2, "min_hits": 3,
                     "iou_threshold": 0.35, "speed_window": 0.8},
        "tpu": dict({"batch_size": 4, "compute_dtype": "float32"}, **tpu),
    }


def _same_detections(want, got):
    n = 0
    for w, g in zip(want, got):
        assert len(g.detections) == len(w.detections)
        for dg, dw in zip(g.detections, w.detections):
            assert (dg.cls_id, dg.cls_name, dg.track_id) == \
                (dw.cls_id, dw.cls_name, dw.track_id)
            assert max(abs(p - q) for p, q in zip(
                (dg.x1, dg.y1, dg.x2, dg.y2),
                (dw.x1, dw.y1, dw.x2, dw.y2))) < BOX_TOL
            assert abs(dg.conf - dw.conf) < CONF_TOL
        n += len(g.detections)
    return n


ENGINE_CHAIN = [dict(CLAHE, params=dict(CLAHE["params"], tile_grid=8)),
                MEDIAN]


def test_engine_sampled_preprocess_matches_jax_engine():
    over = _engine_cfg({"enabled": True, "chain": ENGINE_CHAIN},
                       {"sampled_preprocess": True})
    jeng = JEngine(jmerge(JDEFAULTS, over))
    teng = PipelineEngine(merge(DEFAULTS, over), device="cpu")
    plain = PipelineEngine(merge(DEFAULTS, _engine_cfg(
        {"enabled": True, "chain": ENGINE_CHAIN}, {})), device="cpu")
    assert teng.sampled_plans(H, W, want_proc=False) == \
        ((3, 1, 96), (3, 1, 160))
    assert teng.sampled_plans(H, W, want_proc=True) is None
    assert teng.sampled_plans(H + 2, W, want_proc=False) is None
    assert plain.sampled_plans(H, W, want_proc=False) is None
    src = JSource(W, H, num_vehicles=6)
    n_dets = 0
    for bi in range(3):
        frames = np.stack([src.render(bi * 4 + i) for i in range(4)])
        ts = 1.7e9 + (bi * 4 + np.arange(4)) / 30.0
        want = jeng.process_batch(frames, ts, want_proc=False)
        got = teng.process_batch(frames, ts, want_proc=False)
        n_dets += _same_detections(want, got)
        for g in got:                      # no processed frame came back
            np.testing.assert_array_equal(g.proc, g.raw)
        # and the sampled path finds what the full path finds
        _same_detections(plain.process_batch(frames, ts, want_proc=False),
                         got)
    assert n_dets >= 12


def test_engine_gated_auto_matches_jax_engine():
    """Gate on, "auto" threshold from the first (clean) batch, impulse
    statistic on; the second batch mixes clean, low-contrast and rainy
    frames, so both branches of the select carry detections."""
    pre = {"enabled": True, "chain": ENGINE_CHAIN,
           "auto_gate": {"enable_low_contrast_gate": True,
                         "contrast_thresh": "auto", "stat": "pspan",
                         "impulse_thresh": 2.5}}
    over = _engine_cfg(pre, {})
    jeng = JEngine(jmerge(JDEFAULTS, over))
    teng = PipelineEngine(merge(DEFAULTS, over), device="cpu")
    src = JSource(W, H, num_vehicles=6)
    rng = np.random.RandomState(1)
    n_dets, changed = 0, []
    for bi in range(2):
        frames = np.stack([src.render(bi * 4 + i) for i in range(4)])
        if bi == 1:
            frames[1] = frames[1] // 2 + 60               # low contrast
            hit = rng.rand(H, W) < 0.03
            frames[3][hit] = rng.choice([0, 255], size=(int(hit.sum()), 1))
        ts = 1.7e9 + (bi * 4 + np.arange(4)) / 30.0
        want = jeng.process_batch(frames, ts)
        got = teng.process_batch(frames, ts)
        n_dets += _same_detections(want, got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.proc, w.proc)
            changed.append(not np.array_equal(g.proc, g.raw))
    assert teng.pipeline._auto_thresh == jeng.pipeline._auto_thresh
    assert changed == [False] * 4 + [False, True, False, True]
    assert n_dets >= 8
