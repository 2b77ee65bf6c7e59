"""The port's fog synthesizer (``augment/fog.py``), the fogged synthetic
source, the ``fog_batch`` tool and the weather gate vs the JAX package's,
on the CPU.

``rand_perlin`` is the JAX module's numpy code: bit-equal. The filters
are torch ops: ``gaussian_blur`` within 1e-6 of the JAX function,
``box_mean`` within 5e-6 and ``guided_filter`` within 1e-5 (float32
cumulative sums in another order; measured 1.8e-6 for a radius of 16).
The synthesizer draws its parameters from the same ``RandomState`` in
the same order; its uint8 output differs from the
JAX synthesizer's in at most 0.1 % of the pixels (measured ≤ 0.06 % at
96 × 128 over 12 level/seed pairs), by at most 2 levels: a float
difference of ~1e-6 that crosses a .5 boundary of the contrast fade's
luma rounding moves B, G and R by one level, and the last rounding can
add one more. Chained heavy-fog tracking quality is not compared (a
knife-edge quantity); the gate's decisions on ``weather_demo.yaml``'s
frames are.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from roadvision_tpu.augment import fog as JF
from roadvision_tpu.io_video import capture as jcap
from roadvision_tpu.preprocess import PreprocessPipeline as JPipeline
from roadvision_tpu_torch.augment import fog as TF
from roadvision_tpu_torch.io_video import VideoSource
from roadvision_tpu_torch.io_video import capture as tcap
from roadvision_tpu_torch.preprocess import PreprocessPipeline

ROOT = Path(__file__).resolve().parent.parent
SHARE, LEVELS = 1e-3, 2


def _close_u8(a, b):
    """At most SHARE of the values differ, by at most LEVELS."""
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    assert a.shape == b.shape
    assert d.max() <= LEVELS and (d > 0).mean() <= SHARE, \
        (d.max(), (d > 0).mean())


def _road(w=128, h=96, i=3):
    return tcap.SyntheticRoadSource(w, h, num_vehicles=4, seed=0).render(i)


@pytest.mark.parametrize("h,w,scale,octaves,seed", [
    (40, 60, 16, 2, 7), (96, 128, 23, 3, 1), (17, 5, 1, 1, 0)])
def test_rand_perlin_is_bit_equal(h, w, scale, octaves, seed):
    np.testing.assert_array_equal(
        TF.rand_perlin(h, w, scale=scale, octaves=octaves, seed=seed),
        JF.rand_perlin(h, w, scale=scale, octaves=octaves, seed=seed))


def test_filters_match_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(37, 53).astype(np.float32)
    x3 = rng.rand(37, 53, 3).astype(np.float32)
    guide = rng.rand(37, 53).astype(np.float32)
    t = torch.from_numpy
    for r in (1, 3, 16):
        np.testing.assert_allclose(TF.box_mean(t(x), r).numpy(),
                                   np.asarray(JF.box_mean(jnp.asarray(x), r)),
                                   atol=5e-6)
    np.testing.assert_allclose(TF.box_mean(t(x3), 4).numpy(),
                               np.asarray(JF.box_mean(jnp.asarray(x3), 4)),
                               atol=5e-6)
    for r, eps in ((8, 1e-3), (2, 1e-2)):
        np.testing.assert_allclose(
            TF.guided_filter(t(guide), t(x), r, eps).numpy(),
            np.asarray(JF.guided_filter(jnp.asarray(guide), jnp.asarray(x),
                                        r, eps)), atol=1e-5)
    # reflect-101 borders: kernels up to 2 · 25 + 1 wide on a 37-row map
    for k, sigma in ((3, 0.0), (9, 2.0), (51, 12.0)):
        np.testing.assert_allclose(
            TF.gaussian_blur(t(x3), k, sigma).numpy(),
            np.asarray(JF.gaussian_blur(jnp.asarray(x3), k, sigma)),
            atol=1e-6)


@pytest.mark.parametrize("level,seed,kw", [
    ("light", 1, {}), ("medium", 4, TF.CLI_OVERRIDES), ("heavy", 2, {}),
    (None, 2, {"mor": 60.0})])
def test_synthesizer_matches_jax(level, seed, kw):
    """Each level (one with the reference tool's overrides) and the
    MOR-driven β: the same fog parameters, maps within float tolerance,
    uint8 output within the module's bound."""
    img = _road()
    lv = {"level": level} if level else {}
    a, ma = JF.EnhancedFogSynthesizer(seed=seed, **lv, **kw).synthesize(img)
    b, mb = TF.EnhancedFogSynthesizer(seed=seed, device="cpu", **lv,
                                      **kw).synthesize(img)
    _close_u8(b, a)
    np.testing.assert_array_equal(mb["beta_map"], ma["beta_map"])
    assert mb["y_h"] == ma["y_h"]
    for key in ("A_map", "depth", "t"):
        np.testing.assert_allclose(mb[key], ma[key], atol=5e-5)


def test_fogged_source_matches_jax_and_resolves():
    # 128 × 96 as the other cases: JAX's eager ops compile per shape
    tsrc = tcap.FoggedSyntheticRoadSource("heavy", 128, 96, num_vehicles=3,
                                          seed=2, device="cpu")
    jsrc = jcap.FoggedSyntheticRoadSource("heavy", 128, 96, num_vehicles=3,
                                          seed=2)
    _close_u8(tsrc.render(7), jsrc.render(7))
    assert tsrc.gt_boxes(7) == jsrc.gt_boxes(7)
    src = tcap._resolve("synthetic_fog:light:2", 48, 32, 30, num_frames=3,
                        device="cpu")
    assert isinstance(src, tcap.FoggedSyntheticRoadSource)
    assert (src.level, src.n_veh, src.num_frames) == ("light", 2, 3)
    assert tcap._resolve("synthetic_fog:medium", 48, 32, 30,
                         device="cpu").n_veh == 4
    vs = VideoSource("synthetic_fog:medium", 48, 32, num_frames=3,
                     device="cpu")
    frames, ts, m = vs.read_batch(8)
    assert m == 3 and frames.shape == (3, 32, 48, 3) and ts.shape == (3,)
    with pytest.raises(ValueError, match="unknown fog level"):
        tcap.FoggedSyntheticRoadSource("soup", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcap.FoggedSyntheticRoadSource("heavy")


def test_fog_batch_tool_matches_jax(tmp_path):
    """The port's ``fog_batch``: rglob, ``<output>/<level>/<rel>``, one
    fresh synthesizer per level; its heavy PNGs within the bound of the
    JAX tool's."""
    from PIL import Image

    import tools.fog_batch as jtool
    from roadvision_tpu_torch.tools import fog_batch
    src = tmp_path / "in"
    (src / "sub").mkdir(parents=True)
    Image.fromarray(_road()[..., ::-1]).save(src / "sub" / "road.png")
    Image.fromarray(_road(i=9)[..., ::-1]).save(src / "b.PNG")
    Image.fromarray(_road(i=5)[..., ::-1]).save(src / "c.jpeg")
    (src / "notes.txt").write_text("not an image")
    (src / "broken.png").write_bytes(b"not a png")
    out, jout = tmp_path / "out", tmp_path / "jout"
    assert fog_batch.main(["--input", str(src), "--output", str(out),
                           "--levels", "light,heavy", "--seed", "3",
                           "--device", "cpu"]) == 0
    jtool.process_folder(src, jout, levels=("heavy",), seed=3)
    for lv in ("light", "heavy"):
        for rel in ("sub/road.png", "b.PNG", "c.jpeg"):
            assert (out / lv / rel).exists()
        assert not (out / lv / "notes.txt").exists()
    for rel in ("sub/road.png", "b.PNG"):
        _close_u8(np.asarray(Image.open(out / "heavy" / rel)),
                  np.asarray(Image.open(jout / "heavy" / rel)))
    assert fog_batch.process_folder(src, tmp_path / "lim", ("medium",),
                                    limit=1, seed=0, device="cpu") == 1


def test_weather_gate_decisions_match_jax():
    """``weather_demo.yaml``'s gate on its own frames (clean and heavy
    fog, 256 × 256): the port decides as the JAX pipeline does — the
    chain runs on the fogged frames only — and the processed frames are
    bit-equal."""
    cfg = yaml.safe_load((ROOT / "configs" / "weather_demo.yaml").read_text())
    clean = tcap.SyntheticRoadSource(256, 256, num_vehicles=6, seed=0)
    fogged = tcap.FoggedSyntheticRoadSource("heavy", 256, 256,
                                            num_vehicles=6, seed=0,
                                            device="cpu")
    frames = np.stack([clean.render(i) for i in range(2)]
                      + [fogged.render(i) for i in range(2)])
    jout = np.asarray(JPipeline(cfg["preprocess"]).apply_batch(
        jnp.asarray(frames)))
    tout = PreprocessPipeline(cfg["preprocess"], device="cpu") \
        .apply_batch(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(tout, jout)
    ran = [not np.array_equal(o, f) for o, f in zip(tout, frames)]
    assert ran == [False] * 2 + [True] * 2


def test_weather_demo_config_through_preview(tmp_path):
    """The shipped ``configs/weather_demo.yaml`` (``synthetic_fog:heavy:6``)
    through the port's preview CLI on the CPU: 8 frames recorded."""
    from roadvision_tpu_torch.tools import preview
    avi = tmp_path / "weather.avi"
    rc = preview.main(["--config", str(ROOT / "configs" / "weather_demo.yaml"),
                       "--max-frames", "8", "--no-show", "--record", str(avi),
                       "--device", "cpu"])
    assert rc == 0
    data = avi.read_bytes()
    assert data[:4] == b"RIFF" and data.count(b"\xff\xd8\xff") == 8
