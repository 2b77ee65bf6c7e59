"""The port's quality tools (``tools/eval_weather.py``,
``tools/eval_trackers.py``, ``tools/benchmark_trackers.py``,
``tools/dtype_ladder.py``) held to the JAX package's tools by stage, on
identical inputs, on the CPU.

  * scenes, rain and the host gate statistics: equal;
  * ``fog_level``: within the fog synthesizer's recorded bound of JAX,
    at most 2 levels in at most 0.1 % of the pixels (ROADMAP C);
  * ``score``: on JAX-fogged frames and the same detections, the port's
    scores equal JAX's to 1e-6;
  * ``run_mode``: both engines in float32 on the same frames, counts,
    classes and ids equal, boxes within 0.05 px, confidences within 2e-3
    (the pipeline tests' tolerance); the off row's metrics and every
    row's false positives equal (chained heavy-fog MOTA is a knife-edge
    quantity and is not pinned);
  * ``benchmark_trackers``: the host scenarios are the same, and the
    backends' metrics on them equal;
  * ``dtype_ladder``: the float32 row within the pipeline tolerance (mAP
    and recall 1e-3, matched confidence 2e-3); the int8 rows within 0.05
    in mAP and recall and 0.02 in matched confidence (the two packages'
    static scales differ by up to 2 %, ROADMAP C);
  * the JSON reports keep the schema of the JAX tools' checked-in
    artifacts (WEATHER.json, TRACKERS.json, DTYPES.json).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools import benchmark_trackers as jbt  # noqa: E402
from tools import dtype_ladder as jdl  # noqa: E402
from tools import eval_trackers as jet  # noqa: E402
from tools import eval_weather as jew  # noqa: E402
from roadvision_tpu_torch.tools import benchmark_trackers as bt  # noqa: E402
from roadvision_tpu_torch.tools import dtype_ladder as dl  # noqa: E402
from roadvision_tpu_torch.tools import eval_trackers as et  # noqa: E402
from roadvision_tpu_torch.tools import eval_weather as ew  # noqa: E402

torch.set_num_threads(1)
N, RES, VEH = 16, 128, 6
BOX_TOL, CONF_TOL = 0.05, 2e-3
SHARE, LEVELS = 1e-3, 2
WEIGHTS = str(ROOT / "assets" / "yolov8n_synthetic_256.npz")


def _f32(cfg):
    cfg["tpu"]["compute_dtype"] = "float32"
    cfg["detect"]["compute_dtype"] = "float32"
    return cfg


@pytest.fixture(scope="module")
def scene():
    return jew.build_scene(N, RES, VEH, 0)


@pytest.fixture(scope="module")
def jax_fog(scene):
    return jew.fog_level(scene[0], "heavy", 0)


@pytest.fixture(scope="module")
def runs(scene, jax_fog):
    """(port, JAX) detections of the same frames through both engines in
    float32: chain off on the clean scene, on and auto on the fog."""
    frames, _ = scene
    out = {}
    for mode, imgs in (("off", frames), ("on", jax_fog),
                       ("auto", jax_fog)):
        args = (WEIGHTS, RES, mode, 0.25, 150.0, 8, "span", 2.5)
        out[mode] = (ew.run_mode(_f32(ew.make_cfg(*args)), imgs, "cpu"),
                     jew.run_mode(_f32(jew.make_cfg(*args)), imgs))
    return out


def _same_dets(got, want):
    n = 0
    assert len(got) == len(want)
    for fi, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), fi
        for dg, dw in zip(g, w):
            assert (dg.cls_id, dg.track_id) == (dw.cls_id, dw.track_id)
            assert max(abs(p - q) for p, q in zip(
                (dg.x1, dg.y1, dg.x2, dg.y2),
                (dw.x1, dw.y1, dw.x2, dw.y2))) < BOX_TOL
            assert abs(dg.conf - dw.conf) < CONF_TOL
            n += 1
    return n


# ---------------------------------------------------------------------------
# eval_weather by stage
# ---------------------------------------------------------------------------

def test_scene_rain_and_statistics_equal(scene):
    frames, gt = scene
    pf, pgt = ew.build_scene(N, RES, VEH, 0)
    np.testing.assert_array_equal(pf, frames)
    assert pgt == gt
    rain = ew.add_rain(frames, 0.02, 3)
    np.testing.assert_array_equal(rain, jew.add_rain(frames, 0.02, 3))
    for stat in ("span", "pspan"):
        np.testing.assert_array_equal(ew.gray_spans(rain, stat),
                                      jew.gray_spans(rain, stat))
    np.testing.assert_array_equal(ew.impulse_stats(rain),
                                  jew.impulse_stats(rain))


@pytest.mark.parametrize("level", ["light", "heavy"])
def test_fog_level_within_the_bound(scene, jax_fog, level):
    frames = scene[0][:4]
    got = ew.fog_level(frames, level, 0, "cpu")
    want = jax_fog[:4] if level == "heavy" else jew.fog_level(frames, level,
                                                               0)
    d = np.abs(got.astype(np.int16) - want)
    assert d.max() <= LEVELS and (d > 0).mean() <= SHARE, \
        (d.max(), (d > 0).mean())
    assert ew.fog_level(frames, "none", 0, "cpu") is frames


@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_make_cfg_equals_jax(mode):
    args = (WEIGHTS, RES, mode, 0.3, 140.0, 4, "pspan", 2.5)
    got, want = ew.make_cfg(*args), jew.make_cfg(*args)
    for sec in ("preprocess", "tracking", "geometry"):
        assert got[sec] == want[sec], sec
    for key in ("model", "imgsz", "conf_thres", "iou_thres", "max_det",
                "classes_keep", "backend"):
        assert got["detect"][key] == want["detect"][key]
    assert got["tpu"]["batch_size"] == want["tpu"]["batch_size"]
    with pytest.raises(ValueError):
        ew.make_cfg(WEIGHTS, RES, "sometimes", 0.25, 150.0, 8)


def test_score_on_the_same_detections_equals_jax(scene, runs):
    _, gt = scene
    for mode, (_, jdets) in runs.items():
        got, want = ew.score(jdets, gt), jew.score(jdets, gt)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (mode, k)


@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_run_mode_equals_jax(scene, runs, mode):
    got, want = runs[mode]
    assert _same_dets(got, want) >= N
    s_got, s_want = ew.score(got, scene[1]), jew.score(want, scene[1])
    assert s_got["false_positives"] == s_want["false_positives"]
    if mode == "off":
        assert s_got == s_want


def test_eval_weather_report_keeps_the_schema(tmp_path):
    out = tmp_path / "w.json"
    assert ew.main(["--frames", "8", "--res", "96", "--vehicles", "4",
                    "--levels", "none,heavy+rain", "--modes", "off,auto",
                    "--batch", "4", "--gate-thresh", "auto", "--out",
                    str(out), "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    ref = json.loads((ROOT / "WEATHER.json").read_text())
    assert got["meta"].keys() == ref["meta"].keys()
    row = next(iter(ref["levels"].values()))
    for entry in got["levels"].values():
        assert entry.keys() == row.keys()
        for scores in entry["modes"].values():
            assert scores.keys() == row["modes"]["off"].keys()
    assert isinstance(got["meta"]["gate_thresh"], float)


# ---------------------------------------------------------------------------
# eval_trackers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["sort", "bytetrack", "deepsort"])
@pytest.mark.parametrize("pre_on", [False, True])
def test_eval_trackers_cfg_equals_jax(backend, pre_on):
    got = et.make_cfg(WEIGHTS, RES, backend, 0.25, 8, pre_on)
    want = jet.make_cfg(WEIGHTS, RES, backend, 0.25, 8, pre_on)
    assert got["tracking"] == want["tracking"]
    assert got["preprocess"]["enabled"] == want["preprocess"]["enabled"]
    assert got["preprocess"].get("chain") == want["preprocess"].get("chain")


def test_eval_trackers_ocsort_equals_jax(scene):
    frames, gt = scene
    got = et.make_cfg(WEIGHTS, RES, "ocsort", 0.25, 8, False)
    want = jet.make_cfg(WEIGHTS, RES, "ocsort", 0.25, 8, False)
    d_got = ew.run_mode(_f32(got), frames, "cpu")
    d_want = jew.run_mode(_f32(want), frames)
    assert _same_dets(d_got, d_want) >= N
    assert ew.score(d_got, gt) == jew.score(d_want, gt)


def test_eval_trackers_report_keeps_the_schema(tmp_path):
    out = tmp_path / "t.json"
    assert et.main(["--frames", "8", "--res", "96", "--vehicles", "4",
                    "--backends", "sort,botsort", "--batch", "4", "--out",
                    str(out), "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    ref = json.loads((ROOT / "TRACKERS.json").read_text())
    assert got["meta"].keys() == ref["meta"].keys()
    assert got["scenes"].keys() == ref["scenes"].keys()
    assert got["scenes"]["clean"]["sort"].keys() \
        == ref["scenes"]["clean"]["sort"].keys()


# ---------------------------------------------------------------------------
# benchmark_trackers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(jbt.SCENARIOS))
def test_scenarios_equal_jax(name):
    got = bt.SCENARIOS[name](np.random.default_rng(0))
    want = jbt.SCENARIOS[name](np.random.default_rng(0))
    assert got == want


@pytest.mark.parametrize("backend,scenario", [
    ("sort", "clutter"), ("bytetrack", "conf_dip"), ("ocsort", "occlusion"),
    ("strongsort", "dense")])
def test_benchmark_tracker_metrics_equal_jax(backend, scenario):
    seq = jbt.SCENARIOS[scenario](np.random.default_rng(0))
    got = bt.run_backend(backend, seq, "cpu")
    want = jbt.run_backend(backend, seq)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k


def test_benchmark_trackers_main(tmp_path, capsys):
    out = tmp_path / "b.json"
    assert bt.main(["--backends", "sort,ocsort", "--scenarios",
                    "linear,crossing", "--out", str(out), "--device",
                    "cpu"]) == 0
    table = capsys.readouterr().out
    assert "| sort | 1.000 | 1.000 | 1.000 |" in table
    got = json.loads(out.read_text())
    assert set(got) == {"sort", "ocsort"}
    assert set(got["sort"]) == {"linear", "crossing"}
    with pytest.raises(SystemExit):
        bt.main(["--scenarios", "nope", "--device", "cpu"])


# ---------------------------------------------------------------------------
# dtype_ladder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ladders():
    argv = ["--frames", "16", "--res", str(RES), "--batch", "8",
            "--calib-frames", "8", "--dtypes", "float32,int8,int8-static"]
    import contextlib
    import io
    rows = []
    for fn, extra in ((dl.main, ["--device", "cpu"]),
                      (jdl.main, ["--device", "auto"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(argv + extra) == 0
        rows.append(json.loads(buf.getvalue()))
    return rows


def test_dtype_ladder_float32_row_equals_jax(ladders):
    got, want = (r["dtypes"]["float32"] for r in ladders)
    assert abs(got["map50"] - want["map50"]) <= 1e-3
    assert abs(got["recall50"] - want["recall50"]) <= 1e-3
    assert abs(got["conf_matched_mean"] - want["conf_matched_mean"]) \
        <= CONF_TOL
    assert got["false_positives"] == want["false_positives"]


@pytest.mark.parametrize("dtype", ["int8", "int8-static"])
def test_dtype_ladder_int8_rows_near_jax(ladders, dtype):
    got, want = (r["dtypes"][dtype] for r in ladders)
    assert abs(got["map50"] - want["map50"]) <= 0.05
    assert abs(got["recall50"] - want["recall50"]) <= 0.05
    assert abs(got["conf_matched_mean"] - want["conf_matched_mean"]) <= 0.02


def test_dtype_ladder_report_keeps_the_schema(ladders):
    got = ladders[0]
    ref = json.loads((ROOT / "DTYPES.json").read_text())
    assert got["meta"].keys() == ref["meta"].keys()
    assert got["dtypes"]["float32"].keys() == ref["dtypes"]["float32"].keys()


def test_resident_fps_on_the_cpu():
    from roadvision_tpu_torch.config import DEFAULTS, merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    eng = PipelineEngine(merge(DEFAULTS, {
        "detect": {"enabled": True, "model": WEIGHTS, "imgsz": 96},
        "tracking": {"enabled": True}, "tpu": {"batch_size": 2}}),
        device="cpu")
    fps, flops = dl.resident_fps(eng, 96, 4, 1)
    assert fps > 0 and flops > 1e8
