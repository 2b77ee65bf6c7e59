"""The port's profilers (``tools/profile_preprocess.py``,
``tools/profile_detect.py``, ``tools/profile_rtdetr.py``), the
``utils/profiler.py`` trace and timer, the preview's ``--profile`` and
``tools/autotune.py``'s harness, on the CPU.

Every ``profile_preprocess`` candidate equals the plain version of its
stage exactly (the histograms the bincount, the blends the "cv2" plain
apply, the packed variants K2's packed four-tap words, the planar
letterbox the stacked one, the int16 median the uint8 one), and the
plain stages equal the JAX package's functions on the same numpy inputs
(bit-equal, the integer-exact stages). The profilers draw their inputs
from the JAX tools' seeded ``RandomState``, so the detect profiler's
letterbox equals JAX's on the same frames. Autotune's winner rule and
recommendation equal the JAX tool's on the same trial tables where the
two pin the same value; one real bench trial runs on the CPU.
"""
import json
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from roadvision_tpu.ops import clahe as JC  # noqa: E402
from roadvision_tpu.ops.color import (bgr_to_ycrcb_u8,  # noqa: E402
                                      ycrcb_to_bgr_u8)
from roadvision_tpu.ops.letterbox import letterbox_u8 as jletterbox  # noqa: E402
from roadvision_tpu.ops.median import median_planar_i32  # noqa: E402
from tools import autotune as jautotune  # noqa: E402
from roadvision_tpu_torch.models import rtdetr  # noqa: E402
from roadvision_tpu_torch.ops import clahe as C  # noqa: E402
from roadvision_tpu_torch.ops.median import median_plain  # noqa: E402
from roadvision_tpu_torch.tools import autotune  # noqa: E402
from roadvision_tpu_torch.tools import profile_detect  # noqa: E402
from roadvision_tpu_torch.tools import profile_preprocess as pp  # noqa: E402
from roadvision_tpu_torch.tools import profile_rtdetr  # noqa: E402
from roadvision_tpu_torch.utils import profiler  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _u8(rng, *shape):
    return torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8))


# ---------------------------------------------------------------------------
# profile_preprocess: candidates against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(pp.HIST))
@pytest.mark.parametrize("n,p", [(3, 300), (2, 517), (4, 64)])
def test_hist_candidates_equal_plain(name, n, p):
    rng = np.random.RandomState(p)
    t = _u8(rng, n, p)
    t[0, :50] = 7                     # a tall bin
    want = pp.hist_plain(t)
    np.testing.assert_array_equal(
        want.numpy(), np.stack([np.bincount(r, minlength=256)
                                for r in t.numpy()]))
    assert torch.equal(pp.HIST[name](t).long(), want)


@pytest.mark.parametrize("h,w", [(64, 96), (72, 120), (40, 56)])
def test_apply_candidates_equal_plain(h, w):
    rng = np.random.RandomState(h)
    x, luts = _u8(rng, 2, h, w), _u8(rng, 2, 8, 8, 256)
    th, tw = h // 8, w // 8
    plain = C.apply_plain(x, luts, th, tw)
    for fn in (pp.apply_gather, pp.apply_band_sweep, C.clahe_apply):
        assert torch.equal(fn(x, luts, th, tw), plain), fn.__name__
    words = pp.packed_words_plain(x, luts, th, tw)
    assert torch.equal(words, C.packed_taps_plain(x, luts, th, tw))
    for fn in (pp.apply_mask_mac, pp.apply_nibble):
        assert torch.equal(fn(x, luts, th, tw), words), fn.__name__


def test_planar_letterbox_equals_stacked():
    rng = np.random.RandomState(0)
    planes = tuple(_u8(rng, 1, 1080, 1920) for _ in range(3))
    got = pp.lb_planar(*planes)
    assert got is not None and torch.equal(got, pp.lb_stack(*planes))
    small = tuple(p[:, :144, :256] for p in planes)
    assert pp.lb_planar(*small) is None        # not an odd-stride downscale
    # the JAX tool's letterbox, jitted as it runs it
    jitted = jax.jit(lambda f: jletterbox(f, size=640)[0])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jitted(jnp.asarray(np.stack(
            [p.numpy() for p in planes], -1)))))


def test_plain_stages_equal_jax():
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, (2, 72, 128, 3), np.uint8)
    plane = rng.randint(0, 256, (2, 72, 128), np.uint8)
    # colour round trip
    from roadvision_tpu_torch.ops.color import (bgr_planes_to_ycrcb_i32,
                                                ycrcb_planes_to_bgr_i32)
    t = torch.from_numpy(frames).permute(3, 0, 1, 2)
    got = torch.stack(ycrcb_planes_to_bgr_i32(*bgr_planes_to_ycrcb_i32(*t)),
                      -1)
    want = ycrcb_to_bgr_u8(bgr_to_ycrcb_u8(jnp.asarray(frames)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the CLAHE (K1 + K2) and its LUTs
    x = torch.from_numpy(plane)
    np.testing.assert_array_equal(C.clahe_planar(x, 2.0, (8, 8)).numpy(),
                                  np.asarray(JC.clahe_u8(jnp.asarray(plane),
                                                         2.0, (8, 8))))
    np.testing.assert_array_equal(
        C.compute_tile_luts(x, 2.0, (8, 8)).numpy(),
        np.asarray(JC.compute_tile_luts(jnp.asarray(plane), 2.0, (8, 8))))
    # the median (K3) and its int16 candidate
    med = median_plain(x, 3)
    np.testing.assert_array_equal(
        med.numpy(), np.asarray(median_planar_i32(
            jnp.asarray(plane.astype(np.int32)), 3)))
    assert torch.equal(pp.med_int16(x), med)


def test_profile_preprocess_run_on_the_cpu(tmp_path, capsys):
    assert pp.main(["--res", "144", "--batch", "1", "--iters", "1",
                    "--warmup", "0", "--device", "cpu", "--out",
                    str(tmp_path / "p.json")]) == 0
    rows = json.loads((tmp_path / "p.json").read_text())
    checked = [r for r in rows.values() if "equal" in r]
    assert len(checked) == 14 and all(r["equal"] for r in checked)
    assert all(r["calls"] == (2 if "equal" in r else 1)
               for r in rows.values())
    assert "skipped" in capsys.readouterr().out   # 144p: no planar slice


def test_a_differing_candidate_fails_the_run(monkeypatch):
    monkeypatch.setitem(pp.HIST, "hist: fori sweep",
                        lambda t: pp.hist_plain(t) + 1)
    with pytest.raises(RuntimeError, match="fori sweep"):
        pp.run(Namespace(res=144, batch=1, iters=1, warmup=0,
                         only="histsweep", device="cpu"))


# ---------------------------------------------------------------------------
# profile_detect and profile_rtdetr
# ---------------------------------------------------------------------------

def test_profile_detect_on_the_cpu():
    rows = profile_detect.run(Namespace(res=360, batch=2, iters=1, warmup=0,
                                        size="n", dtype="bfloat16", only="",
                                        device="cpu"))
    assert list(rows) == ["letterbox 360p->640", "yolov8n forward+decode",
                          "nms (300 cand) + rescale", "full detect step"]
    assert all(r["ms"] > 0 and np.isfinite(r["probe"])
               for r in rows.values())
    # the JAX tool's frames, the JAX tool's letterbox
    frames = np.random.RandomState(0).randint(0, 256, (2, 360, 640, 3),
                                              dtype=np.uint8)
    want = np.asarray(jax.jit(lambda f: jletterbox(f, size=640)[0])(
        jnp.asarray(frames)))
    assert rows["letterbox 360p->640"]["probe"] == float(want.reshape(-1)[0])


def test_gather_bytes_counts_every_corner():
    got = profile_rtdetr.gather_bytes(8, 100, 6, True)
    rows = 6 * 3 * 4 * 8 * 100 * 8 * 4
    assert got["rows"] == rows
    assert got["value_bytes"] == rows * 32 * 2
    assert got["index_bytes"] == rows * 8
    assert got["ms_at_hbm"] == pytest.approx(rows * 72 / 3.35e12 * 1e3)
    assert profile_rtdetr.gather_bytes(8, 100, 6, False)["value_bytes"] \
        == rows * 32 * 4


@pytest.mark.parametrize("bf16", [False, True])
def test_paired_gathers_equal_the_twelve(bf16):
    torch.manual_seed(0)
    ca = rtdetr.DeformAttn()
    shapes = [(8, 8), (4, 4), (2, 2)]
    vals = torch.randn(2, 84, rtdetr.NH, rtdetr.HD // rtdetr.NH)
    q = torch.randn(2, 10, rtdetr.HD)
    refer = torch.sigmoid(torch.randn(2, 10, 4))
    saved = rtdetr._PAIRED_GATHERS
    try:
        outs = []
        for paired in (False, True):
            rtdetr._PAIRED_GATHERS = paired
            with torch.no_grad():
                outs.append(rtdetr.deform_attn(ca, q, refer, vals, shapes,
                                               bf16_vals=bf16))
    finally:
        rtdetr._PAIRED_GATHERS = saved
    assert torch.equal(outs[0], outs[1])


def test_profile_rtdetr_on_the_cpu(tmp_path):
    saved = rtdetr._PAIRED_GATHERS
    out = profile_rtdetr.run(Namespace(
        res=96, batch=1, imgsz=64, dtype="float32", inner=1, iters=1,
        weights="rtdetr-l.pt", device="cpu"))
    assert rtdetr._PAIRED_GATHERS == saved
    assert set(out["stages"]) == {
        "stretch resize", "backbone (HGNetv2-L)",
        "hybrid encoder (AIFI+CCFF)", "decoder (deform layers)",
        "deform attn (1 layer)", "full forward (resize+model)"}
    assert out["stages"]["backbone (HGNetv2-L)"]["gflops_per_frame"] > 0.1
    split = out["decoder_split"]
    assert split["kernel_launches"] is None and split["aten_ops"] > 1000
    assert split["queries"] == 100 and split["layers"] == 6
    assert split["ms_paired_gathers_0"] > 0 and split["ms_paired_gathers_1"] > 0
    assert out["roofline"] == {}          # no card, no device figure
    assert out["card"].startswith("cpu")


# ---------------------------------------------------------------------------
# utils/profiler.py and the preview's --profile
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path / "t")):
        with profiler.annotate("stage-x"):
            torch.ones(64).cumsum(0)
    files = list((tmp_path / "t").glob("trace-*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(
        files[0].read_text())["traceEvents"]}
    assert "stage-x" in names
    assert profiler.time_ms(lambda: torch.ones(8).sum(), CPU, 3, 1) > 0


def test_preview_profile_flag(tmp_path):
    from roadvision_tpu_torch.tools import preview
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump({
        "camera": {"source": "synthetic:2", "width": 96, "height": 64},
        "tpu": {"batch_size": 2}}))
    assert preview.main(["--config", str(cfg), "--max-frames", "4",
                         "--no-show", "--device", "cpu", "--profile",
                         str(tmp_path / "prof")]) == 0
    assert len(list((tmp_path / "prof").glob("trace-*.json"))) == 1


# ---------------------------------------------------------------------------
# autotune's harness
# ---------------------------------------------------------------------------

def _trials(values, fps):
    return {v: {"fps": f, "seconds": 1.0} for v, f in zip(values, fps)}


SHARED = [n for n in autotune.SWEEPS if n in jautotune.SWEEPS
          and autotune.SWEEPS[n]["pinned"] == jautotune.SWEEPS[n]["pinned"]]


@pytest.mark.parametrize("name", SHARED)
@pytest.mark.parametrize("pattern", [(100, 101, 90), (100, 130, 99),
                                     (None, 120, 80), (None, None, None)])
def test_decide_equals_jax(name, pattern):
    values = autotune.SWEEPS[name]["values"]
    trials = _trials(values, pattern[:len(values)])
    got = autotune.decide(name, trials, 2.0)
    want = jautotune.decide(name, trials, 2.0)
    for key in ("winner", "matches_pinned", "pinned", "tie"):
        assert got.get(key) == want.get(key), key


def test_recommend_equals_jax():
    sweeps = {}
    for name in SHARED:
        values = autotune.SWEEPS[name]["values"]
        fps = [100.0 + 10 * i for i in range(len(values))]
        sweeps[name] = autotune.decide(name, _trials(values, fps), 2.0)
    got, want = {"sweeps": sweeps}, {"sweeps": json.loads(
        json.dumps(sweeps))}
    autotune.recommend(got)
    jautotune.recommend(want)
    assert got["recommended"] == want["recommended"]
    assert "detect.decoder_layers" not in json.dumps(got["recommended"])


def test_not_applicable_sweeps_stay_in_the_report(tmp_path, capsys):
    out = tmp_path / "a.json"
    assert autotune.main(["--sweeps", "hist_dtype,clahe_sweep,median_impl",
                          "--out", str(out), "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert set(report["sweeps"]) == {"hist_dtype", "clahe_sweep",
                                     "median_impl"}
    assert all(s["status"] == "not_applicable" and s["reason"]
               for s in report["sweeps"].values())
    assert set(jautotune.SWEEPS) <= set(autotune.SWEEPS) \
        | set(autotune.NOT_APPLICABLE)
    capsys.readouterr()
    # --redecide keeps them and recomputes the rest from the trials
    report["sweeps"]["batch"] = {"trials": _trials(["8", "16"], [100, 150])}
    out.write_text(json.dumps(report))
    assert autotune.main(["--redecide", str(out), "--device", "cpu"]) == 0
    again = json.loads(capsys.readouterr().out.split("\n[autotune]")[0])
    assert again["sweeps"]["batch"]["winner"] == "16"
    assert again["recommended"]["config"]["tpu"]["batch_size"] == 16
    assert again["sweeps"]["hist_dtype"]["status"] == "not_applicable"


def test_rtdetr_gathers_is_not_applicable_on_the_card(tmp_path):
    """On the card K7 computes both gather formulations' function: the
    sweep is reported with its reason and runs no trial; on the CPU it
    stays a sweep."""
    out = tmp_path / "a.json"
    assert autotune.main(["--sweeps", "rtdetr_gathers", "--out", str(out),
                          "--device", "cuda"]) == 0
    entry = json.loads(out.read_text())["sweeps"]["rtdetr_gathers"]
    assert entry["status"] == "not_applicable" and "K7" in entry["reason"]
    assert autotune.not_applicable(["rtdetr_gathers"], "cpu") == {}
    assert "rtdetr_gathers" in autotune.SWEEPS


def test_run_trial_runs_the_port_bench():
    sweep = autotune.SWEEPS["clahe_chunk"]
    got = autotune.run_trial(sweep, "16", 64, 1, 1, 300.0, "cpu")
    assert got["fps"] > 0, got
    assert got["batches"] == 1
    assert set(got["launches_per_batch"]) == {
        "clahe_tile_luts", "clahe_apply", "median_k", "assoc_greedy",
        "assoc_auction", "nms_keep", "deform_sample", "deform_sample_bwd"}
    bad = autotune.run_trial(sweep, "0", 64, 1, 1, 300.0, "cpu")
    assert bad["fps"] is None and "RVT_CLAHE_CHUNK" in bad["error"]
    late = autotune.run_trial(sweep, "16", 64, 1, 1, 0.01, "cpu")
    assert late == {"fps": None, "seconds": late["seconds"],
                    "error": "timeout"}
