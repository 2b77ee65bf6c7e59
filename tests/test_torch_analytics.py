"""The port's traffic analytics vs the JAX package (CPU).

``roadvision_tpu_torch/analytics.py`` is a copy of the JAX module: on the
same seeded detection streams (tracks crossing two lines both ways, a
wrong-way direction, entering and leaving two zones, over a zone's speed
limit, stopping and resuming, class filters, ids that go stale and come
back) the event lists, the summaries, the JSONL event log and the
overlay image are held identical. ``tools/analyze.py`` runs on both
packages over ``configs/analytics_demo.yaml`` at 256 × 256, 16 frames, in
float32 with the wall clock pinned (the sources stamp frames from it):
counts and strings equal, float statistics within 1e-3 relative (the two
detectors' boxes differ by float noise; a speed is a small displacement
over a short time). The preview and the HTTP server run analytics on the
demo config: the summary log line, ``/events``, ``/stats`` and
``/metrics``.
"""
import json
import logging
import time
import urllib.request

import numpy as np
import pytest

import tools.analyze as janalyze
from roadvision_tpu import analytics as jana
from roadvision_tpu.detect.types import Detection as JDetection
from roadvision_tpu_torch import analytics as tana
from roadvision_tpu_torch import cli
from roadvision_tpu_torch.config import load_config
from roadvision_tpu_torch.detect.types import Detection
from roadvision_tpu_torch.tools import analyze as tanalyze
from roadvision_tpu_torch.tools import preview, serve

DEMO = "configs/analytics_demo.yaml"
REL = 1e-3
ANA_CFG = {
    "stale_after": 0.5,
    "lines": [{"name": "mid", "p1": [0, 100], "p2": [200, 100],
               "wrong_way": "neg"},
              {"name": "cars", "p1": [100, 0], "p2": [100, 200],
               "classes": [2]}],
    "zones": [{"name": "box", "polygon": [[20, 20], [180, 20], [180, 90],
                                          [20, 90]],
               "speed_limit_kmh": 50.0},
              {"name": "tri", "polygon": [[0, 120], [200, 120], [100, 200]],
               "classes": [2, 7]}],
    "stopped": {"enable": True, "after_s": 0.3, "move_frac": 0.08,
                "min_speed_kmh": 3.0},
}


def _tracks(seed=0, frames=90, n=9):
    """Per frame, (x1, y1, x2, y2, conf, cls, name, id, dist, speed)
    tuples: objects moving up and down across the lines (some fast, some
    slow), two that stop for a second and move on, and ids that vanish
    for longer than ``stale_after`` and come back elsewhere."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(10, 190, (n, 2))
    vel = rng.uniform(-4, 4, (n, 2))
    vel[:, 1] += np.where(rng.rand(n) < 0.5, -3.0, 3.0)
    size = rng.uniform(8, 24, (n, 2))
    cls = rng.choice([0, 2, 7], n)
    out = []
    for f in range(frames):
        dets = []
        for k in range(n):
            if k in (3, 6) and 30 <= f < 50:
                continue                       # gone past stale_after
            p = pos[k] + vel[k] * f
            if k in (1, 4) and 20 <= f < 55:
                p = pos[k] + vel[k] * 20 + rng.normal(0, 0.2, 2)   # stopped
            if k == 6 and f >= 50:
                p = p[::-1]                    # the id comes back elsewhere
            p = np.mod(p, 200.0)
            speed = None if k == 5 else float(
                np.hypot(*vel[k]) * (0.1 if k in (1, 4) and 20 <= f < 55
                                     else 9.0) + rng.normal(0, 1))
            dets.append((float(p[0]), float(p[1]), float(p[0] + size[k, 0]),
                         float(p[1] + size[k, 1]), 0.9, int(cls[k]),
                         f"c{cls[k]}", k + 1, 20.0 + k, speed))
        out.append((1000.0 + f / 30.0, dets))
    return out


def _dets(cls_, rows):
    return [cls_(x1, y1, x2, y2, conf, c, name, track_id=tid,
                 distance_m=dist, speed_kmh=spd)
            for x1, y1, x2, y2, conf, c, name, tid, dist, spd in rows]


def test_analytics_match_jax(tmp_path):
    tlog, jlog = tmp_path / "t" / "ev.jsonl", tmp_path / "j" / "ev.jsonl"
    t = tana.Analytics(dict(ANA_CFG, log_path=str(tlog)))
    j = jana.Analytics(dict(ANA_CFG, log_path=str(jlog)))
    kinds = set()
    for f, (ts, rows) in enumerate(_tracks()):
        et = t.update(_dets(Detection, rows), ts)
        ej = j.update(_dets(JDetection, rows), ts)
        assert et == ej, f"frame {f}"
        kinds |= {e.get("event", e.get("direction")) for e in et}
        kinds |= {"wrong_way" for e in et if e.get("wrong_way")}
        if f % 15 == 7:
            it = np.full((200, 200, 3), 30, np.uint8)
            ij = it.copy()
            t.overlay(it)
            j.overlay(ij)
            assert np.array_equal(it, ij) and (it != 30).any()
        assert t.summary() == j.summary()
    t.close()
    j.close()
    assert tlog.read_bytes() == jlog.read_bytes()
    # the scene reaches every kind of event
    assert {"pos", "neg", "wrong_way", "enter", "exit", "speeding",
            "stopped", "resumed"} <= kinds, kinds


def test_components_validate_as_jax():
    for mod in (tana, jana):
        with pytest.raises(ValueError, match="wrong_way"):
            mod.CountingLine("l", (0, 0), (1, 1), wrong_way="up")
        with pytest.raises(ValueError, match=">= 3 points"):
            mod.Zone("z", [(0, 0), (1, 1)])
    assert tanalyze._parse_points("z:1,2:3,4") == janalyze._parse_points(
        "z:1,2:3,4")
    with pytest.raises(ValueError, match="bad geometry"):
        tanalyze._parse_points("justname")


def _close(a, b, path="report"):
    """Counts and strings equal, floats within REL relative."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert b == pytest.approx(a, rel=REL, abs=1e-9), path
    else:
        assert a == b, path


def test_analyze_tool_matches_jax(tmp_path, monkeypatch):
    # frames are stamped from the wall clock at the source's start
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    cfg = load_config(DEMO)
    cfg["tpu"]["compute_dtype"] = "float32"
    path = tmp_path / "demo32.yaml"
    path.write_text(json.dumps(cfg))
    args = ["--config", str(path), "--source", "synthetic:4", "--width",
            "256", "--height", "256", "--frames", "16",
            "--line", "low:0,200:256,200", "--zone",
            "left:0,0:128,0:128,256:0,256", "--stopped-after", "0.3"]
    assert tanalyze.main(args + ["--out", str(tmp_path / "t.json"),
                                 "--device", "cpu"]) == 0
    assert janalyze.main(args + ["--out", str(tmp_path / "j.json")]) == 0
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    _close(t, j)
    assert t["frames"] == 16 and t["detections_total"] > 0
    assert [ln["name"] for ln in t["analytics"]["lines"]] == ["mid", "low"]
    assert t["events"] and t["analytics"]["zones"][1]["name"] == "left"
    # cli.analyze is the tool
    assert cli.analyze(args + ["--out", str(tmp_path / "c.json"),
                               "--device", "cpu"]) == 0
    assert json.loads((tmp_path / "c.json").read_text()) == t


def test_preview_runs_analytics(tmp_path, caplog):
    avi = tmp_path / "a.avi"
    log = logging.getLogger("roadvision.preview")   # does not propagate
    log.addHandler(caplog.handler)
    try:
        assert preview.main(["--config", DEMO, "--max-frames", "16",
                             "--no-show", "--record", str(avi),
                             "--device", "cpu"]) == 0
    finally:
        log.removeHandler(caplog.handler)
    data = avi.read_bytes()
    assert data[:4] == b"RIFF" and data.count(b"\xff\xd8\xff") == 16
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("analytics: ")]
    summary = json.loads(line[0][len("analytics: "):])
    assert summary["lines"][0]["name"] == "mid"
    assert summary["zones"][0]["entered_total"] > 0
    assert "stopped" in summary


def test_server_reports_analytics():
    cfg = load_config(DEMO)
    server, hub, worker = serve.serve_background(cfg, port=0, max_frames=16,
                                                 device="cpu")
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    try:
        worker.join(timeout=120)
        assert not worker.is_alive() and hub.error is None

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as resp:
                return resp.read().decode()

        events = json.loads(get("/events"))["events"]
        stats = json.loads(get("/stats"))
        metrics = get("/metrics")
        since = json.loads(get(f"/events?since={events[0]['id']}"))["events"]
    finally:
        hub.close()
        server.shutdown()
        server.server_close()
        server.thread.join(timeout=60)
    assert events and [e["id"] for e in events] == list(
        range(1, len(events) + 1))
    assert since == events[1:]
    assert stats["frames"] == 16
    assert stats["analytics"]["zones"][0]["entered_total"] > 0
    assert f"roadvision_analytics_events_total {len(events)}" in metrics
