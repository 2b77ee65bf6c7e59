"""The port's MJPEG preview server over real HTTP on loopback (CPU, tiny
frames): every endpoint, the hub's hand-off policy against the JAX
tool's, and a shutdown that leaves no thread behind."""
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import tools.serve as jserve
from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.tools import serve

W, H = 96, 64


def _tiny_cfg(**over):
    return merge(merge(DEFAULTS, {
        "camera": {"source": "synthetic:3", "width": W, "height": H},
        "preprocess": {"enabled": True, "chain": [
            {"name": "MedianDerain", "params": {"ksize": 3}}]},
        "detect": {"enabled": True, "model": "missing.pt", "imgsz": 64,
                   "max_det": 8, "conf_thres": 0.0, "classes_keep": []},
        "tracking": {"enabled": True},
        "preview": {"compare": {"enable": True, "layout": "h"}},
        "tpu": {"batch_size": 2, "track_slots": 8},
    }), over)


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as resp:
        return resp.headers, resp.read()


def _stop(server, hub, worker):
    hub.close()
    server.shutdown()
    server.server_close()
    worker.join(timeout=60)
    server.thread.join(timeout=60)
    assert not worker.is_alive() and not server.thread.is_alive()


def test_serve_answers_every_endpoint_and_stops_clean():
    before = set(threading.enumerate())
    server, hub, worker = serve.serve_background(
        _tiny_cfg(), port=0, max_frames=40, device="cpu")
    host, port = server.server_address[:2]
    assert host == "127.0.0.1" and port != 0
    base = f"http://{host}:{port}"
    try:
        parts = serve.read_stream_parts(host, port, 1, timeout=60.0)
        assert len(parts) == 1
        img = Image.open(io.BytesIO(parts[0]))
        assert img.format == "JPEG" and img.size == (2 * W + 4, H)

        stats = json.loads(_get(base, "/stats")[1])
        assert {"frames", "fps", "tracks_per_frame", "clients",
                "done"} <= set(stats) and stats["frames"] >= 1
        dets = json.loads(_get(base, "/detections")[1])
        assert {"ts", "frame", "detections"} <= set(dets)
        assert dets["frame"] >= 1 and dets["ts"] is not None
        assert dets["detections"]           # conf 0.0: boxes do flow
        d0 = dets["detections"][0]
        assert set(d0) == {"bbox", "conf", "cls_id", "name", "track_id",
                           "distance_m", "speed_kmh"}
        assert len(d0["bbox"]) == 4
        headers, html = _get(base, "/")
        assert b"/stream" in html and "text/html" in headers["Content-Type"]
        assert json.loads(_get(base, "/events?since=3")[1]) == {"events": []}
        metrics = _get(base, "/metrics")[1].decode()
        assert "roadvision_frames_total" in metrics
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base, "/nope")
        assert ei.value.code == 404

        worker.join(timeout=120)
        assert not worker.is_alive() and hub.error is None
        final = json.loads(_get(base, "/stats")[1])
        assert final["done"] and final["frames"] == 40
        # a late client still gets the last frame, then the stream ends
        assert len(serve.read_stream_parts(host, port, 5)) == 1
    finally:
        _stop(server, hub, worker)
    deadline = time.time() + 15
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def test_closing_the_hub_stops_an_endless_pipeline():
    server, hub, worker = serve.serve_background(
        _tiny_cfg(), port=0, max_frames=None, device="cpu")
    try:
        host, port = server.server_address[:2]
        assert len(serve.read_stream_parts(host, port, 2, timeout=60.0)) == 2
    finally:
        _stop(server, hub, worker)
    assert hub.done and hub.error is None and hub.stats["frames"] >= 2


def test_pipeline_failure_is_kept_and_the_server_still_answers():
    cfg = _tiny_cfg(camera={"source": "synthetic_fog:foggy"})
    server, hub, worker = serve.serve_background(cfg, port=0, max_frames=4,
                                                 device="cpu")
    try:
        worker.join(timeout=60)
        assert isinstance(hub.error, ValueError) and hub.done
        host, port = server.server_address[:2]
        stats = json.loads(_get(f"http://{host}:{port}", "/stats")[1])
        assert stats["done"] and stats["frames"] == 0
        assert serve.read_stream_parts(host, port, 1) == []
    finally:
        _stop(server, hub, worker)


@pytest.mark.parametrize("over", [
    {"analytics": {"enabled": True}},
    {"tpu": {"mesh": {"enable": True}},
     "camera": {"sources": ["synthetic:1", "synthetic:2"]}}])
def test_serve_refuses_what_is_not_ported(over):
    # analytics and the camera fleet are ported: both configs now serve
    server, hub, worker = serve.serve_background(
        _tiny_cfg(**over), port=0, max_frames=2, device="cpu")
    try:
        worker.join(timeout=60)
        assert hub.error is None and hub.stats["frames"] == 2
    finally:
        _stop(server, hub, worker)


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve_background(_tiny_cfg(), port=0, max_frames=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--port", "0", "--max-frames", "2"])


def test_serve_main_runs_to_the_end(tmp_path):
    import yaml
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_tiny_cfg()))
    assert serve.main(["--config", str(path), "--port", "0", "--max-frames",
                       "4", "--device", "cpu", "--quality", "70"]) == 0


def test_frame_hub_policy_equals_the_jax_tool():
    """Newest frame wins, waiters wake, counters and the event log as in
    ``tools/serve.py::FrameHub``."""
    a, b = jserve.FrameHub(), serve.FrameHub()
    for hub in (a, b):
        assert hub.next_frame(0, timeout=0.01) == (None, 0)
        hub.publish(b"one", 29.97, 2, detections=[{"x": 1}], ts=1.5)
        hub.publish(b"two", 30.5, 3, ts=2.5,
                    events=[{"kind": "line"}, {"kind": "zone"}])
    assert b.stats == a.stats == {"frames": 2, "fps": 30.5,
                                  "tracks_per_frame": 2.5}
    assert b.latest == a.latest and list(b.events) == list(a.events)
    assert b.next_frame(0) == a.next_frame(0) == (b"two", 2)
    assert b.next_frame(2, timeout=0.01) == (None, 2)
    got = []
    waiter = threading.Thread(target=lambda: got.append(b.next_frame(2, 30)))
    waiter.start()
    b.publish(b"three", 31.0, 0)
    waiter.join(timeout=10)
    assert got == [(b"three", 3)]
    b.close()
    assert b.done and b.next_frame(3, timeout=5) == (None, 3)
    np.testing.assert_equal(b.error, None)
