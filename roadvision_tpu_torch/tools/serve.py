"""Headless live-preview server: the compare canvas over HTTP MJPEG —
the port of ``tools/serve.py``.

Serves the overlay/compare canvas the preview window would show as a
multipart/x-mixed-replace MJPEG stream — natively renderable by any
browser ``<img>`` tag — plus JSON endpoints with the live counters.
Python-stdlib HTTP (ThreadingHTTPServer) and the same PIL JPEG encode as
the MJPEG recorder. The pipeline runs on its own thread, on the card
unless ``--device cpu`` is given.

Endpoints:
  /            minimal HTML page embedding the stream
  /stream      multipart MJPEG (one part per processed frame)
  /stats       {"frames": N, "fps": ..., "tracks_per_frame": ..., "clients": N}
  /detections  latest frame's detections as JSON (poll alongside /stream):
               {"ts": ..., "frame": N, "detections": [{"bbox": [x1,y1,x2,y2],
               "conf": ..., "cls_id": ..., "name": ..., "track_id": ...,
               "distance_m": ..., "speed_kmh": ...}, ...]}
  /events      the analytics event log (line crossings, zone enter/exit,
               stopped vehicles); ?since=<id> returns only newer ones
  /metrics     Prometheus text exposition of the live counters

Usage:
  python -m roadvision_tpu_torch.tools.serve [--config configs/default.yaml]
      [--port 8000] [--host 0.0.0.0] [--quality 85] [--max-frames N]
      [--device cuda|cpu]

With ``tpu.mesh.enable`` and several ``camera.sources`` the stream is the
camera fleet's tiled grid (``runtime/multi_engine.py``) instead of the
compare canvas; with ``analytics.enabled`` the overlay carries the
lines, zones and stopped vehicles, and the events reach ``/events``.
"""
from __future__ import annotations

import argparse
import json
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..analytics import Analytics
from ..config import load_config
from ..io_video import FPSMeter, VideoSource
from ..io_video.writer import encode_jpeg_bgr
from ..runtime import MultiStreamEngine, PipelineEngine, build_sources
from ..runtime.multi_engine import devices_from_config
from ..utils import get_logger
from ..utils.device import DeviceLike
from ..vis import make_canvas
from ..vis.annotate import annotate, fleet_canvas

# no client socket may block its handler thread for ever
SOCKET_TIMEOUT_S = 10.0

log = get_logger("roadvision.serve")

_INDEX = b"""<!doctype html><title>roadvision preview</title>
<body style="margin:0;background:#111;color:#ddd;font:13px monospace">
<img src="/stream" style="max-width:100%;display:block">
<div id=s style="padding:4px 8px"></div>
<ul id=e style="margin:0;padding:2px 8px 8px 24px;max-height:10em;\
overflow:auto"></ul>
<script>
let last=0;
async function tick(){
 try{
  const st=await (await fetch('/stats')).json();
  document.getElementById('s').textContent=
   `frames ${st.frames}  fps ${st.fps}  tracks/frame `+
   `${st.tracks_per_frame}  clients ${st.clients}`;
  const ev=await (await fetch('/events?since='+last)).json();
  const ul=document.getElementById('e');
  for(const e of ev.events){
   last=e.id;
   const li=document.createElement('li');
   li.textContent=JSON.stringify(e);
   ul.prepend(li);
  }
  while(ul.children.length>50) ul.removeChild(ul.lastChild);
 }catch(err){}
 setTimeout(tick,1000);
}
tick();
</script></body>"""


class FrameHub:
    """Latest-frame handoff between the pipeline thread and HTTP clients.

    Holds one encoded JPEG; every ``publish`` wakes all waiting streams.
    Slow clients skip frames instead of back-pressuring the pipeline
    (same policy as the preview window: show the newest, never queue).
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._jpeg: Optional[bytes] = None
        self._seq = 0
        self.done = False
        self.clients = 0
        self.stats = {"frames": 0, "fps": 0.0, "tracks_per_frame": 0.0}
        self._tracks_total = 0
        self.latest = {"ts": None, "frame": 0, "detections": []}
        self.error: Optional[BaseException] = None   # what ended the loop
        self.events = deque(maxlen=512)   # analytics events, id-stamped
        self._event_id = 0

    def publish(self, jpeg: bytes, fps: float, n_tracks: int,
                detections=None, ts=None, analytics=None,
                events=None) -> None:
        with self._cond:
            self._jpeg = jpeg
            self._seq += 1
            self.stats["frames"] += 1
            self.stats["fps"] = round(fps, 2)
            self._tracks_total += n_tracks
            self.stats["tracks_per_frame"] = round(
                self._tracks_total / self.stats["frames"], 2)
            if analytics is not None:
                self.stats["analytics"] = analytics
            for ev in events or []:
                self._event_id += 1
                self.events.append(dict(ev, id=self._event_id))
            self.latest = {"ts": ts, "frame": self.stats["frames"],
                           "detections": detections or []}
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self.done = True
            self._cond.notify_all()

    def next_frame(self, last_seq: int, timeout: float = 5.0):
        """Block until a frame newer than ``last_seq`` (or shutdown)."""
        with self._cond:
            self._cond.wait_for(
                lambda: self.done or self._seq > last_seq, timeout)
            if self._jpeg is None or self._seq <= last_seq:
                return None, last_seq
            return self._jpeg, self._seq


def _make_handler(hub: FrameHub, boundary: bytes = b"roadvisionframe"):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = SOCKET_TIMEOUT_S   # StreamRequestHandler: per socket

        def log_message(self, fmt, *args):  # route through our logger
            log.debug("http: " + fmt, *args)

        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path == "/":
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(_INDEX)))
                self.end_headers()
                self.wfile.write(_INDEX)
            elif self.path == "/detections":
                body = json.dumps(hub.latest).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.split("?")[0] == "/events":
                # analytics event log (line crossings, zone enter/exit,
                # stopped vehicles); ?since=<id> returns only newer ones
                since = 0
                if "?" in self.path:
                    from urllib.parse import parse_qs
                    q = parse_qs(self.path.split("?", 1)[1])
                    try:
                        since = int(q.get("since", ["0"])[0])
                    except ValueError:
                        since = 0
                evs = [e for e in list(hub.events) if e["id"] > since]
                body = json.dumps({"events": evs}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/metrics":
                # Prometheus text exposition of the live counters
                st = hub.stats
                lines = [
                    "# TYPE roadvision_frames_total counter",
                    f"roadvision_frames_total {st['frames']}",
                    "# TYPE roadvision_fps gauge",
                    f"roadvision_fps {st['fps']}",
                    "# TYPE roadvision_tracks_per_frame gauge",
                    f"roadvision_tracks_per_frame {st['tracks_per_frame']}",
                    "# TYPE roadvision_stream_clients gauge",
                    f"roadvision_stream_clients {hub.clients}",
                    "# TYPE roadvision_analytics_events_total counter",
                    f"roadvision_analytics_events_total {hub._event_id}",
                ]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stats":
                body = json.dumps(dict(hub.stats, clients=hub.clients,
                                       done=hub.done)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"multipart/x-mixed-replace; "
                    f"boundary={boundary.decode()}")
                self.end_headers()
                # no Content-Length: the stream ends with the connection
                self.close_connection = True
                hub.clients += 1
                try:
                    seq = 0
                    while True:
                        jpeg, seq = hub.next_frame(seq)
                        if jpeg is not None:
                            self.wfile.write(
                                b"--" + boundary + b"\r\n"
                                b"Content-Type: image/jpeg\r\n"
                                b"Content-Length: "
                                + str(len(jpeg)).encode() + b"\r\n\r\n"
                                + jpeg + b"\r\n")
                        elif hub.done:
                            break  # drained: late clients still got the
                            # final frame above before EOF
                except (BrokenPipeError, ConnectionResetError, TimeoutError):
                    pass
                finally:
                    hub.clients -= 1
            else:
                self.send_error(404)

    return Handler


def _pipeline_loop(cfg, hub: FrameHub, max_frames, quality: int,
                   device: DeviceLike = None) -> None:
    cam_cfg = cfg.get("camera", {}) or {}
    preview_cfg = cfg.get("preview", {}) or {}
    compare_cfg = preview_cfg.get("compare", {}) or {}
    draw_cfg = (cfg.get("vis", {}) or {}).get("draw", {}) or {}

    vs = analytics = None
    try:
        vs = VideoSource(
            source=cam_cfg.get("source", 0),
            width=cam_cfg.get("width", 1280),
            height=cam_cfg.get("height", 720),
            fps_request=cam_cfg.get("fps_request", 30),
            backend=cam_cfg.get("backend", "auto"),
            num_frames=max_frames,
            device=device,
        )
        engine = PipelineEngine(cfg, device=device)
        fpsm = FPSMeter(alpha=0.1)
        want_compare = bool(compare_cfg.get("enable", True))
        ana_cfg = cfg.get("analytics", {}) or {}
        if ana_cfg.get("enabled"):
            analytics = Analytics(ana_cfg)
        for res in engine.stream(vs, max_frames=max_frames):
            if hub.done:        # closed from outside: stop the pipeline
                break
            proc = np.ascontiguousarray(res.proc)
            if not proc.flags.writeable or np.shares_memory(proc, res.raw):
                proc = proc.copy()   # no-preprocess path: keep RAW clean
            ana_events = annotate(proc, res, draw_cfg,
                                  engine.lb_meta(*proc.shape[:2]), analytics)
            fps = fpsm.tick(res.ts)
            if want_compare:
                canvas = make_canvas(
                    res.raw, proc,
                    layout=compare_cfg.get("layout", "h"),
                    divider_px=int(compare_cfg.get("divider_px", 4)),
                    label_raw=compare_cfg.get("label_raw", "RAW"),
                    label_proc=compare_cfg.get("label_proc", "PROC"),
                    fps=fps,
                    show_fps=bool(preview_cfg.get("show_fps", True)))
            else:
                canvas = proc
            n_tracks = sum(1 for d in res.detections
                           if d.track_id is not None)
            if engine._gate_cfg is not None:
                # temporal-gate observability (detect.temporal_gate)
                hub.stats["frames_coasted"] = engine.gate_frames_coasted
            hub.publish(encode_jpeg_bgr(canvas, quality), fps, n_tracks,
                        detections=[_det_json(d) for d in res.detections],
                        ts=res.ts,
                        analytics=(analytics.summary()
                                   if analytics is not None else None),
                        events=ana_events)
    except Exception as exc:   # the server outlives its pipeline
        hub.error = exc
        log.warning("pipeline loop ended: %s", exc, exc_info=True)
    finally:
        if vs is not None:
            vs.release()
        if analytics is not None:
            analytics.close()
        hub.close()
        log.info("pipeline done after %d frames", hub.stats["frames"])


def _det_json(d, **extra) -> dict:
    """One detection as ``/detections`` reports it."""
    return dict(
        {**extra, "bbox": [d.x1, d.y1, d.x2, d.y2], "conf": d.conf,
         "cls_id": d.cls_id, "name": d.cls_name, "track_id": d.track_id,
         "distance_m": d.distance_m, "speed_kmh": d.speed_kmh},
        **({"rbox": np.asarray(d.rbox).tolist()}
           if d.rbox is not None else {}),
        **({"keypoints": np.asarray(d.keypoints).tolist()}
           if d.keypoints is not None else {}))


def _multi_pipeline_loop(cfg, hub: FrameHub, max_frames, quality: int,
                         device: DeviceLike = None) -> None:
    """Camera-fleet loop: ``tpu.mesh.enable`` + ``camera.sources`` stream
    the tiled per-stream overlay grid instead of the compare canvas."""
    cam_cfg = cfg.get("camera", {}) or {}
    preview_cfg = cfg.get("preview", {}) or {}
    draw_cfg = (cfg.get("vis", {}) or {}).get("draw", {}) or {}

    sources, analytics = [], None
    try:
        sources = build_sources(cam_cfg, max_frames=max_frames)
        engine = MultiStreamEngine(
            cfg, num_streams=len(sources),
            devices=devices_from_config(cfg.get("tpu", {}) or {}, device))
        log.info("multi-stream serve: %d sources over %d device(s)",
                 len(sources), len(engine.devices))
        fpsm = FPSMeter(alpha=0.1)
        labels = [f"CAM{i}" for i in range(len(sources))]
        ana_cfg = cfg.get("analytics", {}) or {}
        if ana_cfg.get("enabled"):
            analytics = [Analytics(ana_cfg) for _ in sources]  # per stream
        for batch in engine.stream(sources, max_frames=max_frames):
            lb_meta = engine.engine.lb_meta(*batch[0][0].proc.shape[:2])
            for i in range(len(batch[0])):
                if hub.done:    # closed from outside: stop the pipeline
                    return
                fps = fpsm.tick(batch[0][i].ts)
                canvas, ana_events = fleet_canvas(
                    batch, i, draw_cfg, lb_meta, labels,
                    fps=fps if preview_cfg.get("show_fps", True) else None,
                    analytics=analytics)
                all_dets = [_det_json(d, stream=s)
                            for s, st in enumerate(batch)
                            for d in st[i].detections]
                n_tracks = sum(1 for d in all_dets
                               if d["track_id"] is not None)
                if engine.fleet_gate:
                    # fleet temporal-gate observability: frames served
                    # from held detections (ALL streams were static)
                    hub.stats["frames_coasted"] = \
                        engine.gate_frames_coasted
                hub.publish(encode_jpeg_bgr(canvas, quality), fps, n_tracks,
                            detections=all_dets, ts=batch[0][i].ts,
                            analytics=([a.summary() for a in analytics]
                                       if analytics is not None else None),
                            events=ana_events)
    except Exception as exc:   # the server outlives its pipeline
        hub.error = exc
        log.warning("multi-stream loop ended: %s", exc, exc_info=True)
    finally:
        for src in sources:
            src.release()
        for a in analytics or []:
            a.close()
        hub.close()
        log.info("multi-stream pipeline done after %d frames",
                 hub.stats["frames"])


def read_stream_parts(host: str, port: int, n: int,
                      timeout: float = SOCKET_TIMEOUT_S) -> list:
    """A client of ``/stream``: the JPEG bytes of the next ``n`` parts
    (fewer if the stream ends first). Every socket read has ``timeout``."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    parts = []
    try:
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        if resp.status != 200 or "multipart/x-mixed-replace" not in \
                resp.getheader("Content-Type", ""):
            raise RuntimeError(f"/stream answered {resp.status} "
                               f"{resp.getheader('Content-Type')}")
        while len(parts) < n:
            line = resp.readline()
            if not line:
                break                     # the stream ended
            if not line.lower().startswith(b"content-length:"):
                continue
            size = int(line.split(b":", 1)[1])
            resp.readline()               # the blank line after the headers
            parts.append(resp.read(size))
    finally:
        conn.close()
    return parts


def _wants_multi(cfg) -> bool:
    mesh_cfg = (cfg.get("tpu", {}) or {}).get("mesh", {}) or {}
    return (bool(mesh_cfg.get("enable", False))
            and len((cfg.get("camera", {}) or {}).get("sources") or []) > 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--quality", type=int, default=85)
    ap.add_argument("--max-frames", type=int, default=None,
                    help="stop the pipeline (and server) after N frames")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    server, hub, worker = serve_background(
        cfg, host=args.host, port=args.port, quality=args.quality,
        max_frames=args.max_frames, device=args.device)
    log.info("serving on http://%s:%d/ (stream at /stream)",
             args.host, server.server_address[1])
    try:
        while worker.is_alive():
            worker.join(timeout=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        hub.close()
        server.shutdown()
        server.server_close()
    if hub.error is not None:
        raise hub.error
    return 0


def serve_background(cfg, host="127.0.0.1", port=0, quality=85,
                     max_frames=None, device: DeviceLike = None):
    """Start server + pipeline on background threads (test/embedding API).

    Returns (server, hub, worker); the server listens on an ephemeral
    port when ``port=0`` (read ``server.server_address``). ``worker`` is
    the pipeline thread; ``server.thread`` is the thread that serves.
    To stop: ``hub.close()``, ``server.shutdown()``,
    ``server.server_close()``, then join both. A failure of the pipeline
    is kept in ``hub.error``."""
    if device is None or str(device) != "cpu":
        from ..utils.device import resolve_device
        resolve_device(device)      # no card: raise here, not in a thread
    hub = FrameHub()
    server = ThreadingHTTPServer((host, port), _make_handler(hub))
    server.daemon_threads = True
    server.thread = threading.Thread(target=server.serve_forever,
                                     daemon=True)
    worker = threading.Thread(
        target=_multi_pipeline_loop if _wants_multi(cfg) else _pipeline_loop,
        args=(cfg, hub, max_frames, quality, device), daemon=True)
    server.thread.start()
    worker.start()
    return server, hub, worker


if __name__ == "__main__":
    raise SystemExit(main())
