"""Traffic analytics: directional line counting and zone occupancy (a
copy of ``roadvision_tpu/analytics.py``).

Beyond-reference addition (the reference stops at per-object distance
and speed, src/geometry/projector.py + src/track/sort_tracker.py; a
road-vision deployment's next question is "how many, which way, how
long"). Consumes the tracked `Detection` lists every engine variant
already materializes per frame — pure host-side control logic over
≤ max_det objects, deliberately NOT device code: the state is a
per-identity dict and the math is a handful of scalar cross products
per frame, far below dispatch cost.

Components (all driven by the additive ``analytics:`` config section):

  * :class:`CountingLine` — directional counts across a line segment.
    An identity is counted when its box-bottom-center crosses the
    segment (sign change of the cross product, with the crossing point
    inside the segment's extent). Direction is the sign of the
    crossing: "pos" = left→right of the p1→p2 direction, "neg" = the
    other way. Per-class tallies + an event log.
  * :class:`Zone` — polygon occupancy (point-in-polygon of the
    box-bottom-center) with per-identity dwell times on exit, plus
    speed statistics (mean / max / 85th percentile — the traffic-
    engineering operating speed) over the ``speed_kmh`` values the
    geometry layer attaches.
  * :class:`StoppedMonitor` — stopped-vehicle / incident detection: an
    identity whose road-contact point stays within a fraction of its
    own box diagonal for ``after_s`` seconds raises a ``stopped``
    event (and ``resumed`` when it moves off), optionally gated to a
    polygon and to classes.
  * :class:`Analytics` — the config-built aggregate the driver and the
    MJPEG server feed (``update(dets, ts)``) and render
    (``overlay(img)``, ``summary()``).

Identity hygiene: state is keyed by ``track_id``; entries idle past
``stale_after`` seconds are dropped, so recycled ids (fixed-slot
tracker, track/sort_tpu.py) cannot inherit a stale side/entry record.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple


def _side(p1, p2, x: float, y: float) -> float:
    """Signed area sign: >0 left of p1→p2, <0 right, 0 on the line."""
    return ((p2[0] - p1[0]) * (y - p1[1])
            - (p2[1] - p1[1]) * (x - p1[0]))


def _seg_t(p1, p2, x: float, y: float) -> float:
    """Projection parameter of (x, y) onto the p1→p2 segment (0..1
    inside)."""
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    den = dx * dx + dy * dy
    if den <= 0.0:
        return 0.5
    return ((x - p1[0]) * dx + (y - p1[1]) * dy) / den


def _anchor(det) -> Tuple[float, float]:
    """Bottom-center of the box — the road-contact point (matches the
    reference's projector convention, src/geometry/projector.py)."""
    return (0.5 * (det.x1 + det.x2), det.y2)


class CountingLine:
    def __init__(self, name: str, p1, p2,
                 classes: Optional[Iterable[int]] = None,
                 stale_after: float = 5.0,
                 wrong_way: Optional[str] = None):
        self.name = str(name)
        self.p1 = (float(p1[0]), float(p1[1]))
        self.p2 = (float(p2[0]), float(p2[1]))
        self.classes = set(int(c) for c in classes) if classes else None
        self.stale_after = float(stale_after)
        if wrong_way not in (None, "pos", "neg"):
            raise ValueError(
                f"line '{name}': wrong_way must be 'pos' or 'neg'")
        self.wrong_way = wrong_way   # crossings this way are violations
        self.wrong_way_total = 0
        self.counts: Dict[str, int] = {"pos": 0, "neg": 0}
        self.by_class: Dict[str, Dict[str, int]] = {}
        self.events: List[Dict[str, Any]] = []
        self._last: Dict[int, Tuple[float, float, float, float]] = {}
        # id → (side, x, y, ts)

    def update(self, detections, timestamp: float) -> List[Dict[str, Any]]:
        ts = float(timestamp)
        new_events: List[Dict[str, Any]] = []
        for d in detections:
            tid = getattr(d, "track_id", None)
            if tid is None:
                continue
            if self.classes is not None and int(d.cls_id) not in self.classes:
                continue
            x, y = _anchor(d)
            side = _side(self.p1, self.p2, x, y)
            prev = self._last.get(int(tid))
            if prev is not None and prev[0] * side < 0.0:
                # sign change — crossing point must fall on the segment
                f = prev[0] / (prev[0] - side)   # interpolation fraction
                cx = prev[1] + f * (x - prev[1])
                cy = prev[2] + f * (y - prev[2])
                if 0.0 <= _seg_t(self.p1, self.p2, cx, cy) <= 1.0:
                    direction = "pos" if side > 0 else "neg"
                    self.counts[direction] += 1
                    cls = str(getattr(d, "cls_name", d.cls_id))
                    per = self.by_class.setdefault(
                        cls, {"pos": 0, "neg": 0})
                    per[direction] += 1
                    ev = {"line": self.name, "track_id": int(tid),
                          "cls": cls, "direction": direction, "ts": ts}
                    if self.wrong_way is not None \
                            and direction == self.wrong_way:
                        ev["wrong_way"] = True
                        self.wrong_way_total += 1
                    self.events.append(ev)
                    new_events.append(ev)
            self._last[int(tid)] = (side, x, y, ts)
        self._last = {k: v for k, v in self._last.items()
                      if ts - v[3] <= self.stale_after}
        return new_events

    def summary(self) -> Dict[str, Any]:
        out = {"name": self.name, "pos": self.counts["pos"],
               "neg": self.counts["neg"],
               "total": self.counts["pos"] + self.counts["neg"],
               "by_class": {k: dict(v) for k, v in self.by_class.items()}}
        if self.wrong_way is not None:
            out["wrong_way_total"] = self.wrong_way_total
        return out


def _point_in_polygon(poly, x: float, y: float) -> bool:
    """Even-odd ray casting (half-open edges — boundary membership is
    consistent, not guaranteed either way on exact edges)."""
    inside = False
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xi = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
            if x < xi:
                inside = not inside
    return inside


class Zone:
    def __init__(self, name: str, polygon,
                 classes: Optional[Iterable[int]] = None,
                 stale_after: float = 5.0,
                 speed_limit_kmh: Optional[float] = None):
        if len(polygon) < 3:
            raise ValueError(f"zone '{name}': polygon needs >= 3 points")
        self.name = str(name)
        self.polygon = [(float(x), float(y)) for (x, y) in polygon]
        self.classes = set(int(c) for c in classes) if classes else None
        self.stale_after = float(stale_after)
        self.speed_limit_kmh = (float(speed_limit_kmh)
                                if speed_limit_kmh is not None else None)
        self.speeding_total = 0
        self.entered_total = 0
        self.dwell_s: List[float] = []     # completed visits
        self.speed_samples: List[float] = []   # km/h while inside
        self._inside: Dict[int, float] = {}    # id → entry ts
        self._seen: Dict[int, float] = {}      # id → last-seen ts
        self._speeding: set = set()        # ids flagged this visit

    @property
    def occupancy(self) -> int:
        return len(self._inside)

    def update(self, detections, timestamp: float) -> List[Dict[str, Any]]:
        ts = float(timestamp)
        events: List[Dict[str, Any]] = []
        present: Dict[int, bool] = {}
        for d in detections:
            tid = getattr(d, "track_id", None)
            if tid is None:
                continue
            if self.classes is not None and int(d.cls_id) not in self.classes:
                continue
            x, y = _anchor(d)
            inside_now = _point_in_polygon(self.polygon, x, y)
            present[int(tid)] = inside_now
            self._seen[int(tid)] = ts
            spd = getattr(d, "speed_kmh", None)
            if inside_now and spd is not None:
                self.speed_samples.append(float(spd))
                # speed enforcement: one event per identity per visit
                if self.speed_limit_kmh is not None \
                        and spd > self.speed_limit_kmh \
                        and int(tid) not in self._speeding:
                    self._speeding.add(int(tid))
                    self.speeding_total += 1
                    events.append({
                        "zone": self.name, "event": "speeding",
                        "track_id": int(tid), "ts": ts,
                        "speed_kmh": float(spd),
                        "limit_kmh": self.speed_limit_kmh})
        for tid, inside in present.items():
            was = tid in self._inside
            if inside and not was:
                self._inside[tid] = ts
                self.entered_total += 1
                events.append({"zone": self.name, "track_id": tid,
                               "event": "enter", "ts": ts})
            elif was and not inside:
                dwell = ts - self._inside.pop(tid)
                self._speeding.discard(tid)
                self.dwell_s.append(dwell)
                events.append({"zone": self.name, "track_id": tid,
                               "event": "exit", "ts": ts,
                               "dwell_s": dwell})
        # identities that vanished (track ended / left the frame) close
        # their visit at last-seen time
        for tid in [t for t, last in self._seen.items()
                    if ts - last > self.stale_after]:
            if tid in self._inside:
                dwell = self._seen[tid] - self._inside.pop(tid)
                self._speeding.discard(tid)
                self.dwell_s.append(dwell)
                events.append({"zone": self.name, "track_id": tid,
                               "event": "exit", "ts": self._seen[tid],
                               "dwell_s": dwell})
            del self._seen[tid]
        return events

    def summary(self) -> Dict[str, Any]:
        mean = (sum(self.dwell_s) / len(self.dwell_s)) \
            if self.dwell_s else None
        out = {"name": self.name, "occupancy": self.occupancy,
               "entered_total": self.entered_total,
               "completed_visits": len(self.dwell_s),
               "mean_dwell_s": mean}
        if self.speed_limit_kmh is not None:
            out["speeding_total"] = self.speeding_total
        if self.speed_samples:
            s = sorted(self.speed_samples)
            # p85: traffic engineering's operating-speed percentile
            # (nearest-rank convention)
            k = max(0, min(len(s) - 1, int(0.85 * len(s) + 0.5) - 1))
            out["speed"] = {"samples": len(s),
                            "mean_kmh": sum(s) / len(s),
                            "max_kmh": s[-1],
                            "p85_kmh": s[k]}
        return out


class StoppedMonitor:
    """Stopped-vehicle (incident) detection over tracked identities.

    An identity is "stopped" once its road-contact anchor has stayed
    within ``move_frac`` of its own box diagonal — and, when the
    geometry layer provides speeds, below ``min_speed_kmh`` — for
    ``after_s`` continuous seconds. One ``stopped`` event fires per
    stillness episode, a ``resumed`` event when it moves off. Pixel
    displacement is the primary signal so the monitor works without a
    calibrated projector; the box-relative threshold makes it depth-
    invariant (a far car moves fewer pixels per m/s).
    """

    def __init__(self, after_s: float = 2.0, move_frac: float = 0.08,
                 min_speed_kmh: float = 3.0,
                 classes: Optional[Iterable[int]] = None,
                 polygon=None, stale_after: float = 5.0):
        self.after_s = float(after_s)
        self.move_frac = float(move_frac)
        self.min_speed_kmh = float(min_speed_kmh)
        self.classes = set(int(c) for c in classes) if classes else None
        self.polygon = ([(float(x), float(y)) for (x, y) in polygon]
                        if polygon else None)
        self.stale_after = float(stale_after)
        self.events: List[Dict[str, Any]] = []
        # id → [still_since_ts, ref_x, ref_y, flagged, last_ts, cls]
        self._state: Dict[int, List[Any]] = {}
        self.stopped_now: Dict[int, Tuple[float, float]] = {}  # id → anchor

    def update(self, detections, timestamp: float) -> List[Dict[str, Any]]:
        ts = float(timestamp)
        new_events: List[Dict[str, Any]] = []
        for d in detections:
            tid = getattr(d, "track_id", None)
            if tid is None:
                continue
            if self.classes is not None and int(d.cls_id) not in self.classes:
                continue
            x, y = _anchor(d)
            if self.polygon is not None and \
                    not _point_in_polygon(self.polygon, x, y):
                continue
            tid = int(tid)
            diag = ((d.x2 - d.x1) ** 2 + (d.y2 - d.y1) ** 2) ** 0.5
            spd = getattr(d, "speed_kmh", None)
            st = self._state.get(tid)
            moved = False
            if st is not None:
                dist = ((x - st[1]) ** 2 + (y - st[2]) ** 2) ** 0.5
                moved = dist > self.move_frac * max(diag, 1e-6)
            if spd is not None and spd > self.min_speed_kmh:
                moved = True
            if st is None or moved:
                if st is not None and st[3]:        # was flagged → resumed
                    ev = {"event": "resumed", "track_id": tid, "ts": ts,
                          "stopped_for_s": ts - st[0]}
                    self.events.append(ev)
                    new_events.append(ev)
                    self.stopped_now.pop(tid, None)
                self._state[tid] = [ts, x, y, False, ts,
                                    str(getattr(d, "cls_name", d.cls_id))]
                continue
            st[4] = ts
            if not st[3] and ts - st[0] >= self.after_s:
                st[3] = True
                ev = {"event": "stopped", "track_id": tid, "ts": ts,
                      "cls": st[5], "since": st[0], "x": x, "y": y}
                self.events.append(ev)
                new_events.append(ev)
            if st[3]:
                self.stopped_now[tid] = (x, y)
        for tid in [t for t, st in self._state.items()
                    if ts - st[4] > self.stale_after]:
            del self._state[tid]
            self.stopped_now.pop(tid, None)
        return new_events

    def summary(self) -> Dict[str, Any]:
        return {"currently_stopped": len(self.stopped_now),
                "stop_events_total": sum(
                    1 for e in self.events if e["event"] == "stopped")}


class Analytics:
    """Config-built aggregate. ``analytics:`` section:

    .. code-block:: yaml

        analytics:
          enabled: true
          stale_after: 5.0
          lines:
            - {name: main, p1: [0, 400], p2: [1920, 400], classes: [2, 7]}
          zones:
            - {name: junction, polygon: [[100, 100], [500, 100],
                                         [500, 500], [100, 500]]}
          stopped:
            enable: true
            after_s: 2.0        # stillness before the alert
            move_frac: 0.08     # of the box diagonal
            min_speed_kmh: 3.0  # when geometry provides speeds
            # polygon: [...]    # optional gating region
            # classes: [2, 5, 7]
    """

    def __init__(self, cfg: Dict[str, Any]):
        stale = float(cfg.get("stale_after", 5.0))
        # optional JSONL event sink (analytics.log_path): every event is
        # appended as one JSON line — the machine-readable audit trail
        self._log_fh = None
        log_path = cfg.get("log_path")
        if log_path:
            from pathlib import Path as _P
            _P(log_path).parent.mkdir(parents=True, exist_ok=True)
            self._log_fh = open(log_path, "a", encoding="utf-8")
        self.lines = [CountingLine(ln.get("name", f"line{i}"),
                                   ln["p1"], ln["p2"],
                                   classes=ln.get("classes"),
                                   stale_after=stale,
                                   wrong_way=ln.get("wrong_way"))
                      for i, ln in enumerate(cfg.get("lines") or [])]
        self.zones = [Zone(z.get("name", f"zone{i}"), z["polygon"],
                           classes=z.get("classes"), stale_after=stale,
                           speed_limit_kmh=z.get("speed_limit_kmh"))
                      for i, z in enumerate(cfg.get("zones") or [])]
        stop_cfg = cfg.get("stopped") or {}
        self.stopped: Optional[StoppedMonitor] = None
        if stop_cfg.get("enable", False):
            self.stopped = StoppedMonitor(
                after_s=float(stop_cfg.get("after_s", 2.0)),
                move_frac=float(stop_cfg.get("move_frac", 0.08)),
                min_speed_kmh=float(stop_cfg.get("min_speed_kmh", 3.0)),
                classes=stop_cfg.get("classes"),
                polygon=stop_cfg.get("polygon"),
                stale_after=stale)

    def update(self, detections, timestamp: float) -> List[Dict[str, Any]]:
        dets = list(detections)
        events: List[Dict[str, Any]] = []
        for ln in self.lines:
            events.extend(ln.update(dets, timestamp))
        for z in self.zones:
            events.extend(z.update(dets, timestamp))
        if self.stopped is not None:
            events.extend(self.stopped.update(dets, timestamp))
        if self._log_fh is not None and events:
            import json as _json
            for ev in events:
                self._log_fh.write(_json.dumps(ev) + "\n")
            self._log_fh.flush()
        return events

    def close(self) -> None:
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None

    def summary(self) -> Dict[str, Any]:
        out = {"lines": [ln.summary() for ln in self.lines],
               "zones": [z.summary() for z in self.zones]}
        if self.stopped is not None:
            out["stopped"] = self.stopped.summary()
        return out

    def overlay(self, image) -> None:
        """Draw lines/zones + live tallies on a BGR uint8 frame."""
        from .vis.draw import draw_line, put_text

        yellow, cyan = (0, 220, 220), (220, 220, 0)
        for ln in self.lines:
            draw_line(image, ln.p1, ln.p2, yellow, thickness=2)
            mx = int(0.5 * (ln.p1[0] + ln.p2[0]))
            my = int(0.5 * (ln.p1[1] + ln.p2[1]))
            put_text(image,
                     f"{ln.name} {ln.counts['pos']}/{ln.counts['neg']}",
                     (mx + 4, max(12, my - 6)), color=yellow,
                     font_scale=0.5)
        for z in self.zones:
            pts = z.polygon
            for i in range(len(pts)):
                draw_line(image, pts[i], pts[(i + 1) % len(pts)], cyan,
                          thickness=2)
            x0, y0 = pts[0]
            put_text(image, f"{z.name} occ {z.occupancy}",
                     (int(x0) + 4, max(12, int(y0) - 6)), color=cyan,
                     font_scale=0.5)
        if self.stopped is not None:
            red = (40, 40, 230)
            for tid, (x, y) in self.stopped.stopped_now.items():
                put_text(image, f"STOPPED #{tid}",
                         (max(0, int(x) - 20), max(12, int(y) - 4)),
                         color=red, font_scale=0.5)
