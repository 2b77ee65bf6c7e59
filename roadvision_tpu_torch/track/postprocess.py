"""Offline track postprocessing: gap interpolation (a copy of
``roadvision_tpu/track/postprocess.py``).

Beyond-reference tooling (the reference has no offline tracking output
at all; its tracker only annotates the live preview,
src/track/sort_tracker.py + main_preview.py). Linear gap interpolation
is the standard MOT postprocess (ByteTrack et al. apply it before
scoring): when an identity is missing for a few frames between two
observations — occlusion, a dropped detection — fill the gap with
linearly interpolated boxes. Purely host-side list math over the final
per-frame output; never part of the device path.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Row = Tuple[float, float, float, float, int]


def interpolate_gaps(frames: Sequence[Sequence[Row]],
                     max_gap: int = 10) -> List[List[Row]]:
    """frames[f] = [(x1, y1, x2, y2, track_id, *extras), ...] → a copy
    with each identity's gaps of ≤ ``max_gap`` missing frames filled by
    linear interpolation between its surrounding observations.

    The box AND any trailing numeric fields (confidence, ground
    coordinates, ...) are interpolated linearly; the id is preserved.
    Frames where the id was observed are left untouched; gaps longer
    than ``max_gap`` are treated as genuine absence (the id left and
    came back) and not filled.
    """
    out: List[List[Row]] = [list(rows) for rows in frames]
    if max_gap <= 0:
        return out
    # id → [(frame, numeric fields sans id)], in frame order
    obs: Dict[int, List[Tuple[int, Tuple[float, ...]]]] = {}
    for f, rows in enumerate(frames):
        for row in rows:
            vals = tuple(float(v) for v in (*row[:4], *row[5:]))
            obs.setdefault(int(row[4]), []).append((f, vals))
    for tid, seq in obs.items():
        for (f0, v0), (f1, v1) in zip(seq, seq[1:]):
            gap = f1 - f0 - 1
            if gap < 1 or gap > max_gap:
                continue
            for f in range(f0 + 1, f1):
                t = (f - f0) / (f1 - f0)
                vals = tuple(a + t * (b - a) for a, b in zip(v0, v1))
                out[f].append((*vals[:4], tid, *vals[4:]))
    return out
