"""Homography calibration helper for the geometry section — the port of
``tools/calibrate.py``, over the port's ``geometry/projector.py``.

    python -m roadvision_tpu_torch.tools.calibrate --points points.yaml
        [--check extra.yaml] [--max-error 0.5] [--origin X,Y]
        [--allow-warnings]

The reference README walks users through manual calibration: pick >= 4
road-plane pixel points, measure their ground coordinates in meters, and
paste both lists into ``geometry.projector`` (README.md:128-139). This
helper validates the pairs on the normalized-DLT estimator:

  * fits H from the pairs and reports each point's reprojection error
    (pixels -> ground, against the measured world points) plus the
    diagnostics that predict an unusable fit (collinear points, points
    spanning a tiny area);
  * optionally checks held-out pairs (--check) against the fit;
  * prints a ready-to-paste ``geometry:`` YAML block.

Input YAML (or a whole pipeline config: ``geometry.projector`` is read
first):

  image_points: [[x, y], ...]       # pixels
  world_points: [[X, Y], ...]       # meters, same order
  origin: [X, Y]                    # optional, defaults [0, 0]
  max_distance: 1000.0              # optional

The fit and the report are host numpy; the emitted block is then built
into a ``HomographyProjector`` on ``--device`` (the card unless "cpu"
is asked for), as the deployment will build it. Exit code 0 when
every error is within --max-error and the layout is sound, 1 otherwise,
2 for fewer than 4 matched pairs.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import yaml

from ..geometry.projector import HomographyProjector, find_homography_dlt
from ..utils.device import resolve_device


def _load_pairs(path: str):
    with open(path, "r", encoding="utf-8") as fh:
        doc = yaml.safe_load(fh) or {}
    node = doc
    if "geometry" in doc:
        node = (doc["geometry"] or {}).get("projector", {}) or {}
    img = np.asarray(node.get("image_points", []), np.float64)
    wld = np.asarray(node.get("world_points", []), np.float64)
    return img, wld, node


def reprojection_report(img: np.ndarray, wld: np.ndarray):
    """Fit H on the pairs; per-point ground-plane error in meters."""
    H = find_homography_dlt(img.astype(np.float32), wld.astype(np.float32))
    ones = np.ones((len(img), 1))
    mapped = (H @ np.hstack([img, ones]).T).T
    w = mapped[:, 2:3]
    ok = np.abs(w[:, 0]) > 1e-9
    ground = np.where(ok[:, None], mapped[:, :2] / np.where(ok[:, None], w, 1.0),
                      np.nan)
    err = np.linalg.norm(ground - wld, axis=1)
    return H, ground, err


def diagnostics(img: np.ndarray) -> list:
    """Degeneracy warnings the DLT itself won't raise."""
    warns = []
    # collinearity: rank of centered points
    c = img - img.mean(axis=0)
    s = np.linalg.svd(c, compute_uv=False)
    if s[-1] < 1e-6 * max(s[0], 1.0):
        warns.append("image points are (near-)collinear — the ground "
                     "plane is unconstrained")
    # tiny span: points covering few pixels amplify measurement noise
    span = img.max(axis=0) - img.min(axis=0)
    if min(span) < 20:
        warns.append(f"image points span only {span[0]:.0f}x{span[1]:.0f} "
                     f"px — spread them toward the frame corners")
    return warns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", required=True,
                    help="YAML with image_points/world_points (or a full "
                         "pipeline config)")
    ap.add_argument("--check", default=None,
                    help="YAML with held-out pairs to validate against")
    ap.add_argument("--max-error", type=float, default=0.5,
                    help="fail (rc 1) if any reprojection error exceeds "
                         "this many meters")
    ap.add_argument("--origin", default=None,
                    help="override origin as 'X,Y' meters")
    ap.add_argument("--allow-warnings", action="store_true",
                    help="emit the config even when the geometry "
                         "diagnostics flag a degenerate point layout")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the emitted projector is built (the card "
                         "by default; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    img, wld, node = _load_pairs(args.points)
    if img.ndim != 2 or len(img) < 4 or img.shape != wld.shape:
        print("calibrate: need >= 4 matched (image, world) pairs",
              file=sys.stderr)
        return 2

    H, ground, err = reprojection_report(img, wld)
    warns = diagnostics(img)
    finite = np.isfinite(err)
    if not finite.any():
        for w in warns:
            print(f"WARNING: {w}")
        print("calibrate: no valid projected points — every pair maps to "
              "w≈0 (degenerate homography); re-pick the points",
              file=sys.stderr)
        return 1
    for i, (p, g, e) in enumerate(zip(img, ground, err)):
        tail = (f"ground({g[0]:8.2f},{g[1]:8.2f}) m   err {e:6.3f} m"
                if np.isfinite(e) else "ground at infinity (w≈0) — INVALID")
        print(f"point {i}: px({p[0]:8.1f},{p[1]:8.1f}) -> {tail}")
    print(f"reprojection error: mean {err[finite].mean():.3f} m, "
          f"max {err[finite].max():.3f} m over {finite.sum()} finite "
          f"of {len(err)} points")
    for w in warns:
        print(f"WARNING: {w}")

    if args.check:
        ci, cw, _ = _load_pairs(args.check)
        ones = np.ones((len(ci), 1))
        mapped = (H @ np.hstack([ci, ones]).T).T
        cw_ok = np.abs(mapped[:, 2]) > 1e-9
        cg = np.where(cw_ok[:, None],
                      mapped[:, :2] / np.where(cw_ok[:, None],
                                               mapped[:, 2:3], 1.0), np.nan)
        cerr = np.linalg.norm(cg - cw, axis=1)
        cfin = np.isfinite(cerr)
        if cfin.any():
            print(f"held-out error: mean {cerr[cfin].mean():.3f} m, "
                  f"max {cerr[cfin].max():.3f} m over {cfin.sum()} finite "
                  f"of {len(cerr)} points")
        else:
            print("held-out pairs all project to w≈0 — INVALID",
                  file=sys.stderr)
        err = np.concatenate([err, cerr])

    origin = node.get("origin", [0.0, 0.0])
    if args.origin:
        origin = [float(t) for t in args.origin.split(",")]
    block = {
        "geometry": {
            "enabled": True,
            "projector": {
                "type": "homography",
                "image_points": [[float(a), float(b)] for a, b in img],
                "world_points": [[float(a), float(b)] for a, b in wld],
                "origin": [float(origin[0]), float(origin[1])],
                "max_distance": float(node.get("max_distance", 1000.0)),
            },
        },
    }
    # constructs cleanly end-to-end (raises on degenerate input)
    HomographyProjector(block["geometry"]["projector"], device=device)
    print("\n# paste into your config:")
    print(yaml.safe_dump(block, sort_keys=False, default_flow_style=None),
          end="")

    # a degenerate layout can still interpolate its OWN points exactly
    # (4 points = exact homography fit), so NaNs and diagnostics gate
    # the exit code alongside the numeric threshold
    efin = np.isfinite(err)
    if not efin.all() or err[efin].max() > args.max_error:
        worst = err[efin].max() if efin.any() else float("inf")
        print(f"calibrate: max finite error {worst:.3f} m exceeds "
              f"--max-error {args.max_error} (or some points project "
              "to w≈0)", file=sys.stderr)
        return 1
    if warns and not args.allow_warnings:
        print("calibrate: degenerate point layout (see WARNINGs); "
              "re-pick points or pass --allow-warnings", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
