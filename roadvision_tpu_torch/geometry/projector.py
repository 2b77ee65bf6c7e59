"""Ground-plane projection — the port of
``roadvision_tpu/geometry/projector.py:29-170``.

``find_homography_dlt`` is a numpy copy (normalised DLT, host, at
construction). The batched apply runs as elementwise float32 torch ops:
bbox → bottom-centre point, |w| < 1e-6 or non-finite → invalid, distance
= ‖ground − origin‖ clamped (not rejected) to ``max_distance``.
``GroundProjector`` is the host base every projector shares, with the
reference's scalar ``distance`` / ``distance_for_bbox``.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def find_homography_dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares homography via Hartley-normalised DLT; (3, 3) float64
    with H[2, 2] == 1. Exact for 4 points."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[0]

    def normalize(pts):
        mean = pts.mean(axis=0)
        centered = pts - mean
        scale_d = np.mean(np.linalg.norm(centered, axis=1))
        s = np.sqrt(2.0) / scale_d if scale_d > 1e-12 else 1.0
        T = np.array([[s, 0, -s * mean[0]],
                      [0, s, -s * mean[1]],
                      [0, 0, 1]], np.float64)
        return centered * s, T

    sn, Ts = normalize(src)
    dn, Td = normalize(dst)
    A = np.zeros((2 * n, 9), np.float64)
    for i in range(n):
        x, y = sn[i]
        u, v = dn[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(A)
    H = np.linalg.inv(Td) @ vt[-1].reshape(3, 3) @ Ts
    if abs(H[2, 2]) < 1e-12:
        raise ValueError("degenerate homography (H[2,2] ~ 0)")
    return H / H[2, 2]


Point2D = Tuple[float, float]


class GroundProjector(ABC):
    """Image → ground-plane mapping on the host (the JAX package's
    ``GroundProjector``, ``projector.py:66-97``)."""

    def __init__(self, origin: Optional[Sequence[float]] = None,
                 max_distance: Optional[float] = None):
        if origin is None:
            origin = (0.0, 0.0)
        if len(origin) != 2:
            raise ValueError("origin must be a length-2 sequence")
        self.origin = np.asarray(origin, np.float32)
        self.max_distance = float(max_distance) \
            if max_distance is not None else None

    @abstractmethod
    def project_point(self, x: float, y: float) -> Optional[Point2D]:
        ...

    def project_bbox(self, bbox: Sequence[float]) -> Optional[Point2D]:
        """The box's bottom-centre point on the ground plane."""
        x1, _, x2, y2 = bbox
        return self.project_point(0.5 * (float(x1) + float(x2)), float(y2))

    def distance(self, point: Optional[Sequence[float]]) -> Optional[float]:
        """‖point − origin‖ in float32, clamped to ``max_distance``;
        None for a None point or a non-finite distance."""
        if point is None:
            return None
        dist = float(np.linalg.norm(np.asarray(point, np.float32)
                                    - self.origin))
        if not np.isfinite(dist):
            return None
        if self.max_distance is not None:
            dist = min(dist, self.max_distance)
        return dist

    def distance_for_bbox(self, bbox: Sequence[float]) -> Optional[float]:
        return self.distance(self.project_bbox(bbox))


class HomographyProjector(GroundProjector):
    """Image → ground plane from ≥ 4 image↔world correspondences."""

    def __init__(self, cfg: dict, device: DeviceLike = None):
        super().__init__(origin=cfg.get("origin", (0.0, 0.0)),
                         max_distance=cfg.get("max_distance"))
        self.device = resolve_device(device)
        img_pts = np.asarray(cfg.get("image_points", []), np.float32)
        world_pts = np.asarray(cfg.get("world_points", []), np.float32)
        if img_pts.ndim != 2 or img_pts.shape[0] < 4 \
                or img_pts.shape[1] != 2:
            raise ValueError("homography requires >= 4 image points (x, y)")
        if world_pts.shape != img_pts.shape:
            raise ValueError("image_points and world_points shapes must match")
        self.H = find_homography_dlt(img_pts, world_pts)
        self._dev = (
            torch.tensor(self.H, dtype=torch.float32, device=self.device),
            torch.tensor(self.origin, dtype=torch.float32, device=self.device),
            torch.tensor(np.inf if self.max_distance is None
                         else self.max_distance, dtype=torch.float32,
                         device=self.device))

    def device_params(self):
        """(H (3, 3), origin (2,), max_distance ()) float32 tensors."""
        return self._dev

    def project_point(self, x: float, y: float):
        """One image point → ground (X, Y) on the host, or None where
        the mapping is degenerate (w ≈ 0 or a non-finite result)."""
        mapped = self.H @ np.array([float(x), float(y), 1.0], np.float64)
        w = float(mapped[2])
        if abs(w) < 1e-6:
            return None
        gx, gy = mapped[0] / w, mapped[1] / w
        if not (np.isfinite(gx) and np.isfinite(gy)):
            return None
        return float(gx), float(gy)


def project_points_device(H: torch.Tensor, pts: torch.Tensor):
    """pts (..., 2) → (ground (..., 2), valid (...)), elementwise f32."""
    x, y = pts[..., 0], pts[..., 1]
    u = H[0, 0] * x + H[0, 1] * y + H[0, 2]
    v = H[1, 0] * x + H[1, 1] * y + H[1, 2]
    w = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    small = w.abs() < 1e-6
    safe_w = torch.where(small, torch.ones_like(w), w)
    ground = torch.stack([u / safe_w, v / safe_w], dim=-1)
    valid = ~small & torch.isfinite(ground).all(dim=-1)
    return torch.where(valid[..., None], ground, torch.zeros_like(ground)), \
        valid


def project_boxes_device(H: torch.Tensor, boxes: torch.Tensor):
    """Boxes (..., 4) xyxy → bottom-centre ground points + validity."""
    cx = 0.5 * (boxes[..., 0] + boxes[..., 2])
    return project_points_device(H, torch.stack([cx, boxes[..., 3]], dim=-1))


def distance_device(ground: torch.Tensor, valid: torch.Tensor,
                    origin: torch.Tensor, max_distance: torch.Tensor):
    """‖ground − origin‖ clamped to max_distance; invalid → NaN."""
    d = torch.linalg.vector_norm(ground - origin, dim=-1)
    d = torch.minimum(d, max_distance)
    return torch.where(valid & torch.isfinite(d), d,
                       torch.full_like(d, float("nan")))


def build_projector(cfg: dict, device: DeviceLike = None) -> HomographyProjector:
    """From a ``geometry`` config section (or its ``projector`` entry)."""
    proj_cfg = cfg.get("projector") if isinstance(cfg, dict) else None
    if proj_cfg is None:
        proj_cfg = cfg
    proj_type = (proj_cfg.get("type") or "homography").lower()
    if proj_type == "homography":
        return HomographyProjector(proj_cfg, device=device)
    raise ValueError(f"unknown projector type: {proj_type}")
