"""CLAHE-on-luma "dehaze" op — the port of
``roadvision_tpu/preprocess/ops/clahe_dehaze.py``.

BGR → YCrCb (default) or LAB in OpenCV's fixed point, CLAHE on the luma
or L channel (kernels K1 and K2 on the card), and back. Parameters and
their normalisation as in the JAX package: ``space`` ("YCrCb" | "LAB",
case-insensitive), ``clip_limit`` (2.0), ``tile_grid`` (8, floored at
2), plus ``blend`` ("cv2" | "fixed").

The YCrCb path is planar and has the sampled terminal-op form: the tile
LUTs come from the full luma plane, and the LUT apply, the chroma and
the way back to BGR run only at the sample grid. LAB runs channel-last
through :meth:`CLAHEDehaze.apply_batch`, so a chain with it is not fused
and not sampled.
"""
from __future__ import annotations

import torch

from ...ops import color
from ...ops.clahe import BLENDS, clahe_planar, clahe_planar_sampled
from ..base import PreprocessOp


class CLAHEDehaze(PreprocessOp):
    def __init__(self, **params):
        super().__init__(**params)
        self.space = str(params.get("space", "YCrCb")).upper()
        self.clip_limit = float(params.get("clip_limit", 2.0))
        self.grid = max(2, int(params.get("tile_grid", 8)))
        self.blend = str(params.get("blend", "cv2"))
        if self.blend not in BLENDS:
            raise ValueError(f"CLAHEDehaze blend must be one of {BLENDS}")

    def _clahe(self, plane: torch.Tensor) -> torch.Tensor:
        return clahe_planar(plane, clip_limit=self.clip_limit,
                            grid=(self.grid, self.grid), blend=self.blend)

    def supports_planar(self) -> bool:
        return self.space != "LAB"

    def apply_planar(self, planes):
        b, g, r = planes
        y, cr, cb = color.bgr_planes_to_ycrcb_i32(b, g, r)
        return color.ycrcb_planes_to_bgr_i32(self._clahe(y), cr, cb)

    def supports_planar_sampled(self) -> bool:
        return self.supports_planar()

    def apply_planar_sampled(self, planes, plan_y, plan_x):
        b, g, r = planes
        (sy, oy, ny), (sx, ox, nx) = plan_y, plan_x

        def sub(p):
            return p[..., oy:oy + sy * ny:sy, ox:ox + sx * nx:sx]

        y_full = color.bgr_planes_to_ycrcb_i32(b, g, r)[0]
        y2s = clahe_planar_sampled(y_full, plan_y, plan_x,
                                   clip_limit=self.clip_limit,
                                   grid=(self.grid, self.grid),
                                   blend=self.blend)
        _, crs, cbs = color.bgr_planes_to_ycrcb_i32(sub(b), sub(g), sub(r))
        return color.ycrcb_planes_to_bgr_i32(y2s, crs, cbs)

    def apply_batch(self, frames: torch.Tensor) -> torch.Tensor:
        if self.space == "LAB":
            lab = color.bgr_to_lab_u8_fixed(frames)
            l2 = self._clahe(lab[..., 0].contiguous())
            return color.lab_to_bgr_u8_fixed(
                torch.cat([l2[..., None], lab[..., 1:]], dim=-1))
        b, g, r = self.apply_planar(tuple(frames[..., c] for c in range(3)))
        return torch.stack([b, g, r], dim=-1)
