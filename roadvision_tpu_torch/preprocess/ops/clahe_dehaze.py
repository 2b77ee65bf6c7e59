"""CLAHE-on-luma "dehaze" op — the port of
``roadvision_tpu/preprocess/ops/clahe_dehaze.py`` (YCrCb path).

BGR → YCrCb (OpenCV fixed point), CLAHE on Y (kernels K1 and K2 on the
card), YCrCb → BGR. Parameters and their normalisation as in the JAX
package: ``space`` (case-insensitive), ``clip_limit`` (2.0),
``tile_grid`` (8, floored at 2), plus ``blend`` ("cv2" | "fixed").
``space: LAB`` is not ported yet and raises at construction.
"""
from __future__ import annotations

from ...ops import color
from ...ops.clahe import BLENDS, clahe_planar
from ..base import PreprocessOp


class CLAHEDehaze(PreprocessOp):
    def __init__(self, **params):
        super().__init__(**params)
        self.space = str(params.get("space", "YCrCb")).upper()
        if self.space == "LAB":
            raise NotImplementedError(
                "CLAHEDehaze space: LAB is not ported to roadvision_tpu_torch "
                "yet (YCrCb only)")
        self.clip_limit = float(params.get("clip_limit", 2.0))
        self.grid = max(2, int(params.get("tile_grid", 8)))
        self.blend = str(params.get("blend", "cv2"))
        if self.blend not in BLENDS:
            raise ValueError(f"CLAHEDehaze blend must be one of {BLENDS}")

    def apply_planar(self, planes):
        b, g, r = planes
        y, cr, cb = color.bgr_planes_to_ycrcb_i32(b, g, r)
        y2 = clahe_planar(y, clip_limit=self.clip_limit,
                          grid=(self.grid, self.grid), blend=self.blend)
        return color.ycrcb_planes_to_bgr_i32(y2, cr, cb)
