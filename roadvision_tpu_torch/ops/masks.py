"""Instance masks of the segment task — the port of
``roadvision_tpu/ops/masks.py``: :func:`compose_masks` on the device
(one batched product of the kept detections' coefficients with the
prototypes, sigmoid, crop to the box by comparison with row / column
grids, invalid slots zeroed) and the host half, :func:`paste_masks` with
its numpy bilinear resize, copied.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def compose_masks(coeffs: torch.Tensor, protos: torch.Tensor,
                  boxes: torch.Tensor, valid: torch.Tensor,
                  stride: float = 4.0) -> torch.Tensor:
    """coeffs (B, K, nm), protos (B, mh, mw, nm), boxes (B, K, 4) xyxy in
    letterbox pixels, valid (B, K) → (B, K, mh, mw) float32 in [0, 1]:
    sigmoid(coeffs · protos), zero outside the box (col ≥ x1 ∧ col < x2
    on box / ``stride``) and for invalid slots."""
    m = torch.sigmoid(torch.einsum("bkn,bhwn->bkhw", coeffs.float(),
                                   protos.float()))
    bb = boxes / stride
    mh, mw = m.shape[2], m.shape[3]
    col = torch.arange(mw, dtype=torch.float32, device=m.device)
    row = torch.arange(mh, dtype=torch.float32, device=m.device)
    x1, y1, x2, y2 = (bb[..., i][:, :, None, None] for i in range(4))
    inside = (col >= x1) & (col < x2) & (row[:, None] >= y1) \
        & (row[:, None] < y2)
    return torch.where(inside & valid[:, :, None, None], m,
                       torch.zeros((), device=m.device))


def _bilinear_resize(m: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """align_corners=False bilinear (the F.interpolate default ultralytics
    uses), host numpy, float32 in/out."""
    in_h, in_w = m.shape
    if in_h == out_h and in_w == out_w:
        return m.astype(np.float32)
    ys = (np.arange(out_h, dtype=np.float64) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w, dtype=np.float64) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, in_w - 1)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    m = m.astype(np.float64)
    top = m[y0][:, x0] * (1 - wx) + m[y0][:, x1] * wx
    bot = m[y1][:, x0] * (1 - wx) + m[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def paste_masks(masks: np.ndarray, valid: np.ndarray,
                ratio: float, pad: Tuple[float, float],
                orig_hw: Tuple[int, int],
                thresh: Optional[float] = 0.5) -> np.ndarray:
    """Prototype-resolution masks → source-frame pixel masks (host).

    masks (K, mh, mw) float32 from :func:`compose_masks` (one image);
    valid (K,) bool; ``ratio`` (scalar r) and ``pad`` ((left, top) in
    letterbox-target pixels) are the metadata the detector already
    returns for box rescale (ops/letterbox.py:90-145); orig_hw the
    source frame size.

    Returns (K, H, W) — bool when ``thresh`` is set (ultralytics' 0.5
    cut), float32 soft masks when ``thresh`` is None. Invalid slots are
    all-zero. Un-letterboxing happens at prototype scale: the padded
    border is cut (pad and the scaled content extent divided by the
    prototype stride 4) and the content is bilinearly resized to the
    source frame.
    """
    k, mh, mw = masks.shape
    oh, ow = int(orig_hw[0]), int(orig_hw[1])
    r = float(np.asarray(ratio).reshape(-1)[0])
    left, top = (float(v) for v in np.asarray(pad).reshape(-1)[:2])
    cy0 = int(round(top / 4.0))
    cx0 = int(round(left / 4.0))
    ch = max(1, int(round(oh * r / 4.0)))
    cw = max(1, int(round(ow * r / 4.0)))
    cy1 = min(mh, cy0 + ch)
    cx1 = min(mw, cx0 + cw)
    out_dtype = bool if thresh is not None else np.float32
    out = np.zeros((k, oh, ow), out_dtype)
    for i in range(k):
        if not valid[i]:
            continue
        crop = masks[i, cy0:cy1, cx0:cx1]
        full = _bilinear_resize(crop, oh, ow)
        out[i] = full > thresh if thresh is not None else full
    return out


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two boolean masks (host, eval/test helper); 0 when both
    are empty."""
    a = a.astype(bool)
    b = b.astype(bool)
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0
