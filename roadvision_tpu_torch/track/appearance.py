"""Per-detection appearance descriptors for the re-id trackers — a copy
of ``roadvision_tpu/track/appearance.py`` on tensors.

The descriptor is a fixed G×G bilinear grid sample of the detection's
box interior (BGR), mean-removed and L2-normalised; the cosine
similarity of two descriptors is their dot product. The sampler is
shared with the learned embedder (``reid.py``). Both functions take one
frame or a batch of frames (a leading batch axis on the frame and the
boxes).
"""
from __future__ import annotations

import torch

EMB_GRID = 6
EMB_DIM = EMB_GRID * EMB_GRID * 3


def sample_box_grid(frame_u8: torch.Tensor, boxes: torch.Tensor,
                    size: int) -> torch.Tensor:
    """([B,] H, W, 3) uint8 frame + ([B,] D, 4) xyxy source px → ([B,]
    D, size, size, 3) f32 bilinear samples of each box interior (grid
    centres at (i + 0.5)/size of the box extent, clamped to the frame):
    four gathers, the four taps summed in the JAX order."""
    if frame_u8.dim() == 3:
        return sample_box_grid(frame_u8[None], boxes[None], size)[0]
    nb, h, w = frame_u8.shape[:3]
    nd = boxes.shape[1]
    dev = boxes.device
    img = frame_u8.to(torch.float32)
    u = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    gx = x1[..., None] + u * (x2 - x1)[..., None]          # (B, D, S)
    gy = y1[..., None] + u * (y2 - y1)[..., None]
    sx = gx.clamp(0.0, w - 1.0)[:, :, None, :].expand(nb, nd, size, size)
    sy = gy.clamp(0.0, h - 1.0)[:, :, :, None].expand(nb, nd, size, size)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    bi = torch.arange(nb, device=dev)[:, None, None, None]
    p00 = img[bi, y0i, x0i]
    p01 = img[bi, y0i, x1i]
    p10 = img[bi, y1i, x0i]
    p11 = img[bi, y1i, x1i]
    return (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
            + p10 * (1 - fx) * fy + p11 * fx * fy)


def box_embeddings(frame_u8: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """([B,] H, W, 3) uint8 + ([B,] D, 4) xyxy source px + ([B,] D,) bool
    → ([B,] D, EMB_DIM) f32, L2-normalised, zero rows for invalid
    detections."""
    sample = sample_box_grid(frame_u8, boxes, EMB_GRID)
    flat = sample.reshape(*boxes.shape[:-1], EMB_DIM)
    flat = flat - flat.mean(dim=-1, keepdim=True)
    norm = torch.sqrt((flat * flat).sum(dim=-1, keepdim=True))
    emb = flat / torch.clamp(norm, min=1e-6)
    return torch.where(valid[..., None], emb, torch.zeros_like(emb))
