"""Per-detection appearance descriptors for the re-id trackers — a copy
of ``roadvision_tpu/track/appearance.py`` on tensors.

The descriptor is a fixed G×G bilinear grid sample of the detection's
box interior (BGR), mean-removed and L2-normalised; the cosine
similarity of two descriptors is their dot product. The sampler is
shared with the learned embedder (``reid.py``). Both functions take one
frame, a batch of frames or a fleet's (S, B) frames (the same leading
axes on the frames and the boxes).
"""
from __future__ import annotations

import torch

EMB_GRID = 6
EMB_DIM = EMB_GRID * EMB_GRID * 3


def sample_box_grid(frame_u8: torch.Tensor, boxes: torch.Tensor,
                    size: int) -> torch.Tensor:
    """(..., H, W, 3) uint8 frames + (..., D, 4) xyxy source px → (...,
    D, size, size, 3) f32 bilinear samples of each box interior (grid
    centres at (i + 0.5)/size of the box extent, clamped to the frame):
    four gathers, the four taps summed in the JAX order. More leading
    axes (a fleet's (S, B, H, W, 3) with (S, B, D, 4)) are folded into
    the batch axis and unfolded after."""
    if frame_u8.dim() != 4:
        lead = frame_u8.shape[:-3]
        flat = sample_box_grid(frame_u8.reshape(-1, *frame_u8.shape[-3:]),
                               boxes.reshape(-1, *boxes.shape[-2:]), size)
        return flat.reshape(lead + flat.shape[1:])
    nb, h, w = frame_u8.shape[:3]
    nd = boxes.shape[1]
    dev = boxes.device
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
    # the taps are gathered as uint8 and widened after (the same values
    # as gathering from a float copy of the frames, without the copy)
    p00 = frame_u8[bi, y0i, x0i].to(torch.float32)
    p01 = frame_u8[bi, y0i, x1i].to(torch.float32)
    p10 = frame_u8[bi, y1i, x0i].to(torch.float32)
    p11 = frame_u8[bi, y1i, x1i].to(torch.float32)
    return (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
            + p10 * (1 - fx) * fy + p11 * fx * fy)


def box_embeddings(frame_u8: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 + (..., D, 4) xyxy source px + (..., D) bool
    → (..., D, EMB_DIM) f32, L2-normalised, zero rows for invalid
    detections."""
    sample = sample_box_grid(frame_u8, boxes, EMB_GRID)
    flat = sample.reshape(*boxes.shape[:-1], EMB_DIM)
    flat = flat - flat.mean(dim=-1, keepdim=True)
    norm = torch.sqrt((flat * flat).sum(dim=-1, keepdim=True))
    emb = flat / torch.clamp(norm, min=1e-6)
    return torch.where(valid[..., None], emb, torch.zeros_like(emb))
