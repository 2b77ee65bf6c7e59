"""Median filter on uint8 planes: plain PyTorch plus one CUDA kernel.

Port of ``roadvision_tpu/ops/median.py:81-158``: odd k in [3, 9] after
the reference's normalisation (even → +1, clamp), replicate border,
exact median. The plain version uses the shared sorted-triples identity
for k = 3 (``median9 = med3(max3(lows), med3(mids), min3(highs))``,
median.py:56-78) and an exact median over the k² shifted views for
k >= 5. The kernel K3 (``csrc/median.cu``) replaces
``pallas_median.py::median3_pallas`` and covers k = 5, 7, 9 as well.

:func:`median_planes` runs the plain version for a tensor on the CPU
and launches the kernel for a CUDA tensor; there is no other route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import _build


def normalize_ksize(ksize: int) -> int:
    """Even → +1, clamp to [3, 9] (median.py:81-87)."""
    k = int(ksize)
    if k % 2 == 0:
        k += 1
    return max(3, min(k, 9))


def _pad_edge(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad the (H, W) axes of (N, H, W) by index."""
    h, w = x.shape[-2], x.shape[-1]
    iy = torch.arange(-pad, h + pad, device=x.device).clamp_(0, h - 1)
    ix = torch.arange(-pad, w + pad, device=x.device).clamp_(0, w - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def median_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, H, W) uint8 → (N, H, W) uint8, exact median, replicate border."""
    n, h, w = x.shape
    r = k // 2
    xp = _pad_edge(x, r)
    if k == 3:
        a, b, c = (xp[:, dy:dy + h, :] for dy in range(3))
        lo = torch.minimum(torch.minimum(a, b), c)
        hi = torch.maximum(torch.maximum(a, b), c)
        mid = torch.maximum(torch.minimum(a, b),
                            torch.minimum(torch.maximum(a, b), c))

        def xs(v, dx):
            return v[:, :, dx:dx + w]

        def med3(p, q, s):
            return torch.maximum(torch.minimum(p, q),
                                 torch.minimum(torch.maximum(p, q), s))

        mx = torch.maximum(torch.maximum(xs(lo, 0), xs(lo, 1)), xs(lo, 2))
        md = med3(xs(mid, 0), xs(mid, 1), xs(mid, 2))
        mn = torch.minimum(torch.minimum(xs(hi, 0), xs(hi, 1)), xs(hi, 2))
        return med3(mx, md, mn).contiguous()
    # k² windows as one unfold; the middle of k² sorted values (odd count)
    win = F.unfold(xp.unsqueeze(1).float(), kernel_size=k)   # (N, k², H·W)
    med = win.median(dim=1).values
    return med.view(n, h, w).to(torch.uint8)


def _median_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    n, h, w = x.shape
    out = torch.empty_like(x)
    lib = _build.load("median")
    with torch.cuda.device(x.device):
        code = lib.rvt_median_k(x.data_ptr(), out.data_ptr(), n, h, w, k,
                                _build.stream_ptr(x))
    _build.launch_counts["median_k"] += 1
    _build.check(code, "median_k")
    return out


def median_planes(x: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """K3 wrapper on (N, H, W) uint8 planes: CPU tensor → plain version,
    CUDA tensor → kernel."""
    k = normalize_ksize(ksize)
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected (N, H, W) uint8, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.device.type == "cpu":
        return median_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if k > 3 and x.shape[0] > 65535:    # planes ride gridDim.z there
        raise ValueError("at most 65535 planes per launch at k >= 5")
    return _median_cuda(x.contiguous(), k)


def median_planar(x: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Median on (..., H, W) planes with values in [0, 255]; the output
    keeps the input dtype (the counterpart of ``median_planar_i32``)."""
    h, w = x.shape[-2], x.shape[-1]
    planes = x.reshape((-1, h, w)).to(torch.uint8)
    return median_planes(planes, ksize).reshape(x.shape).to(x.dtype)


def median_planar_strided(x: torch.Tensor, ksize: int, plan_y,
                          plan_x) -> torch.Tensor:
    """Median output at a strided sample grid, ``plan = (stride, offset,
    count)`` per axis (the counterpart of ``median_planar_strided_i32``,
    whose docstring defines the result as
    ``median_planar(x)[..., oy::sy, ox::sx]`` cut to the counts).

    That is how it is computed here, on the CPU and on the card: the
    kernel runs over the whole planes and the grid is sliced out. Every
    window reads every input pixel either way, and K3 runs at 1.21 × a
    plain copy of its bytes, so a strided variant of the kernel could
    save only the store of the pixels that are dropped."""
    (sy, oy, ny), (sx, ox, nx) = plan_y, plan_x
    full = median_planar(x, ksize)
    return full[..., oy:oy + sy * ny:sy, ox:ox + sx * nx:sx]


def median_blur_u8(x: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """(..., H, W, C) uint8 → same: channels filtered as planes."""
    moved = torch.movedim(x, -1, 0)
    return torch.movedim(median_planar(moved.contiguous(), ksize), 0, -1) \
        .contiguous()
