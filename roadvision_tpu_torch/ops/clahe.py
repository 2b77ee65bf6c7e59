"""CLAHE on uint8 luma planes: plain PyTorch plus two CUDA kernels.

Port of ``roadvision_tpu/ops/clahe.py:125-450``: OpenCV's CLAHE step for
step — reflect-101 pad of the ragged edge, 256-bin histogram per tile,
clip at ``max(int(clip·area/256), 1)`` with OpenCV's excess
redistribution, LUT = round-half-even(cdf·255/area), then the bilinear
blend of the four neighbouring tile LUTs with OpenCV's half-tile offset,
in one of two modes:

  * "cv2" (default) — float32 with every multiply and add rounded on its
    own, as OpenCV's SSE path does;
  * "fixed" — exact uint32 rationals over ``4·th·tw``, half-even division.

Two stages, two kernels (``csrc/clahe.cu``):

  * :func:`clahe_tile_luts` — K1, the histogram→clip→CDF stage
    (``_luts_for_plane``; XLA-only in the JAX package). The kernel cuts
    tile rows into 16-byte pieces and counts them into one histogram per
    warp; :func:`tile_pieces` and :func:`tile_luts_by_pieces` are that
    layout in numpy;
  * :func:`clahe_apply` — K2, the LUT apply and blend (``sweep_pallas`` +
    the blend of ``_apply_band_sweep``). The kernel works on chunks of
    rows that share one pair of tile rows and gathers from a packed
    four-tap table per column interval; :func:`row_chunks`,
    :func:`col_intervals` and :func:`packed_taps_plain` are that layout
    in numpy and plain PyTorch. With ``sample`` the plane is a strided
    sample grid of a larger one (:func:`clahe_planar_sampled`): same
    kernel, the larger plane's tables at the sampled rows and columns.

Each wrapper runs its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor; there is no other route. The per-row and
per-column interpolation tables are host numpy, exactly as the JAX
package builds them at trace time.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels import _build
from ..utils.device import device_constant

BLENDS = ("cv2", "fixed")


# ---------------------------------------------------------------------------
# host-side geometry (numpy, shared by the plain path and the kernels)
# ---------------------------------------------------------------------------

def pad_plan(h: int, w: int, gy: int, gx: int) -> Tuple[int, int, int, int]:
    """(pad_h, pad_w, th, tw). OpenCV quirk kept from clahe.py:225-235:
    when EITHER dimension is ragged, BOTH are padded by
    ``tiles - size % tiles`` (a dimension that divides gains a full tile)."""
    if h % gy == 0 and w % gx == 0:
        pad_h = pad_w = 0
    else:
        pad_h = gy - h % gy
        pad_w = gx - w % gx
    return pad_h, pad_w, (h + pad_h) // gy, (w + pad_w) // gx


def clip_count(clip_limit: float, tile_area: int) -> int:
    """Integer clip limit as at clahe.py:240 (0 = no clipping)."""
    if clip_limit > 0:
        return max(int(clip_limit * tile_area / 256.0), 1)
    return 0


def lut_scale(tile_area: int) -> np.float32:
    return np.float32(255.0 / tile_area)


def _interp_coords(size: int, tile: int, tiles: int):
    """Tile indices and float blend weight along one axis (clahe.py:185-197)."""
    pos = (np.arange(size, dtype=np.float32) + 0.0) \
        * (1.0 / np.float32(tile)) - 0.5
    i1_raw = np.floor(pos).astype(np.int32)
    frac = (pos - i1_raw).astype(np.float32)
    i1 = np.maximum(i1_raw, 0)
    i2 = np.minimum(i1_raw + 1, tiles - 1)
    return i1, i2, frac


def _interp_weight_num(size: int, tile: int) -> np.ndarray:
    """Exact numerator of the blend weight over 2·tile (clahe.py:200-208)."""
    x = np.arange(size, dtype=np.int64)
    return (2 * x - tile) % (2 * tile)


@functools.lru_cache(maxsize=64)
def interp_tables(size: int, tile: int, tiles: int):
    """(size, 3) int32 [i1, i2, num] and (size, 2) float32 [frac, 1-frac]."""
    i1, i2, frac = _interp_coords(size, tile, tiles)
    num = _interp_weight_num(size, tile)
    ti = np.stack([i1, i2, num.astype(np.int32)], axis=1).astype(np.int32)
    tf = np.stack([frac, np.float32(1.0) - frac], axis=1).astype(np.float32)
    return ti, tf


Plan = Tuple[int, int, int]          # (stride, offset, count) along one axis
# a plane that is a strided sample grid of a larger one:
# (full_h, full_w, plan_y, plan_x); None for a whole plane
Sample = Optional[Tuple[int, int, Plan, Plan]]


def _host_tables(h: int, w: int, th: int, tw: int, gy: int, gx: int,
                 sample: Sample = None):
    """Row and column interpolation tables of an (h, w) plane, or of the
    sample grid of a (full_h, full_w) plane: the full plane's tables at
    the sampled rows and columns (clahe.py:281-285)."""
    if sample is None:
        return (*interp_tables(h, th, gy), *interp_tables(w, tw, gx))
    fh, fw, (sy, oy, ny), (sx, ox, nx) = sample
    ri, rf = interp_tables(fh, th, gy)
    ci, cf = interp_tables(fw, tw, gx)
    rows = np.arange(ny) * sy + oy
    cols = np.arange(nx) * sx + ox
    return ri[rows], rf[rows], ci[cols], cf[cols]


def _check_sample(h: int, w: int, sample: Sample) -> None:
    if sample is None:
        return
    fh, fw, (sy, oy, ny), (sx, ox, nx) = sample
    if (ny, nx) != (h, w):
        raise ValueError(f"sample grid {ny}x{nx} does not match the plane "
                         f"{h}x{w}")
    if min(sy, sx) < 1 or min(oy, ox) < 0 \
            or oy + sy * (ny - 1) >= fh or ox + sx * (nx - 1) >= fw:
        raise ValueError(f"sample grid {sample[2:]} leaves the {fh}x{fw} "
                         f"plane")


_dev_tables: Dict[tuple, tuple] = {}


def _tables_on(device: torch.device, h: int, w: int, th: int, tw: int,
               gy: int, gx: int, sample: Sample = None):
    key = (str(device), h, w, th, tw, gy, gx, sample)
    got = _dev_tables.get(key)
    if got is None:
        got = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in _host_tables(h, w, th, tw, gy, gx, sample))
        _dev_tables[key] = got
    return got


def _chunk_rows() -> int:
    """K2's rows per block: ``RVT_CLAHE_CHUNK`` (the JAX package's name
    for its CLAHE apply chunk, read once at import), default 24. Any
    size gives the same bytes; it moves only the time."""
    raw = os.environ.get("RVT_CLAHE_CHUNK", "24")
    try:
        rows = int(raw)
    except ValueError:
        rows = 0
    if not 1 <= rows <= 1024:
        raise ValueError(f"RVT_CLAHE_CHUNK={raw!r} must be an integer in "
                         f"[1, 1024] (rows per block of the CLAHE apply)")
    return rows


# rows per block of K2; a chunk never crosses a change of tile rows
APPLY_CHUNK_ROWS = _chunk_rows()
# K2 reads its column tables in groups of adjacent columns
_COL_PAD = 4


def row_chunks(ri: np.ndarray, chunk_rows: int) -> np.ndarray:
    """Cut the rows of ``interp_tables(h, th, gy)[0]`` into chunks for K2.

    Returns (nchunks, 4) int32 ``[y0, y1, r1, r2]``: rows [y0, y1) all
    blend tile rows r1 and r2. The rows are first cut wherever (r1, r2)
    changes (OpenCV's half-tile offset: at most gy + 1 bands), then each
    band into near-equal pieces of at most ``chunk_rows`` rows."""
    h = ri.shape[0]
    change = np.flatnonzero(np.any(ri[1:, :2] != ri[:-1, :2], axis=1)) + 1
    out = []
    for s, e in zip([0, *change], [*change, h]):
        pieces = -(-(e - s) // chunk_rows)
        edges = s + (np.arange(pieces + 1) * (e - s)) // pieces
        for y0, y1 in zip(edges[:-1], edges[1:]):
            out.append((y0, y1, ri[s, 0], ri[s, 1]))
    return np.asarray(out, dtype=np.int32).reshape(-1, 4)


def col_intervals(ci: np.ndarray, gx: int) -> np.ndarray:
    """Column interval of every column, from ``interp_tables(w, tw, gx)[0]``:
    interval c in [0, gx] blends tile columns max(c - 1, 0) and
    min(c, gx - 1), so 0 and gx are the half tiles at the two edges."""
    c1, c2 = ci[:, 0], ci[:, 1]
    return np.where(c1 != c2, c2, np.where(c1 == 0, 0, gx)).astype(np.int32)


_dev_apply_tables: Dict[tuple, tuple] = {}


def _apply_tables_on(device: torch.device, h: int, w: int, th: int, tw: int,
                     gy: int, gx: int, chunk_rows: int,
                     sample: Sample = None):
    """K2's device tables: chunks, row [i1, i2, num], row [frac, 1-frac],
    then per column (padded to a multiple of ``_COL_PAD``) the interval,
    the exact weight numerator, frac and 1-frac. With ``sample`` they are
    the full plane's tables at the sampled rows and columns; the kernel
    reads them the same way."""
    key = (str(device), h, w, th, tw, gy, gx, chunk_rows, sample)
    got = _dev_apply_tables.get(key)
    if got is None:
        ri, rf, ci, cf = _host_tables(h, w, th, tw, gy, gx, sample)
        pad = (0, -w % _COL_PAD)
        cols = (col_intervals(ci, gx), ci[:, 2], cf[:, 0], cf[:, 1])
        arrays = (row_chunks(ri, chunk_rows), ri, rf,
                  *(np.pad(np.ascontiguousarray(c), pad) for c in cols))
        got = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in arrays)
        _dev_apply_tables[key] = got
    return got


def _reflect_pad_101(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """BORDER_REFLECT_101 on bottom/right (numpy's "reflect"), by index."""
    if pad_h == 0 and pad_w == 0:
        return x
    h, w = x.shape[-2], x.shape[-1]
    return x.index_select(-2, _reflect_index(h, pad_h, x.device)) \
        .index_select(-1, _reflect_index(w, pad_w, x.device)).contiguous()


@functools.lru_cache(maxsize=64)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """The source index of each of ``n + pad`` reflect-101 positions, on
    ``device``, made once (a captured step cannot upload it)."""
    return torch.from_numpy(np.pad(np.arange(n), (0, pad),
                                   mode="reflect")).to(device)


# ---------------------------------------------------------------------------
# K1 — tile LUTs
# ---------------------------------------------------------------------------

def tile_luts_plain(xe: torch.Tensor, gy: int, gx: int, clip: int,
                    scale: np.float32) -> torch.Tensor:
    """(N, Hp, Wp) uint8 padded plane → (N, gy, gx, 256) uint8 LUTs."""
    n, hp, wp = xe.shape
    th, tw = hp // gy, wp // gx
    dev = xe.device
    tile_id = (torch.arange(n, device=dev).view(n, 1, 1, 1, 1) * (gy * gx)
               + torch.arange(gy, device=dev).view(1, gy, 1, 1, 1) * gx
               + torch.arange(gx, device=dev).view(1, 1, 1, gx, 1))
    idx = tile_id * 256 + xe.view(n, gy, th, gx, tw).long()
    hist = torch.bincount(idx.reshape(-1), minlength=n * gy * gx * 256)
    hist = hist.view(n, gy, gx, 256)
    if clip > 0:
        clipped = torch.clamp(hist, max=clip)
        excess = (hist - clipped).sum(dim=-1, keepdim=True)
        redist = torch.div(excess, 256, rounding_mode="floor")
        residual = excess - redist * 256
        b = torch.arange(256, device=dev)
        step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
        bump = (b % step == 0) & (torch.div(b, step, rounding_mode="floor")
                                  < residual)
        hist = clipped + redist + bump.long()
    cdf = torch.cumsum(hist, dim=-1)
    lut = torch.round(cdf.to(torch.float32)
                      * device_constant(float(scale), torch.float32, dev))
    return lut.clamp_(0, 255).to(torch.uint8)


# K1's layout: threads per block, bytes per piece
LUT_THREADS = 256
LUT_PIECE = 16


def tile_pieces(th: int, tw: int) -> np.ndarray:
    """The pieces K1 cuts a (th, tw) tile into, (npieces, 3) int32
    ``[row, first column, bytes inside the tile]``: piece p is up to 16
    adjacent bytes of tile row ``p // ppr`` with ``ppr = ceil(tw / 16)``;
    thread ``p % 256`` of the tile's block loads and counts it."""
    ppr = -(-tw // LUT_PIECE)
    p = np.arange(th * ppr)
    col = (p % ppr) * LUT_PIECE
    return np.stack([p // ppr, col, np.minimum(LUT_PIECE, tw - col)],
                    axis=1).astype(np.int32)


def tile_luts_by_pieces(xe: torch.Tensor, gy: int, gx: int, clip: int,
                        scale: np.float32) -> torch.Tensor:
    """:func:`tile_luts_plain` computed the way K1 lays the work out, in
    numpy: pieces dealt to 256 threads, one histogram per warp (a piece
    of 16 equal bytes adds 16 at once, any other its bytes one by one),
    the warps' histograms summed per bin, the clip, then the scan as 32
    bins per warp plus the totals of the warps before."""
    x = xe.cpu().numpy()
    n, hp, wp = x.shape
    th, tw = hp // gy, wp // gx
    pieces = tile_pieces(th, tw)
    warps = LUT_THREADS // 32
    warp_of = (np.arange(len(pieces)) % LUT_THREADS) // 32
    cols = pieces[:, 1:2] + np.arange(LUT_PIECE)[None, :]
    inside = np.arange(LUT_PIECE)[None, :] < pieces[:, 2:3]
    out = np.empty((n, gy, gx, 256), np.uint8)
    bins = np.arange(256)
    for i, ty, tx in np.ndindex(n, gy, gx):
        tile = x[i, ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
        vals = tile[pieces[:, 0:1], np.minimum(cols, tw - 1)].astype(np.int64)
        flat = (pieces[:, 2] == LUT_PIECE) & (vals == vals[:, :1]).all(axis=1)
        wh = np.zeros((warps, 256), np.int64)
        np.add.at(wh, (warp_of[flat], vals[flat, 0]), LUT_PIECE)
        rest = inside & ~flat[:, None]
        np.add.at(wh, (np.broadcast_to(warp_of[:, None], vals.shape)[rest],
                       vals[rest]), 1)
        c = wh.sum(axis=0)
        if clip > 0:
            clipped = np.minimum(c, clip)
            excess = int((c - clipped).sum())
            redist, residual = divmod(excess, 256)
            step = max(256 // max(residual, 1), 1)
            c = clipped + redist + ((bins % step == 0)
                                    & (bins // step < residual))
        in_warp = np.cumsum(c.reshape(warps, 32), axis=1)
        before = np.concatenate([[0], np.cumsum(in_warp[:-1, -1])])
        cdf = (in_warp + before[:, None]).reshape(256)
        lut = np.rint(cdf.astype(np.float32) * np.float32(scale))
        out[i, ty, tx] = np.clip(lut, 0, 255).astype(np.uint8)
    return torch.from_numpy(out).to(xe.device)


def _tile_luts_cuda(xe: torch.Tensor, gy: int, gx: int, clip: int,
                    scale: np.float32) -> torch.Tensor:
    n, hp, wp = xe.shape
    th, tw = hp // gy, wp // gx
    out = torch.empty((n, gy, gx, 256), dtype=torch.uint8, device=xe.device)
    lib = _build.load("clahe")
    with torch.cuda.device(xe.device):
        code = lib.rvt_clahe_tile_luts(
            xe.data_ptr(), out.data_ptr(), n, hp, wp, gy, gx, th, tw, clip,
            ctypes.c_float(float(scale)), _build.stream_ptr(xe))
    _build.launch_counts["clahe_tile_luts"] += 1
    _build.check(code, "clahe_tile_luts")
    return out


def clahe_tile_luts(xe: torch.Tensor, gy: int, gx: int, clip: int,
                    scale: np.float32) -> torch.Tensor:
    """K1 wrapper: CPU tensor → plain version, CUDA tensor → kernel."""
    if xe.dtype != torch.uint8 or xe.dim() != 3:
        raise ValueError(f"expected (N, H, W) uint8, got {tuple(xe.shape)} "
                         f"{xe.dtype}")
    n, hp, wp = xe.shape
    if hp % gy or wp % gx:
        raise ValueError(f"padded plane {hp}x{wp} does not divide the "
                         f"{gy}x{gx} grid")
    if xe.device.type == "cpu":
        return tile_luts_plain(xe, gy, gx, clip, scale)
    if xe.device.type != "cuda":
        raise ValueError(f"unsupported device {xe.device}")
    if n > 65535:
        raise ValueError("at most 65535 planes per launch")
    return _tile_luts_cuda(xe.contiguous(), gy, gx, clip, scale)


# ---------------------------------------------------------------------------
# K2 — LUT apply + bilinear blend
# ---------------------------------------------------------------------------

def lut_taps(x: torch.Tensor, luts: torch.Tensor, th: int, tw: int,
             sample: Sample = None):
    """The four LUT taps (l11, l12, l21, l22) at every pixel, uint8 —
    what ``sweep_pallas`` reads out of its packed table."""
    n, h, w = x.shape
    gy, gx = luts.shape[1], luts.shape[2]
    ri, _, ci, _ = _tables_on(x.device, h, w, th, tw, gy, gx, sample)
    flat = luts.reshape(-1)
    v = x.long()
    nbase = torch.arange(n, device=x.device).view(n, 1, 1) * (gy * gx)
    r1 = (nbase + ri[:, 0].long().view(1, h, 1) * gx) * 256
    r2 = (nbase + ri[:, 1].long().view(1, h, 1) * gx) * 256
    c1 = (ci[:, 0].long() * 256).view(1, 1, w) + v
    c2 = (ci[:, 1].long() * 256).view(1, 1, w) + v
    return flat[r1 + c1], flat[r1 + c2], flat[r2 + c1], flat[r2 + c2]


def packed_taps_plain(x: torch.Tensor, luts: torch.Tensor, th: int, tw: int,
                      chunk_rows: int = APPLY_CHUNK_ROWS,
                      sample: Sample = None) -> torch.Tensor:
    """What K2 gathers at every pixel, (N, H, W) int64: per chunk of rows
    the packed table ``word[c][v] = l11 | l12<<8 | l21<<16 | l22<<24``
    over the gx + 1 column intervals, read at (interval of x, x's value).
    Equals the four :func:`lut_taps` packed the same way. (The kernel
    keeps the four taps of an entry as bytes in the "fixed" blend and as
    f16 values in the "cv2" blend; the indexing is this one.)"""
    n, h, w = x.shape
    gy, gx = luts.shape[1], luts.shape[2]
    ri, _, ci, _ = _host_tables(h, w, th, tw, gy, gx, sample)
    col_c = torch.from_numpy(col_intervals(ci, gx)).long().to(x.device)
    c = torch.arange(gx + 1, device=x.device)
    c1, c2 = (c - 1).clamp_(min=0), c.clamp(max=gx - 1)
    out = torch.empty((n, h, w), dtype=torch.int64, device=x.device)
    lut = luts.long()
    for y0, y1, r1, r2 in row_chunks(ri, chunk_rows).tolist():
        table = (lut[:, r1, c1] | (lut[:, r1, c2] << 8)
                 | (lut[:, r2, c1] << 16) | (lut[:, r2, c2] << 24))
        flat = table.reshape(n, -1)                      # (N, (gx+1)·256)
        idx = col_c.view(1, 1, w) * 256 + x[:, y0:y1].long()
        out[:, y0:y1] = torch.gather(flat, 1, idx.reshape(n, -1)) \
            .view(n, y1 - y0, w)
    return out


def apply_plain(x: torch.Tensor, luts: torch.Tensor, th: int, tw: int,
                blend: str = "cv2", sample: Sample = None) -> torch.Tensor:
    """(N, H, W) uint8 + (N, gy, gx, 256) uint8 LUTs → (N, H, W) uint8.

    One eager op per arithmetic step, so no multiply and add fuse. With
    ``sample``, ``x`` holds the sample grid of a larger plane and every
    pixel blends as it would at its place in that plane."""
    n, h, w = x.shape
    gy, gx = luts.shape[1], luts.shape[2]
    ri, rf, ci, cf = _tables_on(x.device, h, w, th, tw, gy, gx, sample)
    l11, l12, l21, l22 = lut_taps(x, luts, th, tw, sample)
    if blend == "fixed":
        twn, thn = 2 * tw, 2 * th
        den = 4 * th * tw
        xan = ci[:, 2].long().view(1, 1, w)
        yan = ri[:, 2].long().view(1, h, 1)
        top = l11.long() * (twn - xan) + l12.long() * xan
        bot = l21.long() * (twn - xan) + l22.long() * xan
        num = top * (thn - yan) + bot * yan
        q = torch.div(num, den, rounding_mode="floor")
        rem = num - q * den
        up = (2 * rem > den) | ((2 * rem == den) & (q % 2 == 1))
        return (q + up.long()).to(torch.uint8)
    if blend != "cv2":
        raise ValueError(f"blend must be one of {BLENDS}, got {blend!r}")
    xa, xa1 = cf[:, 0].view(1, 1, w), cf[:, 1].view(1, 1, w)
    ya, ya1 = rf[:, 0].view(1, h, 1), rf[:, 1].view(1, h, 1)
    top = torch.add(torch.mul(l11.float(), xa1), torch.mul(l12.float(), xa))
    bot = torch.add(torch.mul(l21.float(), xa1), torch.mul(l22.float(), xa))
    res = torch.add(torch.mul(top, ya1), torch.mul(bot, ya))
    return torch.round(res).clamp_(0, 255).to(torch.uint8)


def _apply_cuda(x: torch.Tensor, luts: torch.Tensor, th: int, tw: int,
                blend: str, sample: Sample) -> torch.Tensor:
    n, h, w = x.shape
    gy, gx = luts.shape[1], luts.shape[2]
    tables = _apply_tables_on(x.device, h, w, th, tw, gy, gx,
                              APPLY_CHUNK_ROWS, sample)
    if luts.data_ptr() % 4:          # the kernel reads the LUTs as words
        luts = luts.clone()
    out = torch.empty_like(x)
    lib = _build.load("clahe")
    with torch.cuda.device(x.device):
        code = lib.rvt_clahe_apply(
            x.data_ptr(), luts.data_ptr(), *(t.data_ptr() for t in tables),
            out.data_ptr(), n, h, w, gy, gx, th, tw, tables[0].shape[0],
            int(blend == "fixed"), _build.stream_ptr(x))
    _build.launch_counts["clahe_apply"] += 1
    _build.check(code, "clahe_apply")
    return out


def clahe_apply(x: torch.Tensor, luts: torch.Tensor, th: int, tw: int,
                blend: str = "cv2", sample: Sample = None) -> torch.Tensor:
    """K2 wrapper: CPU tensor → plain version, CUDA tensor → kernel.

    ``sample = (full_h, full_w, plan_y, plan_x)`` says that ``x`` is the
    (stride, offset, count) sample grid of a (full_h, full_w) plane: the
    row and column tables are then the full plane's at the sampled
    positions, and the kernel is the same."""
    if blend not in BLENDS:
        raise ValueError(f"blend must be one of {BLENDS}, got {blend!r}")
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected (N, H, W) uint8, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if luts.dtype != torch.uint8 or luts.dim() != 4 \
            or luts.shape[0] != x.shape[0] or luts.shape[3] != 256:
        raise ValueError(f"expected (N, gy, gx, 256) uint8 LUTs, got "
                         f"{tuple(luts.shape)} {luts.dtype}")
    if x.device != luts.device:
        raise ValueError("plane and LUTs must be on one device")
    _check_sample(x.shape[1], x.shape[2], sample)
    if x.device.type == "cpu":
        return apply_plain(x, luts, th, tw, blend, sample)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    gy, gx = luts.shape[1], luts.shape[2]
    entry = 4 if blend == "fixed" else 8       # bytes per (interval, bin)
    if (gx + 1) * 256 * entry > 227 * 1024:
        raise ValueError(f"a grid of {gx} tile columns needs a packed table "
                         f"of {(gx + 1) * entry // 4} KiB in the {blend!r} "
                         f"blend, over one block's 227 KiB of shared memory")
    if x.shape[0] > 65535:
        raise ValueError("at most 65535 planes per launch")
    return _apply_cuda(x.contiguous(), luts.contiguous(), th, tw, blend,
                       sample)


# ---------------------------------------------------------------------------
# public functions (the JAX package's names)
# ---------------------------------------------------------------------------

def _planes_u8(plane: torch.Tensor) -> torch.Tensor:
    h, w = plane.shape[-2], plane.shape[-1]
    x = plane.reshape((-1, h, w))
    return x if x.dtype == torch.uint8 else x.to(torch.uint8)


def _luts_for_plane(x: torch.Tensor, clip_limit: float, gy: int, gx: int):
    n, h, w = x.shape
    pad_h, pad_w, th, tw = pad_plan(h, w, gy, gx)
    xe = _reflect_pad_101(x, pad_h, pad_w)
    area = th * tw
    luts = clahe_tile_luts(xe, gy, gx, clip_count(clip_limit, area),
                           lut_scale(area))
    return luts, th, tw


def compute_tile_luts(plane: torch.Tensor, clip_limit: float = 2.0,
                      grid: tuple = (8, 8)) -> torch.Tensor:
    """(..., H, W) u8-domain plane → (..., gy, gx, 256) uint8 tile LUTs."""
    gy, gx = int(grid[0]), int(grid[1])
    luts, _, _ = _luts_for_plane(_planes_u8(plane), clip_limit, gy, gx)
    return luts.reshape(plane.shape[:-2] + (gy, gx, 256))


def clahe_planar(plane: torch.Tensor, clip_limit: float = 2.0,
                 grid: tuple = (8, 8), blend: str = "cv2") -> torch.Tensor:
    """CLAHE on a (..., H, W) plane with values in [0, 255]; the output
    keeps the input dtype (the counterpart of ``clahe_planar_i32``)."""
    gy, gx = int(grid[0]), int(grid[1])
    x = _planes_u8(plane)
    luts, th, tw = _luts_for_plane(x, clip_limit, gy, gx)
    out = clahe_apply(x, luts, th, tw, blend)
    return out.reshape(plane.shape).to(plane.dtype)


def clahe_planar_sampled(plane: torch.Tensor, plan_y: Plan, plan_x: Plan,
                         clip_limit: float = 2.0, grid: tuple = (8, 8),
                         blend: str = "cv2") -> torch.Tensor:
    """CLAHE with the LUT apply evaluated only at a strided sample grid
    (the counterpart of ``clahe_planar_sampled_i32``).

    The tile LUTs come from the whole plane (K1, padded as
    :func:`pad_plan` says); the apply (K2) runs on the compacted grid
    ``offset + stride·i`` per axis with the full plane's interpolation
    tables at those rows and columns. Bit-equal to
    ``clahe_planar(plane)[..., oy::sy, ox::sx]`` cut to the counts."""
    gy, gx = int(grid[0]), int(grid[1])
    h, w = plane.shape[-2], plane.shape[-1]
    x = _planes_u8(plane)
    luts, th, tw = _luts_for_plane(x, clip_limit, gy, gx)
    (sy, oy, ny), (sx, ox, nx) = plan_y, plan_x
    xs = x[:, oy:oy + sy * ny:sy, ox:ox + sx * nx:sx].contiguous()
    out = clahe_apply(xs, luts, th, tw, blend,
                      sample=(h, w, tuple(plan_y), tuple(plan_x)))
    return out.reshape(plane.shape[:-2] + (ny, nx)).to(plane.dtype)
