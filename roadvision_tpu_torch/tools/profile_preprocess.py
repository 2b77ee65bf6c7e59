"""Per-stage preprocess profiler — the port of ``tools/profile_preprocess.py``.

    python -m roadvision_tpu_torch.tools.profile_preprocess [--res 720]
        [--batch 4] [--iters 8] [--warmup 2] [--only a,b,...]
        [--out P.json] [--device cuda|cpu]

Times each preprocess stage and the JAX tool's candidate formulations,
one line each: the colour round trip; the three hand-written kernels
(K1 the tile LUTs, K2 the LUT apply, K3 the 3x3 median) and the full
CLAHE (K1 + K2), each beside its plain PyTorch version on the same
device; the histogram variants (a 256-value sweep, a broadcast compare,
one-hot nibble products in bf16 and in int8 with int32 accumulation, a
one-hot product with ones); the apply variants (four gathers with the
"cv2" blend, the band bin-sweep, the packed-word mask sum and the
two-level nibble select); the letterbox hand-off (stack then letterbox,
or slice the planes first); and the median in int16. ``median3:
pallas`` is the K3 line here.

Every candidate is a torch function that computes the same result as
the plain version of its stage; each is checked equal to it on the
device before it is timed, and the tool fails if one is not. The packed
variants compute K2's packed four-tap words (``ops/clahe.py::
packed_taps_plain``), the JAX tool's keep the low byte of them.

Timing: ``utils/profiler.py::time_ms`` — after ``--warmup`` calls,
``--iters`` calls chained between two CUDA events (the host clock on
the CPU, where the numbers are no device figure).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import clahe as C
from ..ops.color import bgr_planes_to_ycrcb_i32, ycrcb_planes_to_bgr_i32
from ..ops.letterbox import _INV_255, axis_plan, letterbox_u8
from ..ops.median import median_planes, median_plain
from ..utils.device import resolve_device
from ..utils.profiler import time_ms
from ..utils.resolutions import res_width

GRID = 8
# bins per step of the packed mask-sum apply (the JAX tool's default)
MAC_BINS = 16


# ---------------------------------------------------------------------------
# histogram candidates: tiles (N, P) uint8 → counts (N, 256) int64
# ---------------------------------------------------------------------------

def hist_plain(t: torch.Tensor) -> torch.Tensor:
    """One bincount over (tile, value) keys."""
    n = t.shape[0]
    keys = torch.arange(n, device=t.device).view(n, 1) * 256 + t.long()
    return torch.bincount(keys.reshape(-1), minlength=n * 256).view(n, 256)


def hist_sweep(t: torch.Tensor) -> torch.Tensor:
    """256 compare-and-count passes, one per value."""
    return torch.stack([(t == v).sum(dim=1) for v in range(256)], dim=1)


def hist_bcast(t: torch.Tensor) -> torch.Tensor:
    """One broadcast compare against all 256 values, reduced."""
    iota = torch.arange(256, device=t.device, dtype=torch.uint8)
    return (t[:, :, None] == iota).sum(dim=1)


def _one_hot(v: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    return (v[..., None] == torch.arange(k, device=v.device,
                                         dtype=v.dtype)).to(dtype)


def _bf16_counts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, P, A) and (N, P, B) bf16 one-hots → (N, A, B) exact counts.
    A bf16 product rounds its output to bf16, which holds integers only
    up to 256: the pixels go in groups of 256, one batched product per
    group, and the groups' counts are summed in int64."""
    n, p, _ = a.shape
    groups = -(-p // 256)
    pad = groups * 256 - p
    a = F.pad(a, (0, 0, 0, pad)).reshape(n * groups, 256, a.shape[-1])
    b = F.pad(b, (0, 0, 0, pad)).reshape(n * groups, 256, b.shape[-1])
    part = torch.bmm(a.transpose(1, 2), b)
    return part.reshape(n, groups, *part.shape[1:]).to(torch.int64).sum(1)


def hist_nibble_bf16(t: torch.Tensor) -> torch.Tensor:
    """count[16·hi + lo] = Σ_p [hi_p = hi][lo_p = lo]: a 16 × 16 product
    of one-hot nibble planes per tile (32 compares a pixel)."""
    hi = _one_hot(t >> 4, 16, torch.bfloat16)
    lo = _one_hot(t & 15, 16, torch.bfloat16)
    return _bf16_counts(hi, lo).reshape(t.shape[0], 256)


def hist_nibble_int8(t: torch.Tensor) -> torch.Tensor:
    """The nibble product with int8 one-hots and int32 accumulation
    (``torch._int_mm``, one per tile; its rows padded to 32 and its
    pixels to a multiple of 8, as the int8 product asks)."""
    n, p = t.shape
    pp = p + (-p % 8)
    hi = F.pad(_one_hot(t >> 4, 16, torch.int8), (0, 0, 0, pp - p))
    lo = F.pad(_one_hot(t & 15, 16, torch.int8), (0, 0, 0, pp - p))
    out = torch.empty((n, 16, 16), dtype=torch.int64, device=t.device)
    a = torch.zeros((32, pp), dtype=torch.int8, device=t.device)
    for i in range(n):
        a[:16] = hi[i].t()
        out[i] = torch._int_mm(a, lo[i].contiguous())[:16]
    return out.reshape(n, 256)


def hist_onehot_dot(t: torch.Tensor) -> torch.Tensor:
    """Ones (1, P) times the (P, 256) bf16 one-hot, per tile."""
    oh = _one_hot(t, 256, torch.bfloat16)
    ones = torch.ones(oh.shape[:2] + (1,), dtype=torch.bfloat16,
                      device=t.device)
    return _bf16_counts(ones, oh).reshape(t.shape[0], 256)


HIST = {"hist: fori sweep": hist_sweep,
        "hist: broadcast reduce": hist_bcast,
        "hist: nibble 16x16 matmul": hist_nibble_bf16,
        "hist: nibble int8 matmul": hist_nibble_int8,
        "hist: onehot matmul": hist_onehot_dot}


# ---------------------------------------------------------------------------
# apply candidates: plane (N, H, W) uint8, LUTs (N, gy, gx, 256) uint8
# ---------------------------------------------------------------------------

def _coords(size: int, tile: int, tiles: int, device):
    i1, i2, frac = C._interp_coords(size, tile, tiles)
    return (torch.from_numpy(i1).long().to(device),
            torch.from_numpy(i2).long().to(device),
            torch.from_numpy(frac).to(device))


def _bands(h: int, th: int, gy: int):
    """Maximal runs of rows with one pair of tile rows: (y0, y1, t1, t2)."""
    ty1, ty2, _ = C._interp_coords(h, th, gy)
    bands, s = [], 0
    for y in range(1, h + 1):
        if y == h or ty1[y] != ty1[s] or ty2[y] != ty2[s]:
            bands.append((s, y, int(ty1[s]), int(ty2[s])))
            s = y
    return bands


def _blend(l11, l12, l21, l22, xa, ya):
    """The "cv2" blend: every multiply and add rounded on its own."""
    top = l11 * (1 - xa) + l12 * xa
    bot = l21 * (1 - xa) + l22 * xa
    res = top * (1 - ya) + bot * ya
    return torch.round(res).clamp_(0, 255).to(torch.uint8)


def apply_gather(x: torch.Tensor, luts: torch.Tensor, th: int,
                 tw: int) -> torch.Tensor:
    """Four gathers from the flat LUTs, then the blend."""
    n, h, w = x.shape
    gy, gx = luts.shape[1], luts.shape[2]
    ty1, ty2, ya = _coords(h, th, gy, x.device)
    tx1, tx2, xa = _coords(w, tw, gx, x.device)
    flat = luts.reshape(n, -1)
    v = x.long()

    def gather(tyi, txi):
        idx = (tyi.view(h, 1) * gx + txi.view(1, w)) * 256 + v
        return torch.gather(flat, 1, idx.reshape(n, -1)) \
            .view(n, h, w).float()

    return _blend(gather(ty1, tx1), gather(ty1, tx2), gather(ty2, tx1),
                  gather(ty2, tx2), xa.view(1, 1, w), ya.view(1, h, 1))


def apply_band_sweep(x: torch.Tensor, luts: torch.Tensor, th: int,
                     tw: int) -> torch.Tensor:
    """Gather-free: the x-blended table of every tile row by one-hot
    products, then per band of rows a select over all 256 values."""
    n, h, w = x.shape
    gy, gx = luts.shape[1], luts.shape[2]
    tx1, tx2, xa = _coords(w, tw, gx, x.device)
    _, _, ya = _coords(h, th, gy, x.device)
    m1 = F.one_hot(tx1, gx).float()                   # (w, gx)
    m2 = F.one_hot(tx2, gx).float()
    lf = luts.float()
    bx1 = torch.einsum("wk,bgkv->bgwv", m1, lf)
    bx2 = torch.einsum("wk,bgkv->bgwv", m2, lf)
    xw = xa.view(1, 1, w, 1)
    top_tab = bx1 * (1 - xw) + bx2 * xw               # (b, gy, w, 256)
    out = []
    for y0, y1, t1, t2 in _bands(h, th, gy):
        vals = x[:, y0:y1]
        yab = ya[y0:y1].view(1, -1, 1)
        acc = torch.zeros(vals.shape, dtype=torch.float32, device=x.device)
        for v in range(256):
            term = top_tab[:, t1, None, :, v] * (1 - yab) \
                + top_tab[:, t2, None, :, v] * yab
            acc = torch.where(vals == v, term, acc)
        out.append(acc)
    return torch.round(torch.cat(out, dim=1)).clamp_(0, 255) \
        .to(torch.uint8)


def _packed_band_tables(x, luts, th, tw):
    """Per band, the packed words l11 | l12<<8 | l21<<16 | l22<<24 of
    every (column, value), (b, w, 256) int64, by one-hot products."""
    n, h, w = x.shape
    gy, gx = luts.shape[1], luts.shape[2]
    tx1, tx2, _ = _coords(w, tw, gx, x.device)
    m1 = F.one_hot(tx1, gx).double()
    m2 = F.one_hot(tx2, gx).double()
    lf = luts.double()
    for y0, y1, t1, t2 in _bands(h, th, gy):
        lp = lf[:, t1] + 65536.0 * lf[:, t2]          # (b, gx, 256)
        e1 = torch.einsum("wk,bkv->bwv", m1, lp).long()
        e2 = torch.einsum("wk,bkv->bwv", m2, lp).long()
        yield y0, y1, e1 + e2 * 256


def apply_mask_mac(x: torch.Tensor, luts: torch.Tensor, th: int,
                   tw: int) -> torch.Tensor:
    """The packed words by a masked sum over chunks of MAC_BINS values
    (exactly one value matches a pixel, so the sum is the select)."""
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    iota = torch.arange(MAC_BINS, device=x.device)
    for y0, y1, packed in _packed_band_tables(x, luts, th, tw):
        vals = x[:, y0:y1].long()
        acc = torch.zeros(vals.shape, dtype=torch.int64, device=x.device)
        for v0 in range(0, 256, MAC_BINS):
            m = vals[..., None] == (v0 + iota)
            chunk = packed[:, None, :, v0:v0 + MAC_BINS]
            acc = acc + torch.where(m, chunk, 0).sum(dim=-1)
        out[:, y0:y1] = acc
    return out


def apply_nibble(x: torch.Tensor, luts: torch.Tensor, th: int,
                 tw: int) -> torch.Tensor:
    """The packed words by a two-level select: 16 low-nibble masks built
    once, then per high nibble a masked sum over its 16 entries."""
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    i16 = torch.arange(16, device=x.device)
    for y0, y1, packed in _packed_band_tables(x, luts, th, tw):
        vals = x[:, y0:y1].long()
        hi = vals >> 4
        lo_oh = (vals & 15)[..., None] == i16
        acc = torch.zeros(vals.shape, dtype=torch.int64, device=x.device)
        for hv in range(16):
            sub = packed[:, None, :, hv * 16:(hv + 1) * 16]
            part = torch.where(lo_oh, sub, 0).sum(dim=-1)
            acc = acc + torch.where(hi == hv, part, 0)
        out[:, y0:y1] = acc
    return out


def packed_words_plain(x, luts, th, tw) -> torch.Tensor:
    """The four taps packed into one word, from the plain gathers."""
    l11, l12, l21, l22 = (t.long() for t in C.lut_taps(x, luts, th, tw))
    return l11 | (l12 << 8) | (l21 << 16) | (l22 << 24)


# ---------------------------------------------------------------------------
# letterbox hand-off and median
# ---------------------------------------------------------------------------

def lb_stack(pb, pg, pr, size: int = 640) -> torch.Tensor:
    """Stack the planes into a full-size frame, then letterbox it."""
    return letterbox_u8(torch.stack((pb, pg, pr), dim=-1), size=size)[0]


def lb_planar(pb, pg, pr, size: int = 640) -> Optional[torch.Tensor]:
    """Slice the planes first and stack at the target size: for an exact
    odd-stride downscale (1080p → 640 is stride 3) only, else None."""
    b, h, w = pb.shape
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    py, px = axis_plan(h, nh), axis_plan(w, nw)
    if py[0] != "slice" or px[0] != "slice":
        return None
    small = [p[:, py[2]::py[1], px[2]::px[1]][:, :nh, :nw].float()
             for p in (pr, pg, pb)]                     # RGB order
    x = torch.stack(small, dim=-1)
    top, left = int(round((size - nh) / 2 - 0.1)), \
        int(round((size - nw) / 2 - 0.1))
    x = F.pad(x, (0, 0, left, size - nw - left, top, size - nh - top),
              value=114.0)
    return x * _INV_255


def med_int16(x: torch.Tensor) -> torch.Tensor:
    """The plain 3×3 network on int16 planes."""
    return median_plain(x.to(torch.int16), 3).to(torch.uint8)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _equal(a, b) -> bool:
    return a is not None and b is not None and a.shape == b.shape \
        and bool(torch.equal(a, b))


def run(args) -> Dict[str, dict]:
    """Every selected line: {name: {"ms", "calls", plus "plain_ms" and
    "equal" where the line has a plain version}}."""
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, b = args.res, args.batch
    w = res_width(h)
    gy = gx = GRID
    th, tw = h // gy, w // gx
    # inputs from one seeded numpy generator, as the JAX tool draws them
    rng = np.random.RandomState(0)

    def rand_u8(*shape):
        return torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)) \
            .to(device)

    frames = rand_u8(b, h, w, 3)
    plane = rand_u8(b, h, w)
    luts = rand_u8(b, gy, gx, 256)
    tiles = rand_u8(b * gy * gx, th * tw)
    planes3 = tuple(rand_u8(b, h, w) for _ in range(3))
    table = rand_u8(b, gy * gx * 256)
    idx = torch.from_numpy(rng.randint(0, gy * gx * 256, (b, h * w))) \
        .to(device)
    keys = torch.from_numpy(rng.randint(0, b * gy * gx * 256,
                                        (b * h * w,))).to(device)
    want = set(args.only.split(",")) if args.only else None
    rows: Dict[str, dict] = {}
    failures: List[str] = []

    def timed(name: str, fn: Callable, plain: Optional[Callable] = None,
              check: Optional[Callable] = None) -> None:
        """Time ``fn``; with ``plain``, hold fn() equal to plain() (or
        ``check(got, want)``) first and time plain too."""
        row = {"calls": args.warmup + args.iters}
        with torch.inference_mode():
            if plain is not None:
                got, ref = fn(), plain()
                row["calls"] += 1
                row["equal"] = (check or _equal)(got, ref)
                if not row["equal"]:
                    failures.append(name)
                row["plain_ms"] = time_ms(plain, device, args.iters,
                                          args.warmup)
            row["ms"] = time_ms(fn, device, args.iters, args.warmup)
        rows[name] = row
        extra = "" if plain is None else \
            f"  plain {row['plain_ms']:9.3f} ms  equal={row['equal']}"
        print(f"[profile] {name:32s} {row['ms']:9.3f} ms{extra}",
              flush=True)

    def sel(key: str) -> bool:
        return want is None or key in want

    print(f"[profile] device={device} res={h}p batch={b}", flush=True)
    if sel("gather"):
        timed("micro: gather 16K-table", lambda: torch.gather(
            table, 1, idx).sum(dtype=torch.int64))
    if sel("scatter"):
        timed("micro: bincount scatter", lambda: torch.bincount(
            keys, minlength=b * gy * gx * 256).sum())
    if sel("color"):
        def color_rt():
            pl = frames.permute(3, 0, 1, 2)
            return torch.stack(ycrcb_planes_to_bgr_i32(
                *bgr_planes_to_ycrcb_i32(*pl)), dim=-1)
        timed("color: ycrcb roundtrip", color_rt)
    pad_h, pad_w, pth, ptw = C.pad_plan(h, w, gy, gx)
    xe = C._reflect_pad_101(plane, pad_h, pad_w)
    clip = C.clip_count(2.0, pth * ptw)
    scale = C.lut_scale(pth * ptw)
    if sel("clahe"):
        timed("clahe: full (K1 + K2)",
              lambda: C.clahe_planar(plane, 2.0, (gy, gx)),
              lambda: C.apply_plain(
                  plane, C.tile_luts_plain(xe, gy, gx, clip, scale), pth,
                  ptw))
    if sel("hist"):
        timed("clahe: hist+lut (K1)",
              lambda: C.clahe_tile_luts(xe, gy, gx, clip, scale),
              lambda: C.tile_luts_plain(xe, gy, gx, clip, scale))
    for key, (name, fn) in zip(("histsweep", "histbcast", "histnib",
                                "histi8", "histdot"), HIST.items()):
        if sel(key):
            timed(name, lambda fn=fn: fn(tiles), lambda: hist_plain(tiles))
    applies = (("apply", "apply: 4-gather", apply_gather, C.apply_plain),
               ("applysweep", "apply: band bin-sweep", apply_band_sweep,
                C.apply_plain),
               ("applymac", f"apply: mask-MAC chunk{MAC_BINS}",
                apply_mask_mac, packed_words_plain),
               ("applynib", "apply: nibble two-level", apply_nibble,
                packed_words_plain),
               ("applypack", "apply: K2 clahe_apply", C.clahe_apply,
                C.apply_plain))
    for key, name, fn, plain in applies:
        if sel(key):
            timed(name, lambda fn=fn: fn(plane, luts, th, tw),
                  lambda plain=plain: plain(plane, luts, th, tw))
    if sel("lbstack"):
        timed("letterbox: stack u8 then slice", lambda: lb_stack(*planes3))
    if sel("lbplanar"):
        if lb_planar(*planes3) is None:
            print(f"[profile] letterbox: planar slice first  skipped: "
                  f"{h}p -> 640 is not an odd-stride downscale",
                  flush=True)
        else:
            timed("letterbox: planar slice first",
                  lambda: lb_planar(*planes3), lambda: lb_stack(*planes3))
    med_in = frames.permute(3, 0, 1, 2).reshape(-1, h, w).contiguous()
    if sel("medpallas"):
        timed("median3: K3 median_k", lambda: median_planes(med_in, 3),
              lambda: median_plain(med_in, 3))
    if sel("medjnp"):
        timed("median3: plain planar", lambda: median_plain(med_in, 3))
    if sel("medi16"):
        timed("median3: plain planar int16", lambda: med_int16(med_in),
              lambda: median_plain(med_in, 3))
    if failures:
        raise RuntimeError(f"candidates differ from their plain version: "
                           f"{failures}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=720)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8,
                    help="calls chained between the two timing events")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--only", type=str, default="",
                    help="comma list of: gather, scatter, color, clahe, "
                         "hist, histsweep, histbcast, histnib, histi8, "
                         "histdot, apply, applysweep, applymac, applynib, "
                         "applypack, lbstack, lbplanar, medpallas, medjnp, "
                         "medi16")
    ap.add_argument("--out", default=None, help="write the lines as JSON")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    rows = run(args)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")
        print(f"[profile] wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
