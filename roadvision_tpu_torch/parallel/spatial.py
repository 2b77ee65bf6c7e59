"""Spatial partitioning: ONE frame's rows in bands over the devices — the
counterpart of ``roadvision_tpu/parallel/spatial.py``.

JAX shards the image's H axis over the mesh and GSPMD inserts the halo
exchanges. Here they are written out, for YOLOv8:

  * bands start on 32-row boundaries, so every pyramid level holds whole
    rows; the remainder of 32-row cells goes to the last bands, and a
    device left with no cell holds no band;
  * before a k × k conv of stride s and padding p a band takes p rows
    from the bands above and k − s − p from the bands below (1 and 1 for
    3 × 3 / s1, 1 and 0 for 3 × 3 / s2); before each of SPPF's 5 × 5 max
    pools, 2 and 2; the rows may come from more than one neighbour when
    bands are one row deep;
  * zero padding (−inf for the pools) applies only at the frame's true
    top and bottom: a band's conv pads its columns alone;
  * 1 × 1 convs, the nearest × 2 upsample, concat and add are local;
  * the detect head's per-level outputs are gathered on the first band's
    device in band order, which keeps the row-major anchor order, so the
    DFL decode and the anchors see the whole frame's layout.

Every output element's reduction is the single-device one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from ..models.yolo.yolov8 import _up2, decode
from .pipeline import v8_detect_model
from .sharding import Mesh, replicated

CELL = 32          # the deepest level's stride: a band's row granularity


class Bands:
    """One NHWC frame batch's rows in bands: ``parts[i]`` holds rows
    ``starts[i]`` onwards on ``devices[i]``, which is entry ``slots[i]``
    of the mesh axis' device list."""

    def __init__(self, parts: List[torch.Tensor], starts: List[int],
                 slots: List[int]):
        self.parts, self.starts, self.slots = parts, starts, slots

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]


def _axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    return [row[0] for row in mesh.grid] if axis == "data" \
        else list(mesh.grid[0])


def spatial_sharding(mesh: Mesh, x: torch.Tensor,
                     axis: str = "data") -> Bands:
    """(B, H, W, C) with H a multiple of 32 → its rows in bands over the
    devices of ``mesh[axis]`` (32-row cells spread evenly, the remainder
    to the last bands; devices without a cell skipped)."""
    devs = _axis_devices(mesh, axis)
    h = x.shape[1]
    if h % CELL:
        raise ValueError(f"frame height {h} is not a multiple of {CELL} "
                         f"(letterbox it first)")
    base, rem = divmod(h // CELL, len(devs))
    parts, starts, slots = [], [], []
    row = 0
    for i, dev in enumerate(devs):
        rows = CELL * (base + (i >= len(devs) - rem))
        if rows:
            parts.append(x[:, row:row + rows].to(dev, non_blocking=True))
            starts.append(row)
            slots.append(i)
            row += rows
    return Bands(parts, starts, slots)


# a banded NCHW tensor is a list of per-band tensors; a banded module is
# a function of the band index returning that band's replica of it
Banded = List[torch.Tensor]
Mod = Callable[[int], Any]


def _with_halo(ts: Banded, i: int, top: int, bottom: int,
               fill: float) -> torch.Tensor:
    """Band i with ``top`` rows of the bands above and ``bottom`` of the
    bands below, ``fill`` beyond the frame; in the band's memory format
    (channels-last, as the whole frame's activations are), so that each
    conv runs the single-device forward's algorithm."""
    dev, ref = ts[i].device, ts[i]
    fmt = torch.channels_last if ref.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format
    above, below = [], []
    need, j = top, i - 1
    while need and j >= 0:
        t = ts[j][:, :, max(0, ts[j].shape[2] - need):]
        above.insert(0, t.to(dev, non_blocking=True))
        need, j = need - t.shape[2], j - 1
    if need:
        above.insert(0, ref.new_full((ref.shape[0], ref.shape[1], need,
                                      ref.shape[3]), fill)
                     .contiguous(memory_format=fmt))
    need, j = bottom, i + 1
    while need and j < len(ts):
        t = ts[j][:, :, :need]
        below.append(t.to(dev, non_blocking=True))
        need, j = need - t.shape[2], j + 1
    if need:
        below.append(ref.new_full((ref.shape[0], ref.shape[1], need,
                                   ref.shape[3]), fill)
                     .contiguous(memory_format=fmt))
    return torch.cat(above + [ref] + below, dim=2).contiguous(
        memory_format=fmt)


def _conv(m: Mod, ts: Banded) -> Banded:
    conv = m(0)
    k, s, p = conv.weight.shape[-1], conv.stride, conv.pad
    if k == 1:
        return [m(i)(t) for i, t in enumerate(ts)]
    return [m(i)(_with_halo(ts, i, p, k - s - p, 0.0), pad=(0, p))
            for i in range(len(ts))]


def _pool(ts: Banded) -> Banded:
    return [F.max_pool2d(_with_halo(ts, i, 2, 2, float("-inf")), 5, 1,
                         (0, 2)) for i in range(len(ts))]


def _cat(*lists: Banded) -> Banded:
    return [torch.cat(xs, dim=1) for xs in zip(*lists)]


def _c2f(m: Mod, ts: Banded) -> Banded:
    y = _conv(lambda i: m(i).cv1, ts)
    parts = [[t.chunk(2, dim=1)[0] for t in y], [t.chunk(2, dim=1)[1]
                                                 for t in y]]
    for k in range(len(m(0).m)):
        h = _conv(lambda i: m(i).m[k].cv2,
                  _conv(lambda i: m(i).m[k].cv1, parts[-1]))
        parts.append([a + b for a, b in zip(parts[-1], h)]
                     if m(0).shortcut else h)
    return _conv(lambda i: m(i).cv2, _cat(*parts))


def _sppf(m: Mod, ts: Banded) -> Banded:
    y = _conv(lambda i: m(i).cv1, ts)
    y1 = _pool(y)
    y2 = _pool(y1)
    y3 = _pool(y2)
    return _conv(lambda i: m(i).cv2, _cat(y, y1, y2, y3))


def _branch(m: Mod, ts: Banded) -> Banded:
    for k in range(len(m(0))):
        ts = _conv(lambda i: m(i)[k], ts)
    return ts


def banded_forward(layers: Sequence[Any], bands: Bands,
                   dtype: torch.dtype, nc: int):
    """The YOLOv8 forward over the bands, ``layers[i]`` the ``layers``
    ModuleDict on band i's device → (boxes, scores) on the first band's
    device."""
    L = lambda key: (lambda i: layers[i][key])  # noqa: E731
    x = [p.permute(0, 3, 1, 2).to(dtype) for p in bands.parts]
    y = _conv(L("1"), _conv(L("0"), x))
    y = _c2f(L("2"), y)
    p3 = _c2f(L("4"), _conv(L("3"), y))
    p4 = _c2f(L("6"), _conv(L("5"), p3))
    y = _c2f(L("8"), _conv(L("7"), p4))
    p5 = _sppf(L("9"), y)
    h4 = _c2f(L("12"), _cat([_up2(t) for t in p5], p4))
    out3 = _c2f(L("15"), _cat([_up2(t) for t in h4], p3))
    out4 = _c2f(L("18"), _cat(_conv(L("16"), out3), h4))
    out5 = _c2f(L("21"), _cat(_conv(L("19"), out4), p5))
    home = bands.devices[0]
    head = L("22")
    outs = []
    for lvl, f in enumerate((out3, out4, out5)):
        b = _branch(lambda i: head(i).cv2[lvl], f)
        c = _branch(lambda i: head(i).cv3[lvl], f)
        outs.append((torch.cat([t.to(home) for t in b], dim=2),
                     torch.cat([t.to(home) for t in c], dim=2)))
    return decode(outs, nc)


def make_spatial_forward(size: str, nc: int, mesh: Mesh,
                         axis: str = "data", dtype=torch.float32):
    """``run(params, x)``: the YOLOv8 forward of the JAX-layout tree
    ``params`` with the frame's rows in bands over ``mesh[axis]``
    (:func:`spatial_sharding`); x (B, H, W, 3) float in [0, 1], H a
    multiple of 32 → (boxes (B, N, 4), scores (B, N, nc)) on the first
    band's device. The model is replicated once per distinct device and
    kept for the next call with the same tree."""
    kept: Dict[str, Any] = {}

    @torch.inference_mode()
    def run(params, x):
        if kept.get("params") is not params:
            model = v8_detect_model(params, size, nc, dtype)
            kept.update(params=params, on=dict(zip(
                mesh.devices, replicated(mesh, model))))
        bands = spatial_sharding(mesh, torch.as_tensor(x), axis)
        return banded_forward([kept["on"][d].layers for d in bands.devices],
                              bands, dtype, nc)

    return run
