"""RT-DETR-L (Lyu et al., arXiv:2304.08069; Ultralytics ``rtdetr-l.yaml``)
forward, plain float32, from the checkpoint's fused weights.

HGNetv2-L backbone (HGStem, four stages of HGBlocks, depthwise
downsamples; taps at /8, /16, /32), the hybrid encoder (AIFI, one
post-norm transformer layer with the 2D sin-cos embedding on the /32
map, then CCFM fusion at 256 channels with RepC3 blocks in their fused
3×3 form) and the decoder: IoU-aware selection of the top ``nq`` encoder
proposals, six layers of self attention, multi-scale deformable cross
attention (8 heads, 3 levels × 4 points, bilinear sampling with zeros
outside the map) and an FFN. GELU is the tanh form. The deformable
sampling counts the distinct value rows its corners read
(``rows_touched``), which the kernel roofline reads.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .params import Params, conv, gelu_tanh, layer_norm, linear

HD, NH, NL, NDP = 256, 8, 3, 4
STAGES = ((48, 128, 3, 1, False), (96, 512, 3, 1, False),
          (192, 1024, 5, 3, True), (384, 2048, 5, 1, True))


def _stem(x: torch.Tensor, p: Params) -> torch.Tensor:
    x = conv(x, p, "backbone.stem.s1", 2, act="relu")
    xp = F.pad(x, (0, 1, 0, 1))
    x2 = conv(F.pad(conv(xp, p, "backbone.stem.s2a", pad=0, act="relu"),
                    (0, 1, 0, 1)), p, "backbone.stem.s2b", pad=0, act="relu")
    x1 = F.max_pool2d(xp, 2, 1)
    x = conv(torch.cat([x1, x2], dim=1), p, "backbone.stem.s3", 2, act="relu")
    return conv(x, p, "backbone.stem.s4", act="relu")


def _hg_block(x: torch.Tensor, p: Params, name: str, light: bool,
              shortcut: bool) -> torch.Tensor:
    ys = [x]
    for i in range(6):
        if light:
            y = conv(ys[-1], p, f"{name}.m.{i}.cv1")
            ys.append(conv(y, p, f"{name}.m.{i}.cv2", act="relu"))
        else:
            ys.append(conv(ys[-1], p, f"{name}.m.{i}.cv", act="relu"))
    y = conv(conv(torch.cat(ys, dim=1), p, f"{name}.sc", act="relu"), p,
             f"{name}.ec", act="relu")
    return y + x if shortcut else y


def backbone(x: torch.Tensor, p: Params):
    y = _stem(x, p)
    taps = []
    for si, (_, _, _, blocks, light) in enumerate(STAGES):
        if si > 0:
            y = conv(y, p, f"backbone.down.{si - 1}", 2)
        for bi in range(blocks):
            y = _hg_block(y, p, f"backbone.stages.{si}.{bi}", light, bi > 0)
        taps.append(y)
    return taps[1], taps[2], taps[3]


def _mha(q, k, v, p: Params, name: str) -> torch.Tensor:
    b, n, _ = q.shape
    dh = HD // NH

    def heads(t, which):
        return linear(t, p, f"{name}.{which}").reshape(b, -1, NH, dh) \
            .transpose(1, 2)

    att = (heads(q, "q") @ heads(k, "k").transpose(-1, -2)) / math.sqrt(dh)
    out = (att.softmax(dim=-1) @ heads(v, "v")).transpose(1, 2) \
        .reshape(b, n, HD)
    return linear(out, p, f"{name}.o")


def _sincos(w: int, h: int, device) -> torch.Tensor:
    """The 2D sin-cos embedding, flattened w-major as the checkpoint's
    training flattened it (equal to h-major on a square map)."""
    grid_w, grid_h = torch.meshgrid(
        torch.arange(w, dtype=torch.float32, device=device),
        torch.arange(h, dtype=torch.float32, device=device), indexing="ij")
    pos_dim = HD // 4
    omega = 1.0 / (10000.0 ** (torch.arange(pos_dim, dtype=torch.float32,
                                            device=device) / pos_dim))
    ow = grid_w.reshape(-1)[:, None] * omega[None]
    oh = grid_h.reshape(-1)[:, None] * omega[None]
    return torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], dim=1)


def _aifi(x: torch.Tensor, p: Params) -> torch.Tensor:
    b, c, h, w = x.shape
    s = x.flatten(2).transpose(1, 2)
    q = s + _sincos(w, h, x.device)[None]
    s = layer_norm(s + _mha(q, q, s, p, "enc.aifi.mha"), p, "enc.aifi.ln1")
    f = linear(gelu_tanh(linear(s, p, "enc.aifi.fc1")), p, "enc.aifi.fc2")
    s = layer_norm(s + f, p, "enc.aifi.ln2")
    return s.transpose(1, 2).reshape(b, c, h, w)


def _repc3(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    y = conv(x, p, f"{name}.cv1", act="silu")
    for i in range(3):
        y = conv(y, p, f"{name}.m.{i}", act="silu")
    return y + conv(x, p, f"{name}.cv2", act="silu")


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def encoder(c3, c4, c5, p: Params) -> List[torch.Tensor]:
    f5 = _aifi(conv(c5, p, "enc.proj5"), p)
    y5 = conv(f5, p, "enc.lat0", act="silu")
    h4 = _repc3(torch.cat([_up2(y5), conv(c4, p, "enc.proj4")], dim=1), p,
                "enc.fpn0")
    y4 = conv(h4, p, "enc.lat1", act="silu")
    p3 = _repc3(torch.cat([_up2(y4), conv(c3, p, "enc.proj3")], dim=1), p,
                "enc.fpn1")
    p4 = _repc3(torch.cat([conv(p3, p, "enc.down0", 2, act="silu"), y4],
                          dim=1), p, "enc.pan0")
    p5 = _repc3(torch.cat([conv(p4, p, "enc.down1", 2, act="silu"), y5],
                          dim=1), p, "enc.pan1")
    return [p3, p4, p5]


def _mlp(x: torch.Tensor, p: Params, name: str, n: int) -> torch.Tensor:
    for i in range(n):
        x = linear(x, p, f"{name}.{i}")
        if i + 1 < n:
            x = F.relu(x)
    return x


def _anchors(shapes, device):
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=device),
                                torch.arange(w, dtype=torch.float32,
                                             device=device), indexing="ij")
        xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)
        wh = torch.full((h, w, 2), 0.05 * 2.0 ** lvl, device=device)
        out.append(torch.cat([xy, wh], -1).reshape(-1, 4))
    a = torch.cat(out)
    valid = ((a > 1e-2) & (a < 1 - 1e-2)).all(dim=-1, keepdim=True)
    a = torch.log(a / (1 - a))
    return torch.where(valid, a, torch.full_like(a, float("inf"))), \
        valid.float()


class RowCounter:
    """Distinct value rows (frame, map row, head) the sampling corners
    read, summed over every call: the bytes a deformable-sampling kernel
    has to read at the least."""

    def __init__(self):
        self.rows = 0
        self.calls = 0


def deform_sample(off, logits, refer, values, shapes,
                  counter: Optional[RowCounter] = None) -> torch.Tensor:
    """off (B, NQ, NH, NL, NDP, 2), logits (B, NQ, NH, NL·NDP), refer
    (B, NQ, 4) sigmoid cxcywh, values (B, ΣHW, NH, dh) → (B, NQ, NH, dh):
    softmax weights over a head's NL·NDP points, each point the bilinear
    sample of its level's map, zero outside."""
    b, nq, nh, nl, ndp, _ = off.shape
    dh = values.shape[-1]
    attw = logits.softmax(dim=-1).reshape(b, nq, nh, nl, ndp)
    loc = refer[:, :, None, None, None, :2] \
        + off / ndp * refer[:, :, None, None, None, 2:] * 0.5
    out = torch.zeros((b, nq, nh, dh), device=off.device)
    start = 0
    keys = []
    for lvl, (hl, wl) in enumerate(shapes):
        v = values[:, start:start + hl * wl]              # (B, HW, NH, dh)
        x = loc[:, :, :, lvl, :, 0] * wl - 0.5             # (B, NQ, NH, NDP)
        y = loc[:, :, :, lvl, :, 1] * hl - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        acc = torch.zeros((b, nq, nh, ndp, dh), device=off.device)
        for dx, dy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                            (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
            row = (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)) \
                .nan_to_num(0.0).long()                   # (B, NQ, NH, NDP)
            heads = torch.arange(nh, device=off.device)[None, None, :, None]
            g = v[torch.arange(b, device=off.device)[:, None, None, None],
                  row, heads.expand_as(row)]       # (B, NQ, NH, NDP, dh)
            acc = acc + g * (wgt * inside)[..., None]
            if counter is not None:
                keys.append(((torch.arange(b, device=off.device)
                              [:, None, None, None] * values.shape[1]
                              + start + row) * nh + heads).reshape(-1))
        out = out + (acc * attw[:, :, :, lvl, :, None]).sum(dim=3)
        start += hl * wl
    if counter is not None and off.device.type != "meta":
        counter.rows += int(torch.unique(torch.cat(keys)).numel())
        counter.calls += 1
    return out


def decoder(feats, p: Params, nq: int,
            counter: Optional[RowCounter] = None):
    """→ (boxes (B, nq, 4) sigmoid cxcywh, class logits (B, nq, nc))."""
    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    memory = torch.cat([conv(f, p, f"dec.input_proj.{i}").flatten(2)
                        .transpose(1, 2) for i, f in enumerate(feats)], dim=1)
    anchors, valid = _anchors(shapes, memory.device)
    fq = layer_norm(linear(memory * valid[None], p, "dec.enc_output.lin"), p,
                    "dec.enc_output.ln")
    scores = linear(fq, p, "dec.enc_score")
    top = torch.sort(scores.max(dim=-1).values, dim=-1, descending=True,
                     stable=True).indices[:, :nq]
    output = torch.gather(fq, 1, top[..., None].expand(-1, -1, HD))
    refer = torch.sigmoid(_mlp(output, p, "dec.enc_bbox", 3) + anchors[top])
    b = output.shape[0]
    for i in range(6):
        name = f"dec.layers.{i}"
        values = linear(memory, p, f"{name}.ca.val").reshape(b, -1, NH,
                                                             HD // NH)
        pos = _mlp(refer, p, "dec.qpos", 2)
        q = output + pos
        output = layer_norm(output + _mha(q, q, output, p, f"{name}.sa"), p,
                            f"{name}.ln1")
        qc = output + pos
        off = linear(qc, p, f"{name}.ca.off").reshape(b, nq, NH, NL, NDP, 2)
        logits = linear(qc, p, f"{name}.ca.attw").reshape(b, nq, NH, NL * NDP)
        ca = deform_sample(off, logits, refer, values, shapes, counter)
        output = layer_norm(output + linear(ca.reshape(b, nq, HD), p,
                                            f"{name}.ca.out"), p,
                            f"{name}.ln2")
        ffn = linear(F.relu(linear(output, p, f"{name}.ffn1")), p,
                     f"{name}.ffn2")
        output = layer_norm(output + ffn, p, f"{name}.ln3")
        delta = _mlp(output, p, f"dec.dec_bbox.{i}", 3)
        r = refer.clamp(0.0, 1.0)
        inv = torch.log(r.clamp(min=1e-5) / (1.0 - r).clamp(min=1e-5))
        refer = torch.sigmoid(delta + inv)
    return refer, linear(output, p, "dec.dec_score.5")


def forward(x_nhwc: torch.Tensor, p: Params, nq: int,
            counter: Optional[RowCounter] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, S, 3) RGB in [0, 1] → (boxes xyxy normalised to [0, 1]
    (B, nq, 4), class probabilities (B, nq, nc))."""
    c3, c4, c5 = backbone(x_nhwc.permute(0, 3, 1, 2).contiguous(), p)
    boxes, logits = decoder(encoder(c3, c4, c5, p), p, nq, counter)
    cxy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1), \
        torch.sigmoid(logits)

