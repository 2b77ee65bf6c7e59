"""RT-DETR-L as ``nn.Module``s — the port of
``roadvision_tpu/models/rtdetr.py``.

The same model: an HGNetv2-L backbone (HGStem, four stages of HGBlocks,
depthwise downsamples; taps at /8, /16, /32), the hybrid encoder (AIFI,
one post-norm transformer layer with the 2D sincos embedding on the /32
map, then CCFM fusion at 256 channels with RepC3 blocks stored in their
fused deploy form) and the deformable decoder (the top ``num_queries``
encoder proposals, ``decoder_layers`` refinement layers of self
attention, multi-scale deformable cross attention and an FFN). No NMS:
suppression is learned.

Precision as the JAX functions lay it out:

  * :class:`Conv` (``_conv`` :88) casts its input to the weight's dtype,
    adds the bias and the activation in f32 and casts back; with
    ``act=None`` it returns f32, so the backbone's downsample convs and
    the encoder's ``proj*`` hand f32 on. :meth:`RTDETR.set_compute_dtype`
    casts the backbone's and the encoder's conv weights; the decoder,
    its ``input_proj`` convs included, stays f32 on every path.
  * AIFI runs in f32 and its output is cast to the compute dtype (on
    the int8 path in f64, rounded once: see :class:`AIFI`).
  * GELU is the tanh form (``jax.nn.gelu``'s default).
  * The deformable sampling (:func:`deform_attn`) is the JAX 4-corner
    gather in the same order, per level and per corner, accumulated in
    f32; ``bf16_vals`` casts the value maps to bf16 before the gathers
    (on unless ``RVT_RTDETR_BF16_VALS=0`` at import, overridden by the
    argument), ``RVT_RTDETR_PAIRED_GATHERS=1`` gathers the four corners
    of a level at once. Both environment variables are read once, at
    import, as the JAX module reads them. Serving samples through
    ``ops/deform.py::deform_sample`` (K7 on the card); training through
    its plain version, since K7 has no backward yet.
  * The encoder's top-k is a stable descending sort: equal scores keep
    the lower index first, as ``jax.lax.top_k`` does.

Tensors are NCHW inside, the input NHWC viewed as NCHW (channels-last in
memory). State-dict keys mirror the JAX parameter tree: JAX
``"backbone.stem.s1.w"`` (HWIO) is ``"backbone.stem.s1.weight"`` (OIHW)
here, linear ``"w"`` (in, out) is ``"weight"`` (out, in) and layer norm
``"g"`` is ``"weight"`` (:func:`params_from_tree`, :func:`tree_from_model`).

Checkpoints: the ultralytics ``rtdetr-l.pt`` layout (conv + BatchNorm and
RepConv branches fused, :func:`state_dict_to_params_rtdetr`), a raw
state-dict ``.npz``, or the repo's own pytree ``.npz``
(:func:`load_params_rtdetr`); a missing file runs a seeded random init
(:func:`random_model`; the numbers differ from ``jax.random``'s).
"""
from __future__ import annotations

import math
import os
from pathlib import Path
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.activations import gelu
from ..ops.deform import deform_sample, deform_sample_plain
from .yolo import weights as yw
from .yolo.yolov8 import Conv as _YoloConv

_BF16_VALS = os.environ.get("RVT_RTDETR_BF16_VALS", "1") == "1"
_PAIRED_GATHERS = os.environ.get("RVT_RTDETR_PAIRED_GATHERS", "0") == "1"

HD = 256          # hidden dim
NQ = 300          # queries
NH = 8            # attention heads
NDP = 4           # deformable sampling points per level
NDL = 6           # decoder layers
D_FFN = 1024      # decoder FFN dim
AIFI_FFN = 1024   # AIFI FFN dim
NL = 3            # feature levels (/8, /16, /32)

# HGNetv2-L stage table: (cm, c2, k, n_blocks, lightconv)
_L_STAGES = (
    (48, 128, 3, 1, False),
    (96, 512, 3, 1, False),
    (192, 1024, 5, 3, True),
    (384, 2048, 5, 1, True),
)
_L_STEM = (32, 48)   # (cm, c2)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

_ACTS = {"relu": F.relu, "silu": F.silu, "gelu": gelu}


class Conv(_YoloConv):
    """``_conv``: Conv(+bias)(+activation), autopad k//2 unless ``pad``
    is given, groups inferred from the widths. ``act`` is "relu" (the
    default), "silu", "gelu" or None; with None the output is f32, else
    the input's compute dtype. A subclass of the YOLO ``Conv``, so
    ``quant.quantize_model_`` swaps it for a ``QConv``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 act: Optional[str] = "relu", groups: int = 1,
                 pad: Optional[int] = None):
        super().__init__(cin, cout, k, stride, act=act, groups=groups,
                         pad=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        y = F.conv2d(x, self.weight, None, self.stride, self.pad, 1,
                     x.shape[1] // self.weight.shape[1])
        y = y.float() + self.bias[:, None, None]
        if self.act is None:
            return y
        return _ACTS[self.act](y).to(x.dtype)


def mlp(x: torch.Tensor, layers: Sequence[nn.Linear]) -> torch.Tensor:
    """``_mlp``: linear stack with ReLU between (none after the last)."""
    for i, lin in enumerate(layers):
        x = lin(x)
        if i + 1 < len(layers):
            x = F.relu(x)
    return x


class MHA(nn.Module):
    """``_mha``: multi-head attention with separate q/k/v/out
    projections, f32 math."""

    def __init__(self, dim: int = HD):
        super().__init__()
        self.q, self.k, self.v, self.o = (nn.Linear(dim, dim)
                                          for _ in range(4))

    def forward(self, q, k, v):
        b, n, _ = q.shape
        dh = HD // NH
        qh = self.q(q).reshape(b, -1, NH, dh).transpose(1, 2)
        kh = self.k(k).reshape(b, -1, NH, dh).transpose(1, 2)
        vh = self.v(v).reshape(b, -1, NH, dh).transpose(1, 2)
        att = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
        out = (att.softmax(dim=-1) @ vh).transpose(1, 2).reshape(b, n, HD)
        return self.o(out)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _ln(dim: int = HD) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------

class HGStem(nn.Module):
    """``_hg_stem`` :317: the 2 × 2 stride-1 max runs over the map padded
    right and bottom by one zero."""

    def __init__(self):
        super().__init__()
        cm, c2 = _L_STEM
        self.s1 = Conv(3, cm, 3, 2)
        self.s2a = Conv(cm, cm // 2, 2, pad=0)
        self.s2b = Conv(cm // 2, cm, 2, pad=0)
        self.s3 = Conv(cm * 2, cm, 3, 2)
        self.s4 = Conv(cm, c2, 1)

    def forward(self, x):
        x = self.s1(x)
        xp = F.pad(x, (0, 1, 0, 1))
        x2 = self.s2b(F.pad(self.s2a(xp), (0, 1, 0, 1)))
        x1 = F.max_pool2d(xp, 2, 1)
        return self.s4(self.s3(torch.cat([x1, x2], dim=1)))


class HGBlock(nn.Module):
    """``_hg_block`` :331: six light (1×1 then depthwise) or plain convs,
    their concatenation squeezed (``sc``) and excited (``ec``)."""

    def __init__(self, c1: int, cm: int, c2: int, k: int, n: int,
                 light: bool, shortcut: bool):
        super().__init__()
        self.m = nn.ModuleList()
        for i in range(n):
            cin = c1 if i == 0 else cm
            if light:
                self.m.append(nn.ModuleDict({
                    "cv1": Conv(cin, cm, 1, act=None),
                    "cv2": Conv(cm, cm, k, groups=cm)}))
            else:
                self.m.append(nn.ModuleDict({"cv": Conv(cin, cm, k)}))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1)
        self.ec = Conv(c2 // 2, c2, 1)
        self.light, self.shortcut = light, shortcut

    def forward(self, x):
        ys = [x]
        for m in self.m:
            ys.append(m["cv2"](m["cv1"](ys[-1])) if self.light
                      else m["cv"](ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, dim=1)))
        return y + x if self.shortcut else y


class HGNet(nn.Module):
    """``hgnet_forward`` :345: (B, 3, H, W) → (c3 /8, c4 /16, c5 /32)."""

    def __init__(self):
        super().__init__()
        self.stem = HGStem()
        self.stages = nn.ModuleList()
        self.down = nn.ModuleList()
        cin = _L_STEM[1]
        for si, (scm, sc2, k, n_blocks, light) in enumerate(_L_STAGES):
            if si > 0:
                self.down.append(Conv(cin, cin, 3, 2, act=None, groups=cin))
            self.stages.append(nn.ModuleList(
                HGBlock(cin if bi == 0 else sc2, scm, sc2, k, 6, light,
                        bi > 0) for bi in range(n_blocks)))
            cin = sc2

    def forward(self, x):
        y = self.stem(x)
        taps = []
        for si, blocks in enumerate(self.stages):
            if si > 0:
                y = self.down[si - 1](y)
            for blk in blocks:
                y = blk(y)
            taps.append(y)
        return taps[1], taps[2], taps[3]


# ---------------------------------------------------------------------------
# hybrid encoder
# ---------------------------------------------------------------------------

def sincos_pe(w: int, h: int, dim: int = HD, temp: float = 10000.0,
              device=None, dtype=torch.float32) -> torch.Tensor:
    """``_sincos_pe`` :362, with its w-major flatten (the features are
    h-major; on a square map the two coincide)."""
    gw = torch.arange(w, dtype=dtype, device=device)
    gh = torch.arange(h, dtype=dtype, device=device)
    grid_w, grid_h = torch.meshgrid(gw, gh, indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temp ** (torch.arange(pos_dim, dtype=dtype,
                                         device=device) / pos_dim))
    out_w = grid_w.reshape(-1)[:, None] * omega[None]
    out_h = grid_h.reshape(-1)[:, None] * omega[None]
    return torch.cat([torch.sin(out_w), torch.cos(out_w),
                      torch.sin(out_h), torch.cos(out_h)], dim=1)


class AIFI(nn.Module):
    """``_aifi`` :378: a post-norm transformer encoder layer on the
    flattened /32 map, in its parameters' dtype: f32, as in JAX, or f64
    on the int8 path (``RTDETRTorch``), where the layer sits between
    quantised convs and its result is rounded once to f32, so that the
    card and the CPU hand ``lat0`` the same activations to quantise."""

    def __init__(self):
        super().__init__()
        self.mha = MHA()
        self.ln1, self.ln2 = _ln(), _ln()
        self.fc1 = nn.Linear(HD, AIFI_FFN)
        self.fc2 = nn.Linear(AIFI_FFN, HD)
        self._pos: Dict[tuple, torch.Tensor] = {}

    def pos_embed(self, w: int, h: int, c: int, device,
                  dtype) -> torch.Tensor:
        """:func:`sincos_pe` for a (w, h) map, built once per shape,
        device and dtype, outside inference mode (training reads it
        too)."""
        key = (w, h, c, str(device), dtype)
        pos = self._pos.get(key)
        if pos is None:
            with torch.inference_mode(False), torch.no_grad():
                pos = self._pos[key] = sincos_pe(w, h, c, device=device,
                                                 dtype=dtype)
        return pos

    def forward(self, x):
        b, c, h, w = x.shape
        dt = self.fc1.weight.dtype
        s = x.flatten(2).transpose(1, 2).to(dt)
        pos = self.pos_embed(w, h, c, x.device, dt)
        q = s + pos[None]
        s = self.ln1(s + self.mha(q, q, s))
        s = self.ln2(s + self.fc2(gelu(self.fc1(s))))
        return s.transpose(1, 2).reshape(b, c, h, w).float()


class RepC3(nn.Module):
    """``_repc3`` :390, the RepConv blocks in their fused 3×3 form."""

    def __init__(self, c1: int, c2: int, n: int = 3):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, act="silu")
        self.cv2 = Conv(c1, c2, 1, act="silu")
        self.m = nn.ModuleList(Conv(c2, c2, 3, act="silu") for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        for m in self.m:
            y = m(y)
        return y + self.cv2(x)


def up2(x: torch.Tensor) -> torch.Tensor:
    """``_up2`` :397: nearest × 2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class HybridEncoder(nn.Module):
    """``encoder_forward`` :401: AIFI + CCFM → [p3, p4, p5], HD wide."""

    def __init__(self):
        super().__init__()
        c3ch, c4ch, c5ch = (_L_STAGES[i][1] for i in (1, 2, 3))
        self.proj5 = Conv(c5ch, HD, 1, act=None)
        self.proj4 = Conv(c4ch, HD, 1, act=None)
        self.proj3 = Conv(c3ch, HD, 1, act=None)
        self.aifi = AIFI()
        self.lat0 = Conv(HD, HD, 1, act="silu")
        self.fpn0 = RepC3(2 * HD, HD)
        self.lat1 = Conv(HD, HD, 1, act="silu")
        self.fpn1 = RepC3(2 * HD, HD)
        self.down0 = Conv(HD, HD, 3, 2, act="silu")
        self.pan0 = RepC3(2 * HD, HD)
        self.down1 = Conv(HD, HD, 3, 2, act="silu")
        self.pan1 = RepC3(2 * HD, HD)
        self.compute_dtype = torch.float32

    def forward(self, c3, c4, c5):
        f5 = self.aifi(self.proj5(c5)).to(self.compute_dtype)
        y5 = self.lat0(f5)
        h4 = self.fpn0(torch.cat([up2(y5), self.proj4(c4)], dim=1))
        y4 = self.lat1(h4)
        p3 = self.fpn1(torch.cat([up2(y4), self.proj3(c3)], dim=1))
        p4 = self.pan0(torch.cat([self.down0(p3), y4], dim=1))
        p5 = self.pan1(torch.cat([self.down1(p4), y5], dim=1))
        return [p3, p4, p5]


# ---------------------------------------------------------------------------
# deformable decoder
# ---------------------------------------------------------------------------

class DeformAttn(nn.Module):
    """The parameters of one multi-scale deformable attention
    (``ca``: offsets, attention weights, value and output projections);
    :func:`deform_attn` is the computation."""

    def __init__(self):
        super().__init__()
        self.off = nn.Linear(HD, NH * NL * NDP * 2)
        self.attw = nn.Linear(HD, NH * NL * NDP)
        self.val = nn.Linear(HD, HD)
        self.out = nn.Linear(HD, HD)


def deform_attn(p: DeformAttn, query: torch.Tensor, refer_sig: torch.Tensor,
                values, shapes: Sequence[Tuple[int, int]],
                bf16_vals: Optional[bool] = None,
                sample: Optional[Callable[..., torch.Tensor]] = None
                ) -> torch.Tensor:
    """``_deform_attn`` :422. query (B, NQ, HD); refer_sig (B, NQ, 4)
    sigmoid-space cxcywh; values the level-concatenated (B, ΣHl·Wl, NH,
    dh) value tensor (or a per-level list); shapes [(Hl, Wl)]. The
    offsets and attention-weight linears, the sampling and the output
    linear. ``sample`` is the sampling, with
    ``ops/deform.py::deform_sample``'s arguments; by default that
    wrapper (K7 on the card, the plain 4-corner gathers on the CPU; zero
    outside the map, weights and sums in f32)."""
    sample = deform_sample if sample is None else sample
    use_bf16 = _BF16_VALS if bf16_vals is None else bf16_vals
    b, nq, _ = query.shape
    off = p.off(query).reshape(b, nq, NH, NL, NDP, 2)
    logits = p.attw(query).reshape(b, nq, NH, NL * NDP)
    V = torch.cat(list(values), dim=1) \
        if isinstance(values, (list, tuple)) else values
    out = sample(off, logits, refer_sig, V, shapes, bf16_vals=use_bf16,
                 paired=_PAIRED_GATHERS)
    return p.out(out.reshape(b, nq, HD))


def anchors_for(shapes: Sequence[Tuple[int, int]], grid_size: float = 0.05,
                eps: float = 1e-2, device=None):
    """``_anchors_for`` :509: logit-space anchor priors per level grid
    (inf where invalid) and the (N, 1) validity mask."""
    anchors = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing="ij")
        # divided by the level's sides as Python numbers: a (w, h) tensor
        # built from a list would be one host upload (and sync) a level
        xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)
        wh = torch.full((h, w, 2), grid_size * (2.0 ** lvl),
                        dtype=torch.float32, device=device)
        anchors.append(torch.cat([xy, wh], -1).reshape(-1, 4))
    a = torch.cat(anchors, dim=0)
    valid = ((a > eps) & (a < 1 - eps)).all(dim=-1, keepdim=True)
    a = torch.log(a / (1 - a))
    a = torch.where(valid, a, torch.full_like(a, float("inf")))
    return a, valid.to(torch.float32)


def topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last dim, descending, equal
    values in index order (``jax.lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class DecoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.sa = MHA()
        self.ln1 = _ln()
        self.ca = DeformAttn()
        self.ln2 = _ln()
        self.ffn1 = nn.Linear(HD, D_FFN)
        self.ffn2 = nn.Linear(D_FFN, HD)
        self.ln3 = _ln()


def _bbox_head() -> nn.ModuleList:
    return nn.ModuleList([nn.Linear(HD, HD), nn.Linear(HD, HD),
                          nn.Linear(HD, 4)])


class Decoder(nn.Module):
    """``decoder_forward`` :527 (inference form): [p3, p4, p5] →
    (boxes (B, nq, 4) sigmoid cxcywh, score logits (B, nq, nc)), all f32.
    ``num_queries`` decodes the top-N encoder proposals (clamped to the
    anchor total), ``decoder_layers`` the first K layers and reads layer
    K's heads."""

    def __init__(self, nc: int = 80):
        super().__init__()
        self.input_proj = nn.ModuleList(Conv(HD, HD, 1, act=None)
                                        for _ in range(NL))
        self.layers = nn.ModuleList(DecoderLayer() for _ in range(NDL))
        self.enc_output = nn.ModuleDict({"lin": nn.Linear(HD, HD),
                                         "ln": _ln()})
        self.enc_score = nn.Linear(HD, nc)
        self.enc_bbox = _bbox_head()
        self.dec_score = nn.ModuleList(nn.Linear(HD, nc) for _ in range(NDL))
        self.dec_bbox = nn.ModuleList(_bbox_head() for _ in range(NDL))
        self.qpos = nn.ModuleList([nn.Linear(4, 2 * HD),
                                   nn.Linear(2 * HD, HD)])
        self._anchors: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def anchors(self, shapes: Sequence[Tuple[int, int]], device):
        """:func:`anchors_for` the level shapes, built once per shapes and
        device, outside inference mode (training reads them too)."""
        key = (tuple(shapes), str(device))
        got = self._anchors.get(key)
        if got is None:
            with torch.inference_mode(False), torch.no_grad():
                got = self._anchors[key] = anchors_for(shapes, device=device)
        return got

    def select(self, feats, num_queries: Optional[int] = None):
        """IoU-aware query selection → (memory (B, ΣHW, HD), level shapes,
        class logits per anchor (B, ΣHW, nc), the top-nq anchor indices
        (B, nq), their features (B, nq, HD), their box logits (B, nq, 4),
        the anchor prior added: sigmoid gives cxcywh)."""
        shapes = [(f.shape[2], f.shape[3]) for f in feats]
        memory = torch.cat([proj(f).flatten(2).transpose(1, 2)
                            for proj, f in zip(self.input_proj, feats)],
                           dim=1).float()
        anchors, valid = self.anchors(shapes, memory.device)
        feats_q = self.enc_output["ln"](
            self.enc_output["lin"](memory * valid[None]))
        scores = self.enc_score(feats_q)
        nq = min(NQ if num_queries is None else int(num_queries),
                 memory.shape[1])
        topk = topk_stable(scores.max(dim=-1).values, nq)   # (B, nq)
        output = torch.gather(feats_q, 1, topk[..., None].expand(-1, -1, HD))
        refer_logit = mlp(output, self.enc_bbox) + anchors[topk]
        return memory, shapes, scores, topk, output, refer_logit

    def proposals(self, feats, num_queries: Optional[int] = None):
        """:meth:`select` with the top class logit per anchor (B, ΣHW) and
        the boxes as sigmoid cxcywh (B, nq, 4)."""
        memory, shapes, scores, topk, output, refer_logit = self.select(
            feats, num_queries)
        return memory, shapes, scores.max(dim=-1).values, topk, output, \
            torch.sigmoid(refer_logit)

    def refine(self, i: int, memory, shapes, output, refer,
               bf16_vals: Optional[bool], sample=None):
        """Decoder layer ``i`` → (its output, its refined boxes);
        ``sample`` as :func:`deform_attn` takes it."""
        lp = self.layers[i]
        values = lp.ca.val(memory).reshape(output.shape[0], -1, NH, HD // NH)
        pos = mlp(refer, self.qpos)
        q = output + pos
        output = lp.ln1(output + lp.sa(q, q, output))
        ca = deform_attn(lp.ca, output + pos, refer, values, shapes,
                         bf16_vals=bf16_vals, sample=sample)
        output = lp.ln2(output + ca)
        output = lp.ln3(output + lp.ffn2(F.relu(lp.ffn1(output))))
        delta = mlp(output, self.dec_bbox[i])
        return output, torch.sigmoid(delta + inverse_sigmoid(refer))

    def forward(self, feats, num_queries: Optional[int] = None,
                decoder_layers: Optional[int] = None,
                bf16_vals: Optional[bool] = None, sample=None):
        """The serving decoder → (boxes sigmoid cxcywh (B, nq, 4), class
        logits (B, nq, nc)); ``sample`` as :func:`deform_attn` takes it
        (default the K7 wrapper)."""
        memory, shapes, _, _, output, refer = self.proposals(feats,
                                                             num_queries)
        n = len(self.layers)
        if decoder_layers is not None:
            n = max(1, min(int(decoder_layers), n))
        for i in range(n):
            output, refer = self.refine(i, memory, shapes, output, refer,
                                        bf16_vals, sample)
        return refer, self.dec_score[n - 1](output)

    def forward_train(self, feats) -> Dict[str, Any]:
        """``decoder_forward(train=True)`` :584-615 → the aux dict of the
        set-prediction loss: the encoder's top-nq boxes (sigmoid cxcywh)
        and score logits, and every decoder layer's. The first query
        features and reference boxes are detached, each layer's refined
        box is detached before it feeds the next, and the deformable
        sampling reads f32 values (``bf16_vals=False``). The sampling is
        :func:`~roadvision_tpu_torch.ops.deform.deform_sample_plain` on
        every device: K7 has no backward yet."""
        memory, shapes, scores, topk, output, refer_logit = self.select(
            feats)
        aux: Dict[str, Any] = {
            "enc_boxes": torch.sigmoid(refer_logit),
            "enc_scores": torch.gather(
                scores, 1, topk[..., None].expand(-1, -1, scores.shape[-1])),
            "boxes": [], "scores": []}
        output = output.detach()
        refer = torch.sigmoid(refer_logit.detach())
        for i in range(len(self.layers)):
            output, refined = self.refine(i, memory, shapes, output, refer,
                                          False, deform_sample_plain)
            aux["boxes"].append(refined)
            aux["scores"].append(self.dec_score[i](output))
            refer = refined.detach()
        return aux


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class RTDETR(nn.Module):
    """``forward_rtdetr_raw`` :626: (B, H, W, 3) float [0, 1] → (boxes
    xyxy normalised to [0, 1] (B, nq, 4), scores (B, nq, nc) sigmoid
    probabilities). Top-level children carry the JAX tree's names."""

    def __init__(self, nc: int = 80):
        super().__init__()
        self.nc = nc
        self.backbone = HGNet()
        self.enc = HybridEncoder()
        self.dec = Decoder(nc)
        self.compute_dtype = torch.float32

    def set_compute_dtype(self, dtype: torch.dtype) -> "RTDETR":
        """Cast the backbone's and the encoder's conv weights to ``dtype``
        (biases stay f32); the decoder stays f32."""
        self.compute_dtype = self.enc.compute_dtype = dtype
        for part in (self.backbone, self.enc):
            for m in part.modules():
                if isinstance(m, Conv):
                    m.weight.data = m.weight.data.to(dtype)
                    m.bias.data = m.bias.data.float()
        return self

    def features(self, x_nhwc: torch.Tensor):
        """The backbone and the encoder: NHWC input → [p3, p4, p5]."""
        c3, c4, c5 = self.backbone(
            x_nhwc.permute(0, 3, 1, 2).to(self.compute_dtype))
        return self.enc(c3, c4, c5)

    def forward(self, x_nhwc: torch.Tensor, num_queries: Optional[int] = None,
                decoder_layers: Optional[int] = None,
                bf16_vals: Optional[bool] = None):
        boxes, logits = self.dec(self.features(x_nhwc), num_queries,
                                 decoder_layers, bf16_vals)
        return box_xyxy(boxes), torch.sigmoid(logits)

    def forward_train(self, x_nhwc: torch.Tensor) -> Dict[str, Any]:
        """``forward_rtdetr_train`` :649: the decoder's aux dict
        (:meth:`Decoder.forward_train`) for models/rtdetr_train.py."""
        return self.dec.forward_train(self.features(x_nhwc))


def box_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """Sigmoid-space cxcywh → xyxy."""
    cxy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)


# ---------------------------------------------------------------------------
# parameter tree ↔ module
# ---------------------------------------------------------------------------

def params_from_tree(tree) -> Dict[str, torch.Tensor]:
    """A tree in the JAX package's layout → the port's state dict: conv
    kernels HWIO → OIHW, linears (in, out) → (out, in), layer norm
    ``g`` → ``weight``."""
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in yw.flatten_tree(tree).items():
        stem, leaf = key.rsplit(".", 1)
        arr = np.asarray(arr, dtype=np.float32)
        if leaf == "w":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            leaf = "weight"
        elif leaf == "g":
            leaf = "weight"
        elif leaf == "b":
            leaf = "bias"
        sd[f"{stem}.{leaf}"] = torch.from_numpy(np.array(arr, order="C"))
    return sd


def tree_from_model(model: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`params_from_tree` for a float model."""
    return tree_from_state_dict(model.state_dict())


def tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors keyed by the model's parameter names (its state dict, its
    gradients, an optimiser's moments) → the JAX-layout tree."""
    flat = {}
    for key, t in sd.items():
        stem, leaf = key.rsplit(".", 1)
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf = "g" if arr.ndim == 1 else "w"
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
        elif leaf == "bias":
            leaf = "b"
        flat[f"{stem}.{leaf}"] = np.ascontiguousarray(arr)
    return yw.unflatten_tree(flat)


def nc_of(tree) -> int:
    """The class count: the encoder score head's width."""
    return int(np.asarray(tree["dec"]["enc_score"]["b"]).shape[0])


def model_from_params(tree) -> RTDETR:
    model = RTDETR(nc_of(tree))
    model.load_state_dict(params_from_tree(tree))
    return model


def _deform_offset_init() -> torch.Tensor:
    """The canonical MSDeformAttn offset bias (``_deform_offset_init``):
    eight unit directions, scaled per point ring."""
    theta = torch.arange(NH, dtype=torch.float32) * (2.0 * math.pi / NH)
    grid = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    grid = grid / grid.abs().amax(dim=-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, NL, NDP, 1)
    scale = torch.arange(1, NDP + 1, dtype=torch.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


def random_model(nc: int = 80, seed: int = 0) -> RTDETR:
    """Seeded init by ``init_params_rtdetr``'s recipe (:229): He-normal
    convs, uniform ±√(1/cin) linears (zero where the JAX recipe zeroes
    them), unit layer norms, normal √(1/dim) attention projections, the
    canonical offset bias and the 0.01-prior score bias. The numbers
    differ from ``jax.random``'s."""
    model = RTDETR(nc)
    gen = torch.Generator().manual_seed(int(seed))
    dec = model.dec
    zero = {id(lp.ca.off) for lp in dec.layers} \
        | {id(lp.ca.attw) for lp in dec.layers} \
        | {id(h[2]) for h in [dec.enc_bbox, *dec.dec_bbox]}
    mhas = [m for m in model.modules() if isinstance(m, MHA)]
    mha_lins = {id(lin) for m in mhas for lin in (m.q, m.k, m.v, m.o)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                cout, cin, k, _ = m.weight.shape
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * math.sqrt(2.0 / (cin * k * k)))
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                cin = m.weight.shape[1]
                if id(m) in zero:
                    m.weight.zero_()
                elif id(m) in mha_lins:
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   * math.sqrt(1.0 / cin))
                else:
                    bound = math.sqrt(1.0 / cin)
                    m.weight.copy_(torch.rand(m.weight.shape, generator=gen)
                                   * (2 * bound) - bound)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for lp in dec.layers:
            lp.ca.off.bias.copy_(_deform_offset_init())
        bias_cls = float(-math.log((1 - 0.01) / 0.01))
        for head in [dec.enc_score, *dec.dec_score]:
            head.bias.fill_(bias_cls)
    return model


# ---------------------------------------------------------------------------
# checkpoint import (ultralytics ``rtdetr-l.pt`` state-dict layout)
# ---------------------------------------------------------------------------
# Index map after the "model." strip (rtdetr.py:661-671):
#   0 HGStem · 1/3/5/6/7/9 HGBlocks · 2/4/8 DWConv downsamples
#   10 input_proj /32 · 11 AIFI · 12 lateral Y5 · 14 input_proj /16
#   16/21/24/27 RepC3 (fpn0/fpn1/pan0/pan1) · 17 lateral Y4
#   19 input_proj /8 · 22/25 downsample convs · 28 RTDETRDecoder.
# BN eps: the ultralytics ``Conv`` 1e-3 (weights.BN_EPS); the decoder's
# raw ``nn.BatchNorm2d`` input_proj the torch default 1e-5.

_SD_ENC_CONVS = (("10", "proj5", None), ("12", "lat0", "silu"),
                 ("14", "proj4", None), ("17", "lat1", "silu"),
                 ("19", "proj3", None), ("22", "down0", "silu"),
                 ("25", "down1", "silu"))
_SD_REPC3 = (("16", "fpn0"), ("21", "fpn1"), ("24", "pan0"), ("27", "pan1"))
_SD_HGBLOCKS = (("1", 0, 0), ("3", 1, 0), ("5", 2, 0), ("6", 2, 1),
                ("7", 2, 2), ("9", 3, 0))   # (sd idx, stage, block)


def _lin_t(sd, prefix: str) -> Dict[str, np.ndarray]:
    """torch nn.Linear (out, in) → {"w": (in, out), "b"}."""
    w = yw._to_np(sd[f"{prefix}.weight"]).astype(np.float32)
    b = (yw._to_np(sd[f"{prefix}.bias"]).astype(np.float32)
         if f"{prefix}.bias" in sd else np.zeros(w.shape[0], np.float32))
    return {"w": np.ascontiguousarray(w.T), "b": b}


def _ln_t(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"g": yw._to_np(sd[f"{prefix}.weight"]).astype(np.float32),
            "b": yw._to_np(sd[f"{prefix}.bias"]).astype(np.float32)}


def _mha_t(sd, prefix: str) -> Dict[str, Any]:
    """torch nn.MultiheadAttention → separate q/k/v/o projections."""
    w = yw._to_np(sd[f"{prefix}.in_proj_weight"]).astype(np.float32)
    b = yw._to_np(sd[f"{prefix}.in_proj_bias"]).astype(np.float32)
    d = w.shape[1]
    out: Dict[str, Any] = {
        name: {"w": np.ascontiguousarray(w[i * d:(i + 1) * d].T),
               "b": b[i * d:(i + 1) * d].copy()}
        for i, name in enumerate(("q", "k", "v"))}
    out["o"] = _lin_t(sd, f"{prefix}.out_proj")
    return out


def _convbn_t(sd, conv_prefix: str, bn_prefix: str,
              eps: float) -> Dict[str, np.ndarray]:
    """A raw Conv2d (no bias) + BatchNorm2d pair → HWIO weight + bias."""
    w = yw._to_np(sd[f"{conv_prefix}.weight"]).astype(np.float64)
    gamma = yw._to_np(sd[f"{bn_prefix}.weight"]).astype(np.float64)
    beta = yw._to_np(sd[f"{bn_prefix}.bias"]).astype(np.float64)
    mean = yw._to_np(sd[f"{bn_prefix}.running_mean"]).astype(np.float64)
    var = yw._to_np(sd[f"{bn_prefix}.running_var"]).astype(np.float64)
    scale = gamma / np.sqrt(var + eps)
    return {"w": (w * scale[:, None, None, None]).transpose(2, 3, 1, 0)
            .astype(np.float32),
            "b": (beta - mean * scale).astype(np.float32)}


def _rep_fuse(sd, prefix: str) -> Dict[str, np.ndarray]:
    """RepConv deploy fusion: the BN-fused 3×3 branch plus the zero-padded
    BN-fused 1×1 branch, one 3×3 conv."""
    c3 = yw._fuse(sd, f"{prefix}.conv1")
    c1 = yw._fuse(sd, f"{prefix}.conv2")
    return {"w": c3["w"] + np.pad(c1["w"], ((1, 1), (1, 1), (0, 0), (0, 0))),
            "b": c3["b"] + c1["b"]}


def _repc3_t(sd, i: str) -> Dict[str, Any]:
    out = {"cv1": yw._fuse(sd, f"{i}.cv1"), "cv2": yw._fuse(sd, f"{i}.cv2"),
           "m": []}
    j = 0
    while True:
        if f"{i}.m.{j}.conv1.conv.weight" in sd:        # training form
            out["m"].append(_rep_fuse(sd, f"{i}.m.{j}"))
        elif f"{i}.m.{j}.conv.weight" in sd:            # already fused
            out["m"].append(yw._fuse(sd, f"{i}.m.{j}"))
        else:
            break
        j += 1
    if not out["m"]:
        # cv1/cv2 without inner blocks would run and be silently wrong
        raise KeyError(f"{i}.m.0.conv1.conv.weight")
    return out


def state_dict_to_params_rtdetr(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Ultralytics RT-DETR state dict → the parameter tree (deploy form),
    numpy float32 leaves (``state_dict_to_params_rtdetr`` :760)."""
    sd = yw._normalize_keys(sd)
    fuse = yw._fuse
    bk: Dict[str, Any] = {"stem": {
        "s1": fuse(sd, "0.stem1"), "s2a": fuse(sd, "0.stem2a"),
        "s2b": fuse(sd, "0.stem2b"), "s3": fuse(sd, "0.stem3"),
        "s4": fuse(sd, "0.stem4")}}
    stages: List[List] = [[] for _ in _L_STAGES]
    for idx, si, bi in _SD_HGBLOCKS:
        light = _L_STAGES[si][4]
        m = []
        j = 0
        while (f"{idx}.m.{j}.conv.weight" in sd
               or f"{idx}.m.{j}.conv1.conv.weight" in sd):
            if light:
                m.append({"cv1": fuse(sd, f"{idx}.m.{j}.conv1"),
                          "cv2": fuse(sd, f"{idx}.m.{j}.conv2")})
            else:
                m.append({"cv": fuse(sd, f"{idx}.m.{j}")})
            j += 1
        if bi != len(stages[si]):
            raise KeyError(f"{idx}: HGBlock import out of order")
        stages[si].append({"m": m, "sc": fuse(sd, f"{idx}.sc"),
                           "ec": fuse(sd, f"{idx}.ec")})
    bk["stages"] = stages
    bk["down"] = [fuse(sd, i) for i in ("2", "4", "8")]

    enc: Dict[str, Any] = {
        "aifi": {"mha": _mha_t(sd, "11.ma"),
                 "ln1": _ln_t(sd, "11.norm1"), "ln2": _ln_t(sd, "11.norm2"),
                 "fc1": _lin_t(sd, "11.fc1"), "fc2": _lin_t(sd, "11.fc2")}}
    for idx, name, _act in _SD_ENC_CONVS:
        enc[name] = fuse(sd, idx)
    for idx, name in _SD_REPC3:
        enc[name] = _repc3_t(sd, idx)

    d = "28"
    layers = []
    for i in range(NDL):
        li = f"{d}.decoder.layers.{i}"
        layers.append({
            "sa": _mha_t(sd, f"{li}.self_attn"),
            "ln1": _ln_t(sd, f"{li}.norm1"),
            "ca": {"off": _lin_t(sd, f"{li}.cross_attn.sampling_offsets"),
                   "attw": _lin_t(sd, f"{li}.cross_attn.attention_weights"),
                   "val": _lin_t(sd, f"{li}.cross_attn.value_proj"),
                   "out": _lin_t(sd, f"{li}.cross_attn.output_proj")},
            "ln2": _ln_t(sd, f"{li}.norm2"),
            "ffn1": _lin_t(sd, f"{li}.linear1"),
            "ffn2": _lin_t(sd, f"{li}.linear2"),
            "ln3": _ln_t(sd, f"{li}.norm3"),
        })
    dec = {
        "input_proj": [_convbn_t(sd, f"{d}.input_proj.{lv}.0",
                                 f"{d}.input_proj.{lv}.1", eps=1e-5)
                       for lv in range(NL)],
        "layers": layers,
        "enc_output": {"lin": _lin_t(sd, f"{d}.enc_output.0"),
                       "ln": _ln_t(sd, f"{d}.enc_output.1")},
        "enc_score": _lin_t(sd, f"{d}.enc_score_head"),
        "enc_bbox": [_lin_t(sd, f"{d}.enc_bbox_head.layers.{j}")
                     for j in range(3)],
        "dec_score": [_lin_t(sd, f"{d}.dec_score_head.{i}")
                      for i in range(NDL)],
        "dec_bbox": [[_lin_t(sd, f"{d}.dec_bbox_head.{i}.layers.{j}")
                      for j in range(3)] for i in range(NDL)],
        "qpos": [_lin_t(sd, f"{d}.query_pos_head.layers.{j}")
                 for j in range(2)],
    }
    return {"backbone": bk, "enc": enc, "dec": dec}


def is_rtdetr_npz(path) -> bool:
    """True when ``path`` is an exported RT-DETR pytree ``.npz`` (top keys
    ``Lbackbone…``): a renamed file still dispatches here."""
    p = Path(path)
    if p.suffix != ".npz" or not p.exists():
        return False
    try:
        with np.load(p) as z:
            return any(k.startswith("Lbackbone") for k in z.files)
    except Exception:
        return False


def load_params_rtdetr(path_or_sd, nc: int = 80, seed: int = 0):
    """(params, nc, loaded) from a live state dict, an ultralytics
    ``.pt``, a raw state-dict ``.npz`` or the repo's pytree ``.npz``
    (float16 storage read as float32); else a seeded random init. The
    checkpoint's class count overrides the ``nc`` hint."""
    sd = None
    if isinstance(path_or_sd, Mapping) and path_or_sd:
        sd = path_or_sd
    elif isinstance(path_or_sd, (str, Path)):
        p = Path(path_or_sd)
        if p.exists():
            if p.suffix == ".npz":
                with np.load(p) as z:
                    keys = list(z.files)
                if keys and all(k.startswith("L") for k in keys):
                    params = yw.import_npz(p)
                    try:
                        return params, nc_of(params), True
                    except KeyError as exc:
                        # a pytree of another family in an rtdetr file
                        print(f"[roadvision] .npz is not an rtdetr pytree "
                              f"({exc}); using random init")
                else:
                    with np.load(p) as z:
                        sd = {k: z[k] for k in z.files}
            else:
                sd = yw._load_torch(p)
    if sd is not None:
        try:
            params = state_dict_to_params_rtdetr(sd)
            return params, nc_of(params), True
        except KeyError as exc:
            print(f"[roadvision] rtdetr checkpoint key mismatch ({exc}); "
                  f"using random init")
    return tree_from_model(random_model(nc, seed)), nc, False
