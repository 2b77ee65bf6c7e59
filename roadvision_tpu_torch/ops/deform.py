"""Multi-scale deformable-attention sampling: plain PyTorch plus two CUDA
kernels, the forward and its backward.

The part of ``roadvision_tpu/models/rtdetr.py::_deform_attn`` (:439-505)
between the attention-weight / offset linears and the output linear:
the softmax over a (query, head)'s NL·NDP logits, the sampling
locations ``ctr + off / NDP · wh · 0.5``, and per level the bilinear
sample of the value map by four corner gathers (zero outside the map,
``grid_sample`` with ``align_corners=False``), weighted and summed in
f32. ``models/rtdetr.py::deform_attn`` runs the two linears, this, and
the output linear.

:func:`deform_sample_plain` is the plain version, the JAX function's
arithmetic op for op in both of its gather formulations
(``RVT_RTDETR_PAIRED_GATHERS``: a gather a corner, or the four corners
of a level in one). K7 (``csrc/deform.cu``) computes the same function
in one launch. Its gradient, what ``jax.value_and_grad`` takes through
it in ``roadvision_tpu/models/rtdetr_train.py:263``, is K8 (the same
file); :func:`deform_sample_backward_plain` is K8's plain version,
autograd through the plain forward. :class:`DeformSample` puts the two
kernels behind one ``torch.autograd.Function``. :func:`deform_sample`
runs the plain version for a CPU tensor (autograd takes its gradient);
for a CUDA tensor it launches K7, through :class:`DeformSample` where
gradients are enabled and an input requires them, so that the backward
launches K8. Nothing falls back to the plain version on the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..kernels import _build

MAX_LEVELS = 4          # csrc/deform.cu
HEAD_DIM = 32           # a lane a channel
MODES = {(torch.float32, False): 0, (torch.float32, True): 1,
         (torch.bfloat16, False): 2, (torch.bfloat16, True): 2}


def deform_sample_plain(off: torch.Tensor, logits: torch.Tensor,
                        refer: torch.Tensor, values: torch.Tensor,
                        shapes: Sequence[Tuple[int, int]],
                        bf16_vals: bool = False,
                        paired: bool = False) -> torch.Tensor:
    """off (B, NQ, NH, NL, NDP, 2), logits (B, NQ, NH, NL·NDP), refer
    (B, NQ, 4) sigmoid-space cxcywh, values (B, ΣHl·Wl, NH, dh) → the
    sampled (B, NQ, NH, dh) f32. ``bf16_vals`` rounds each level's values
    to bf16 before its gathers; ``paired`` gathers a level's four corners
    at once (the same outputs)."""
    b, nq, nh, nl, ndp, _ = off.shape
    dh = values.shape[-1]
    attw = logits.softmax(dim=-1).reshape(b, nq, nh, nl, ndp)
    ctr = refer[:, :, None, None, None, :2]
    wh = refer[:, :, None, None, None, 2:]
    loc = ctr + off / ndp * wh * 0.5
    offs = [0]
    for hl, wl in shapes:
        offs.append(offs[-1] + hl * wl)
    out = torch.zeros((b, nq, nh, dh), dtype=torch.float32,
                      device=off.device)
    for lvl, (hl, wl) in enumerate(shapes):
        v = values[:, offs[lvl]:offs[lvl + 1]]
        if bf16_vals:
            v = v.to(torch.bfloat16)
        lo = loc[:, :, :, lvl]                    # (B, NQ, NH, NDP, 2)
        x = lo[..., 0] * wl - 0.5
        y = lo[..., 1] * hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        corners = ((0, 0, (1 - fx) * (1 - fy)),
                   (1, 0, fx * (1 - fy)),
                   (0, 1, (1 - fx) * fy),
                   (1, 1, fx * fy))
        idxs, wgts = [], []
        for dx, dy, wgt in corners:
            xi = x0 + dx
            yi = y0 + dy
            inb = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
            # a NaN location (a non-finite batch in training) reads row 0
            # with a NaN weight, where the int cast would leave the map
            idx = (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)) \
                .nan_to_num(0.0).to(torch.int64)
            # (B, NQ, NH, NDP) → gather rows of the flattened map
            idxs.append(idx.transpose(2, 3).reshape(b, nq * ndp, nh))
            wgts.append(wgt * inb)
        if paired:
            idx4 = torch.cat(idxs, dim=1)             # (B, 4·NQ·NDP, NH)
            g4 = torch.gather(v, 1, idx4[..., None].expand(-1, -1, -1, dh))
            g4 = g4.reshape(b, 4, nq, ndp, nh, dh) \
                .permute(1, 0, 2, 4, 3, 5).float()
            w4 = torch.stack(wgts)                    # (4, B, NQ, NH, NDP)
            acc = (g4 * w4[..., None]).sum(dim=0)
        else:
            acc = torch.zeros((b, nq, nh, ndp, dh), dtype=torch.float32,
                              device=off.device)
            for idxt, wgt in zip(idxs, wgts):
                g = torch.gather(v, 1, idxt[..., None].expand(-1, -1, -1, dh))
                g = g.reshape(b, nq, ndp, nh, dh).transpose(2, 3).float()
                acc = acc + g * wgt[..., None]
        out = out + (acc * attw[:, :, :, lvl, :, None]).sum(dim=3)
    return out


def deform_sample_backward_plain(grad_out: torch.Tensor, off: torch.Tensor,
                                 logits: torch.Tensor, refer: torch.Tensor,
                                 values: torch.Tensor,
                                 shapes: Sequence[Tuple[int, int]]
                                 ) -> Tuple[torch.Tensor, ...]:
    """K8's plain version: (g_off, g_logits, g_refer, g_values), the
    gradients of :func:`deform_sample_plain` (f32 values,
    ``bf16_vals=False``, a gather a corner) at these inputs for the
    output gradient ``grad_out`` (B, NQ, NH, dh), as
    ``torch.autograd.grad`` takes them. Works inside inference mode too
    (it differentiates copies)."""
    with torch.inference_mode(False), torch.enable_grad():
        ins = [t.detach().clone().requires_grad_(True)
               for t in (off, logits, refer, values)]
        out = deform_sample_plain(*ins, shapes)
        return tuple(torch.autograd.grad(out, ins, grad_out))


def _check(off, logits, refer, values, shapes) -> None:
    if off.dim() != 6 or off.shape[-1] != 2:
        raise ValueError(f"expected off (B, NQ, NH, NL, NDP, 2), got "
                         f"{tuple(off.shape)}")
    b, nq, nh, nl, ndp, _ = off.shape
    if tuple(logits.shape) != (b, nq, nh, nl * ndp) \
            or tuple(refer.shape) != (b, nq, 4) or values.dim() != 4 \
            or values.shape[0] != b or values.shape[2] != nh \
            or len(shapes) != nl:
        raise ValueError(
            f"deform_sample: logits {tuple(logits.shape)}, refer "
            f"{tuple(refer.shape)}, values {tuple(values.shape)} and "
            f"{len(shapes)} levels do not fit off {tuple(off.shape)}")
    rows = sum(int(hl) * int(wl) for hl, wl in shapes)
    if values.shape[1] != rows:
        raise ValueError(f"deform_sample: values hold {values.shape[1]} "
                         f"rows, the levels {list(shapes)} {rows}")


def _level_args(off, values, shapes, what: str) -> list:
    """The kernels' level arguments (h0, w0, …, h3, w3), after checking
    the sizes they take: at most MAX_LEVELS levels, 32 points and
    HEAD_DIM channels a head."""
    nl, ndp = off.shape[3], off.shape[4]
    if nl > MAX_LEVELS or nl * ndp > 32 or values.shape[-1] != HEAD_DIM:
        raise ValueError(f"{what} takes at most {MAX_LEVELS} levels, 32 "
                         f"points a head and {HEAD_DIM} channels a head, "
                         f"got {nl} x {ndp} and {values.shape[-1]}")
    return [int(v) for s in shapes for v in s] + [0] * 2 * (MAX_LEVELS - nl)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address: the kernels read
    value rows and the output gradient 16 bytes a lane (a copy only for
    a view that starts off the boundary)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _sample_cuda(off, logits, refer, values, shapes,
                 bf16_vals: bool) -> torch.Tensor:
    b, nq, nh, nl, ndp, _ = off.shape
    hw = _level_args(off, values, shapes, "deform_sample")
    mode = MODES.get((values.dtype, bool(bf16_vals)))
    if mode is None or any(t.dtype != torch.float32
                           for t in (off, logits, refer)):
        raise ValueError(f"deform_sample takes float32 offsets, logits and "
                         f"boxes and float32 or bfloat16 values, got "
                         f"{off.dtype}, {logits.dtype}, {refer.dtype}, "
                         f"{values.dtype}")
    off, logits, refer = (t.contiguous() for t in (off, logits, refer))
    values = _aligned(values)
    out = torch.empty((b, nq, nh, HEAD_DIM), dtype=torch.float32,
                      device=off.device)
    lib = _build.load("deform")
    with torch.cuda.device(off.device):
        code = lib.rvt_deform_sample(
            off.data_ptr(), logits.data_ptr(), refer.data_ptr(),
            values.data_ptr(), out.data_ptr(), b, nq, nh, values.shape[1],
            nl, ndp, *hw, mode, _build.stream_ptr(off))
    _build.launch_counts["deform_sample"] += 1
    _build.check(code, "deform_sample")
    return out


def _backward_buffers(off, logits, refer, values) -> Tuple[torch.Tensor, ...]:
    """K8's outputs (g_off, g_logits, g_refer, g_values) for contiguous
    inputs: the offset and logit gradients uninitialised (K8 writes them
    whole), the box and value gradients zero-filled (K8 adds into them)."""
    return (torch.empty_like(off), torch.empty_like(logits),
            torch.zeros_like(refer), torch.zeros_like(values))


def _launch_backward(grad_out, off, logits, refer, values, shapes,
                     grads) -> None:
    """Launch K8 on the current stream into ``grads`` (from
    :func:`_backward_buffers`): one launch, counted."""
    b, nq, nh, nl, ndp, _ = off.shape
    hw = _level_args(off, values, shapes, "deform_sample_bwd")
    g_off, g_logits, g_refer, g_values = grads
    lib = _build.load("deform")
    with torch.cuda.device(off.device):
        code = lib.rvt_deform_sample_backward(
            grad_out.data_ptr(), off.data_ptr(), logits.data_ptr(),
            refer.data_ptr(), values.data_ptr(), g_off.data_ptr(),
            g_logits.data_ptr(), g_refer.data_ptr(), g_values.data_ptr(),
            b, nq, nh, values.shape[1], nl, ndp, *hw,
            _build.stream_ptr(off))
    _build.launch_counts["deform_sample_bwd"] += 1
    _build.check(code, "deform_sample_bwd")


def _sample_backward_cuda(grad_out, off, logits, refer, values, shapes
                          ) -> Tuple[torch.Tensor, ...]:
    """Launch K8 on the current stream: (g_off, g_logits, g_refer,
    g_values) f32, the value and box gradients summed by atomics into
    zero-filled tensors."""
    b, nq, nh = off.shape[:3]
    _level_args(off, values, shapes, "deform_sample_bwd")
    if any(t.dtype != torch.float32
           for t in (grad_out, off, logits, refer, values)):
        raise ValueError(f"deform_sample_bwd takes float32 gradients, "
                         f"offsets, logits, boxes and values, got "
                         f"{grad_out.dtype}, {off.dtype}, {logits.dtype}, "
                         f"{refer.dtype}, {values.dtype}")
    if tuple(grad_out.shape) != (b, nq, nh, HEAD_DIM):
        raise ValueError(f"deform_sample_bwd: grad_out "
                         f"{tuple(grad_out.shape)} does not fit off "
                         f"{tuple(off.shape)}")
    off, logits, refer = (t.contiguous() for t in (off, logits, refer))
    grad_out, values = _aligned(grad_out), _aligned(values)
    grads = _backward_buffers(off, logits, refer, values)
    _launch_backward(grad_out, off, logits, refer, values, shapes, grads)
    return grads


class DeformSample(torch.autograd.Function):
    """K7 forward (f32 values, no bf16 rounding), K8 backward. Saves only
    the four inputs; the backward recomputes the softmax, locations and
    corner weights from them."""

    @staticmethod
    def forward(ctx, off, logits, refer, values, shapes):
        ctx.shapes = [tuple(int(v) for v in s) for s in shapes]
        ctx.save_for_backward(off, logits, refer, values)
        return _sample_cuda(off, logits, refer, values, ctx.shapes, False)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        grads = _sample_backward_cuda(grad_out, *ctx.saved_tensors,
                                      ctx.shapes)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def deform_sample(off: torch.Tensor, logits: torch.Tensor,
                  refer: torch.Tensor, values: torch.Tensor,
                  shapes: Sequence[Tuple[int, int]], bf16_vals: bool = False,
                  paired: bool = False) -> torch.Tensor:
    """K7 wrapper: the sampled (B, NQ, NH, dh) f32 of
    :func:`deform_sample_plain`. A CPU tensor runs the plain version
    (``paired`` chooses its gather formulation; autograd takes its
    gradient). A CUDA tensor launches K7 on the current stream
    (``paired`` does not apply: K7 computes both formulations'
    function), and raises if the launch fails. Where gradients are
    enabled and an input requires them, the CUDA call goes through
    :class:`DeformSample`, whose backward launches K8; it takes f32
    values without bf16 rounding (training pins ``bf16_vals=False``, as
    JAX's train path does) and raises ``ValueError`` otherwise."""
    _check(off, logits, refer, values, shapes)
    dev = values.device
    if dev.type == "cpu":
        return deform_sample_plain(off, logits, refer, values, shapes,
                                   bf16_vals, paired)
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (off, logits, refer)):
        raise ValueError(f"unsupported devices {off.device}, "
                         f"{logits.device}, {refer.device}, {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (off, logits, refer, values)):
        if bf16_vals or values.dtype != torch.float32:
            raise ValueError(
                f"deform_sample: gradients through K7 / K8 need float32 "
                f"values and bf16_vals=False, got {values.dtype} values "
                f"and bf16_vals={bool(bf16_vals)}")
        return DeformSample.apply(off, logits, refer, values, shapes)
    return _sample_cuda(off, logits, refer, values, shapes, bf16_vals)
