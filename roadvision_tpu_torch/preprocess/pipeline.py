"""Preprocess pipeline — the port of ``roadvision_tpu/preprocess/pipeline.py``.

Built from ``cfg.chain = [{name, params}, ...]`` through the registry; a
disabled or empty chain is the identity; ops fold left to right. When
every op is planar the chain runs fused on uint8 (b, g, r) planes with
one unpack and one repack; otherwise (``space: LAB``) op by op on
channel-last frames.

``auto_gate.enable_low_contrast_gate`` runs the chain only on frames
whose contrast statistic (``stat``: "span" = gray max − min, "pspan" =
p99.5 − p0.5 of the stride-4 gray subsample) is below
``contrast_thresh``, or, with ``impulse_thresh`` set, whose impulse
residual (mean |gray − median3x3(gray)| on the stride-4 subsample) is at
or above it. The gate stays on the device without a host sync: both
branches are computed and a per-frame ``torch.where`` picks, so a CUDA
graph captures it, the threshold baked in as a number.
``contrast_thresh: "auto"`` is resolved on the host by
:meth:`PreprocessPipeline.calibrate_gate`, from the first batch unless
the caller does it earlier; every calibration moves
:attr:`PreprocessPipeline.gate_epoch`, so that a step captured with an
older threshold is dropped, not replayed.

:func:`host_contrast_stats` and :func:`host_impulse_stats` are the numpy
mirrors of the gate statistics, copied from the JAX package's
``pipeline.py:37-73`` (float-luma gray: the calibration margin dwarfs
its ±1 level against the device's fixed-point gray).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.color import bgr_to_gray_u8, gray_from_bgr_planes
from ..ops.median import median_planes
from ..utils.device import DeviceLike, resolve_device
from .registry import get_op_class

GATE_STATS = ("span", "pspan")


def _host_gray(frames_u8: np.ndarray) -> np.ndarray:
    f = np.asarray(frames_u8).astype(np.float32)
    return (0.114 * f[..., 0] + 0.587 * f[..., 1]
            + 0.299 * f[..., 2]).astype(np.uint8).astype(np.int32)


def host_contrast_stats(frames_u8: np.ndarray,
                        stat: str = "span") -> np.ndarray:
    """Per-frame contrast statistic on the host: "span" = gray max − min,
    "pspan" = p99.5 − p0.5 of the stride-4 gray subsample."""
    gray = _host_gray(frames_u8)
    if str(stat) == "pspan":
        sub = gray[..., ::4, ::4]
        flat = sub.reshape(sub.shape[:-2] + (-1,))
        n = flat.shape[-1]
        s = np.sort(flat, axis=-1)
        lo = s[..., max(0, int(0.005 * (n - 1)))]
        hi = s[..., min(n - 1, int(0.995 * (n - 1)))]
        return (hi - lo).astype(np.float64)
    return (gray.max(axis=(-2, -1))
            - gray.min(axis=(-2, -1))).astype(np.float64)


def host_impulse_stats(frames_u8: np.ndarray) -> np.ndarray:
    """Per-frame impulse residual on the host: mean |gray −
    median3x3(gray)| on the stride-4 subsample, replicate border. Takes
    a (B, H, W, 3) batch; a single (H, W, 3) frame is read as a batch of
    one and gives a (1,) array (the JAX package's function fails on it)."""
    frames_u8 = np.asarray(frames_u8)
    if frames_u8.ndim == 3:
        frames_u8 = frames_u8[None]
    if frames_u8.ndim != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3) frames, got "
                         f"{frames_u8.shape}")
    sub = _host_gray(frames_u8)[..., ::4, ::4]
    p = np.pad(sub, ((0, 0), (1, 1), (1, 1)), mode="edge")
    h, w = sub.shape[1:]
    neigh = np.stack([p[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], axis=-1)
    med = np.median(neigh, axis=-1)
    return np.abs(sub - med).mean(axis=(1, 2)).astype(np.float64)


class PreprocessPipeline:
    """``device`` is where the single-frame :meth:`__call__` runs (the
    card by default); :meth:`apply_batch` runs where its tensor lies."""

    def __init__(self, config: Dict[str, Any], device: DeviceLike = None):
        self.enabled = bool(config.get("enabled", True))
        self.chain_cfg = config.get("chain", []) or []
        self.auto_gate_cfg = config.get("auto_gate", {}) or {}
        self._device = device
        stat = str(self.auto_gate_cfg.get("stat", "span"))
        if stat not in GATE_STATS:
            raise ValueError(f"auto_gate.stat {stat!r} unknown "
                             f"(span | pspan)")
        t = self.auto_gate_cfg.get("contrast_thresh", 20.0)
        self._auto_thresh: Optional[float] = None   # resolved "auto" value
        # moves at every calibration: a captured step holds the threshold
        # of the epoch it was captured in
        self.gate_epoch = 0
        if isinstance(t, str) and t != "auto":
            raise ValueError(f"auto_gate.contrast_thresh must be a number "
                             f"or 'auto', got {t!r}")
        self.ops = [get_op_class(node.get("name"))(
            **(node.get("params", {}) or {})) for node in self.chain_cfg]

    @property
    def identity(self) -> bool:
        return not self.enabled or not self.ops

    @property
    def _gated(self) -> bool:
        return bool(self.auto_gate_cfg.get("enable_low_contrast_gate", False))

    @property
    def _planar(self) -> bool:
        return all(op.supports_planar() for op in self.ops)

    # ------------------------------------------------------------------
    # the gate threshold (auto_gate.contrast_thresh: "auto")
    @property
    def _thresh_is_auto(self) -> bool:
        return self.auto_gate_cfg.get("contrast_thresh", 20.0) == "auto"

    def _gate_thresh(self) -> float:
        """The gate threshold; "auto" must have been resolved by
        :meth:`calibrate_gate` (``apply_batch`` and the engine do it from
        their first batch) and raises here otherwise, so that a missed
        call site is loud."""
        if self._thresh_is_auto:
            if self._auto_thresh is None:
                raise RuntimeError(
                    "auto_gate.contrast_thresh: 'auto' is unresolved — "
                    "call calibrate_gate(clean_frames) before the first "
                    "gated batch")
            return self._auto_thresh
        return float(self.auto_gate_cfg.get("contrast_thresh", 20.0))

    def host_gate_stats(self, frames_u8: np.ndarray) -> np.ndarray:
        """Per-frame contrast statistic (``auto_gate.stat``) on the host."""
        return host_contrast_stats(
            frames_u8, str(self.auto_gate_cfg.get("stat", "span")))

    def calibrate_gate(self, frames_u8: Optional[np.ndarray] = None,
                       stats: Optional[np.ndarray] = None) -> float:
        """Resolve the "auto" threshold from representative CLEAN frames:
        ``auto_ratio`` (0.85) × the ``auto_pct``-th percentile (10) of the
        per-frame statistic. ``stats`` may carry precomputed
        :meth:`host_gate_stats`; one of the two arguments is required."""
        if stats is None:
            if frames_u8 is None:
                raise ValueError("calibrate_gate needs frames_u8 or stats")
            stats = self.host_gate_stats(frames_u8)
        ratio = float(self.auto_gate_cfg.get("auto_ratio", 0.85))
        pct = float(self.auto_gate_cfg.get("auto_pct", 10.0))
        self._auto_thresh = float(ratio * np.percentile(stats, pct))
        self.gate_epoch += 1
        return self._auto_thresh

    def ensure_gate_calibrated(self, frames_u8) -> None:
        """Resolve an "auto" threshold from the FIRST batch (assumed
        clean). No-op once resolved or when the threshold is numeric, and
        only then do the frames (numpy, or a tensor on any device) come
        to the host."""
        if self._gated and self._thresh_is_auto \
                and self._auto_thresh is None:
            if isinstance(frames_u8, torch.Tensor):
                frames_u8 = frames_u8.cpu().numpy()
            self.calibrate_gate(np.asarray(frames_u8))

    def gate_stats(self, gray: torch.Tensor):
        """(contrast statistic, impulse residual or None) per frame, both
        float32, from a (..., H, W) uint8 gray plane."""
        stat = str(self.auto_gate_cfg.get("stat", "span"))
        if stat == "pspan":
            sub = gray[..., ::4, ::4]
            flat = sub.reshape(sub.shape[:-2] + (-1,)).to(torch.int32)
            n = flat.shape[-1]
            s = torch.sort(flat, dim=-1).values
            lo = s[..., max(0, int(0.005 * (n - 1)))]
            hi = s[..., min(n - 1, int(0.995 * (n - 1)))]
            contrast = (hi - lo).to(torch.float32)
        else:
            contrast = (gray.amax(dim=(-2, -1)).to(torch.int32)
                        - gray.amin(dim=(-2, -1)).to(torch.int32)) \
                .to(torch.float32)
        impulse = None
        # `or None`: YAML null arrives as {}, and 0 disables
        if (self.auto_gate_cfg.get("impulse_thresh") or None) is not None:
            sub = gray[..., ::4, ::4].contiguous()
            h, w = sub.shape[-2], sub.shape[-1]
            # K3 pads by replicating the border, as the statistic asks
            med = median_planes(sub.reshape(-1, h, w), 3).reshape(sub.shape)
            resid = (sub.to(torch.int32) - med.to(torch.int32)).abs() \
                .to(torch.float32)
            impulse = resid.mean(dim=(-2, -1))
        return contrast, impulse

    def _gate_from_gray(self, gray: torch.Tensor) -> torch.Tensor:
        """True per frame where the chain should run."""
        contrast, impulse = self.gate_stats(gray)
        run = contrast < self._gate_thresh()
        if impulse is not None:
            run = run | (impulse >= float(self.auto_gate_cfg["impulse_thresh"]))
        return run

    # ------------------------------------------------------------------
    def _batch_fn(self, frames: torch.Tensor) -> torch.Tensor:
        if self._planar:
            return self._planar_fn(frames)
        out = frames
        for op in self.ops:
            out = op.apply_batch(out)
        if self._gated:
            run = self._gate_from_gray(bgr_to_gray_u8(frames))
            out = torch.where(run.reshape(run.shape + (1, 1, 1)), out, frames)
        return out

    def _planar_fn(self, frames: torch.Tensor) -> torch.Tensor:
        planes = tuple(frames[..., c] for c in range(3))
        out = planes
        for op in self.ops:
            out = op.apply_planar(out)
        if self._gated:
            run = self._gate_from_gray(gray_from_bgr_planes(*planes))
            run = run.reshape(run.shape + (1, 1))
            out = tuple(torch.where(run, o.to(torch.uint8), p)
                        for o, p in zip(out, planes))
        return torch.stack([p.to(torch.uint8) for p in out], dim=-1)

    def supports_sampled(self) -> bool:
        """True when the chain can produce its output at a strided sample
        grid: planar, un-gated (the gate selects full frames), and the
        terminal op has the sampled path."""
        return (not self.identity and not self._gated and self._planar
                and self.ops[-1].supports_planar_sampled())

    def sampled_planes_fn(self, plan_y, plan_x):
        """(..., H, W, 3) uint8 → (b, g, r) uint8 planes at the sample
        grid. All ops but the last run at full resolution; the terminal
        op evaluates the ``(stride, offset, count)`` grid only, bit-equal
        to the full chain sliced at that grid."""
        if not self.supports_sampled():
            raise ValueError("this chain has no sampled path "
                             "(supports_sampled() is False)")

        def fn(frames: torch.Tensor):
            out = tuple(frames[..., c] for c in range(3))
            for op in self.ops[:-1]:
                out = op.apply_planar(out)
            out = self.ops[-1].apply_planar_sampled(out, plan_y, plan_x)
            return tuple(p.to(torch.uint8) for p in out)

        return fn

    def apply_batch(self, frames: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3) uint8 BGR → processed uint8 batch, same shape."""
        if self.identity:
            return frames
        self.ensure_gate_calibrated(frames)
        return self._batch_fn(frames)

    def __call__(self, image: np.ndarray,
                 ts: Optional[float] = None) -> np.ndarray:
        """Host single-frame API (``ts`` accepted and ignored)."""
        if self.identity:
            return image
        self.ensure_gate_calibrated(image[None])
        x = torch.from_numpy(np.ascontiguousarray(image)) \
            .to(resolve_device(self._device))
        return self._batch_fn(x).cpu().numpy()
