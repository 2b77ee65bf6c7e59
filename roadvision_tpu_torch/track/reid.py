"""Learned appearance embedder for the re-id trackers — the inference
half of ``roadvision_tpu/track/reid.py`` on tensors.

Each detection's 32 × 32 crop (the shared bilinear sampler,
``appearance.sample_box_grid``) goes through three stride-2 3×3 convs
with SiLU, a global average pool and a linear projection to the same
L2-normalised ``EMB_DIM`` vector as the grid descriptor, so the cosine
association and the appearance EMA downstream are unchanged.
``tracking.reid_weights: path.npz`` selects it in the engine.

Parameters live as torch tensors with the convolution kernels in OIHW;
the ``.npz`` files keep the JAX layout (HWIO), so a file trained by the
JAX tool loads here and :func:`save_reid_params` writes what the JAX
package reads. :func:`reid_params_from_jax` converts a JAX parameter
tree. The convs pad as XLA's ``padding="SAME"`` does: (0, 1) per axis
for stride 2 on an even side, not the (1, 1) of ``padding=1``.

Training (:func:`train_reid`) is the JAX module's: P identities × K
views a batch from the synthetic identity generator (numpy draws equal
to JAX's for the same seed), the batch-hard triplet loss on cosine
distance, and Adam written to optax's ``adam`` update (β 0.9 / 0.999,
ε 1e-8, bias-corrected moments, ``p − lr · m̂ / (√v̂ + ε)``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import DeviceLike, resolve_device
from .appearance import EMB_DIM, sample_box_grid

REID_CROP = 32                  # input crop side; 3 stride-2 convs → 4×4
_CHANNELS = (16, 32, 64)

ReidParams = Dict[str, torch.Tensor]


def _same_pad(n: int, k: int = 3, s: int = 2):
    """XLA's SAME padding (lo, hi) of one axis of side n."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _from_hwio(arrays: Mapping[str, np.ndarray],
               device: torch.device) -> ReidParams:
    p = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.asarray(v, np.float32).copy())
        if k.startswith("w") and k != "wd":
            t = t.permute(3, 2, 0, 1).contiguous()       # HWIO → OIHW
        p[k] = t.to(device)
    return p


def init_reid_params(seed: int = 0, device: DeviceLike = None) -> ReidParams:
    """He-initialised parameters from the same numpy draws as the JAX
    ``init_reid_params``."""
    rng = np.random.default_rng(seed)
    p = {}
    cin = 3
    for i, cout in enumerate(_CHANNELS, 1):
        p[f"w{i}"] = rng.normal(0.0, (2.0 / (9 * cin)) ** 0.5,
                                (3, 3, cin, cout))
        p[f"b{i}"] = np.zeros((cout,))
        cin = cout
    p["wd"] = rng.normal(0.0, (1.0 / cin) ** 0.5, (cin, EMB_DIM))
    p["bd"] = np.zeros((EMB_DIM,))
    return _from_hwio(p, resolve_device(device))


def reid_params_from_jax(params: Mapping, device: DeviceLike = None
                         ) -> ReidParams:
    """The port's parameters from a JAX ``ReidParams`` tree (HWIO)."""
    return _from_hwio({k: np.asarray(v) for k, v in params.items()},
                      resolve_device(device))


def forward_crops(params: ReidParams, crops: torch.Tensor) -> torch.Tensor:
    """(N, S, S, 3) f32 in [0, 255] → (N, EMB_DIM) L2-normalised."""
    x = (crops * (2.0 / 255.0) - 1.0).permute(0, 3, 1, 2)
    for i in range(1, len(_CHANNELS) + 1):
        ph, pw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
        x = F.conv2d(F.pad(x, (*pw, *ph)), params[f"w{i}"],
                     params[f"b{i}"], stride=2)
        x = F.silu(x)
    x = x.mean(dim=(2, 3))
    x = x @ params["wd"] + params["bd"]
    n = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.clamp(n, min=1e-6)


def reid_embeddings(params: ReidParams, frame_u8: torch.Tensor,
                    boxes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Same contract as ``appearance.box_embeddings`` with learned
    weights: (..., H, W, 3) u8 + (..., D, 4) xyxy + (..., D) bool →
    (..., D, EMB_DIM) f32, zero rows for invalid detections; a fleet's
    (S, B) leading axes go through the network as one batch of crops."""
    crops = sample_box_grid(frame_u8, boxes, REID_CROP)
    emb = forward_crops(params, crops.reshape(-1, *crops.shape[-3:]))
    emb = emb.reshape(*boxes.shape[:-1], EMB_DIM)
    return torch.where(valid[..., None], emb, torch.zeros_like(emb))


def make_reid_embed(params: ReidParams):
    """Bind params → an engine-pluggable ``embed(frame, boxes, valid)``."""
    def embed(frame_u8, boxes, valid):
        return reid_embeddings(params, frame_u8, boxes, valid)
    return embed


def save_reid_params(path, params: ReidParams) -> None:
    """Write the JAX file layout (HWIO kernels)."""
    out = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        out[k] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    np.savez(path, **out)


def load_reid_params(path, device: DeviceLike = None) -> ReidParams:
    """Read a re-id ``.npz`` (JAX layout) with the JAX loader's checks
    and messages, onto ``device`` (the card unless named)."""
    with np.load(path) as z:
        params = {k: z[k] for k in z.files}
    missing = {f"w{i}" for i in range(1, len(_CHANNELS) + 1)} \
        | {f"b{i}" for i in range(1, len(_CHANNELS) + 1)} | {"wd", "bd"}
    missing -= set(params)
    if missing:
        raise ValueError(f"re-id weights {path}: missing arrays "
                         f"{sorted(missing)}")
    for i in range(1, len(_CHANNELS) + 1):
        if params[f"w{i}"].ndim != 4 or params[f"b{i}"].ndim != 1 \
                or params[f"w{i}"].shape[-1] != params[f"b{i}"].shape[0]:
            raise ValueError(
                f"re-id weights {path}: w{i}/b{i} shapes "
                f"{params[f'w{i}'].shape}/{params[f'b{i}'].shape} are not "
                f"a conv kernel + matching bias")
    if params["wd"].shape[-1] != EMB_DIM:
        raise ValueError(
            f"re-id weights {path}: output width "
            f"{params['wd'].shape[-1]} != EMB_DIM {EMB_DIM}")
    return _from_hwio(params, resolve_device(device))


# --------------------------------------------------------------------------
# synthetic identity generator (self-contained trainer data)
# --------------------------------------------------------------------------

def _identity_style(ident: int):
    """Deterministic per-identity look: two colours + stripe geometry."""
    rng = np.random.default_rng(0x5EED ^ (int(ident) * 2654435761 % 2**31))
    c1 = rng.integers(30, 226, 3).astype(np.float32)
    c2 = rng.integers(30, 226, 3).astype(np.float32)
    period = int(rng.integers(6, 16))
    horiz = bool(rng.integers(0, 2))
    phase = float(rng.uniform(0, period))
    return c1, c2, period, horiz, phase


def render_identity_view(ident: int, rng: np.random.Generator,
                         frame: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """``render_identity_view`` :144: one augmented view of an identity
    in a noise frame → (frame_u8 (F, F, 3), box (1, 4) xyxy)."""
    img = rng.integers(0, 60, (frame, frame, 3)).astype(np.float32)
    side_w = int(rng.integers(18, min(44, frame - 4)))
    side_h = int(rng.integers(18, min(44, frame - 4)))
    x1 = int(rng.integers(1, frame - side_w - 1))
    y1 = int(rng.integers(1, frame - side_h - 1))
    c1, c2, period, horiz, phase = _identity_style(ident)
    yy, xx = np.mgrid[0:side_h, 0:side_w]
    # stripes in box-normalised coordinates: scale does not change them
    coord = (yy / side_h if horiz else xx / side_w) * REID_CROP
    m = ((coord + phase + rng.uniform(-0.5, 0.5)) % period) < (period / 2)
    patch = np.where(m[..., None], c1, c2)
    gain = rng.uniform(0.65, 1.35)
    patch = patch * gain + rng.normal(0, 6.0, patch.shape)
    img[y1:y1 + side_h, x1:x1 + side_w] = patch
    img = np.clip(img, 0, 255).astype(np.uint8)
    box = np.array([[x1, y1, x1 + side_w, y1 + side_h]], np.float32)
    return img, box


def synthetic_reid_batch(rng: np.random.Generator, idents: np.ndarray,
                         views: int, frame: int = 64):
    """P identities × K views → (frames (N, F, F, 3) u8, boxes (N, 1, 4),
    labels (N,) int32), N = P·K."""
    frames, boxes, labels = [], [], []
    for ident in idents:
        for _ in range(views):
            img, box = render_identity_view(int(ident), rng, frame)
            frames.append(img)
            boxes.append(box)
            labels.append(int(ident))
    return (np.stack(frames), np.stack(boxes),
            np.asarray(labels, np.int32))


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def batch_hard_triplet(emb: torch.Tensor, labels: torch.Tensor,
                       margin: float = 0.3) -> torch.Tensor:
    """Batch-hard triplet loss on cosine distance: per anchor, the
    hardest positive minus the closest negative, plus the margin."""
    d = 1.0 - emb @ emb.T
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=emb.device)
    hardest_pos = torch.where(same & ~eye, d, float("-inf")).amax(dim=1)
    hardest_neg = torch.where(~same, d, float("inf")).amin(dim=1)
    return (hardest_pos - hardest_neg + margin).clamp(min=0.0).mean()


def embed_frames(params: ReidParams, frames_u8: torch.Tensor,
                 boxes: torch.Tensor) -> torch.Tensor:
    """(N, F, F, 3) u8 + (N, 1, 4) → (N, EMB_DIM): one box a frame."""
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool,
                       device=boxes.device)
    return reid_embeddings(params, frames_u8, boxes, valid)[:, 0]


def adam_update(params: ReidParams, grads: Mapping[str, torch.Tensor],
                state: Dict, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> None:
    """One ``optax.adam`` step in place: moments ``(1 − β)·g + β·m``,
    bias correction by ``1 − β^count``, ``p − lr · m̂ / (√v̂ + ε)``."""
    state["count"] += 1
    c = state["count"]
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m = state["mu"][k].mul_(b1).add_((1 - b1) * g)
            v = state["nu"][k].mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - np.float32(b1) ** np.float32(c))
            v_hat = v / (1 - np.float32(b2) ** np.float32(c))
            p.sub_(lr * (m_hat / (torch.sqrt(v_hat) + eps)))


def init_adam(params: ReidParams) -> Dict:
    """optax ``adam``'s state: the step count and zero moments."""
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def reid_train_step(params: ReidParams, state: Dict, frames: torch.Tensor,
                    boxes: torch.Tensor, labels: torch.Tensor,
                    lr: float = 1e-3, margin: float = 0.3) -> torch.Tensor:
    """One step of ``train_reid``'s jitted ``step``: the triplet loss of
    the batch, its gradient and the Adam update, ``params`` and ``state``
    changed in place; returns the loss (on the device)."""
    for v in params.values():
        v.requires_grad_(True)
    try:
        loss = batch_hard_triplet(embed_frames(params, frames, boxes),
                                  labels, margin)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    finally:
        for v in params.values():
            v.requires_grad_(False)
    adam_update(params, grads, state, lr)
    return loss.detach()


def train_reid(steps: int = 300, idents: int = 8, views: int = 4,
               ident_pool: int = 128, lr: float = 1e-3, margin: float = 0.3,
               seed: int = 0, frame: int = 64,
               batch_fn: Optional[Callable] = None,
               log_every: int = 0,
               log: Optional[Callable[[str], None]] = None,
               device: DeviceLike = None) -> Tuple[ReidParams, List[float]]:
    """``train_reid`` :212 on ``device`` (the card unless "cpu" is
    named): synthetic identities (or ``batch_fn() → (frames, boxes,
    labels)``) → (params, loss history)."""
    dev = resolve_device(device)
    params = init_reid_params(seed, dev)
    state = init_adam(params)
    rng = np.random.default_rng(seed)
    history: List[float] = []
    for i in range(steps):
        if batch_fn is not None:
            frames, boxes, labels = batch_fn()
        else:
            picked = rng.choice(ident_pool, size=idents, replace=False)
            frames, boxes, labels = synthetic_reid_batch(
                rng, picked, views, frame)
        loss = reid_train_step(
            params, state, torch.from_numpy(np.asarray(frames)).to(dev),
            torch.from_numpy(np.asarray(boxes)).to(dev),
            torch.from_numpy(np.asarray(labels)).to(dev), lr, margin)
        history.append(float(loss))
        if log_every and log and (i + 1) % log_every == 0:
            log(f"step {i + 1}/{steps}  triplet {history[-1]:.4f}")
    return params, history


def identity_separation(params: ReidParams, idents: np.ndarray,
                        views: int = 4, seed: int = 10_000,
                        frame: int = 64) -> float:
    """Mean same-identity cosine minus mean cross-identity cosine over
    fresh views (higher = better re-id)."""
    rng = np.random.default_rng(seed)
    frames, boxes, labels = synthetic_reid_batch(rng, idents, views, frame)
    dev = params["wd"].device
    with torch.no_grad():
        emb = embed_frames(params, torch.from_numpy(frames).to(dev),
                           torch.from_numpy(boxes).to(dev)).cpu().numpy()
    cos = emb @ emb.T
    same = labels[:, None] == labels[None, :]
    eye = np.eye(len(labels), dtype=bool)
    return float(cos[same & ~eye].mean() - cos[~same].mean())
