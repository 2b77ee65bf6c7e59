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
Training (``train_reid``) is not part of this module.
"""
from __future__ import annotations

from typing import Dict, Mapping

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
    weights: ([B,] H, W, 3) u8 + ([B,] D, 4) xyxy + ([B,] D,) bool →
    ([B,] D, EMB_DIM) f32, zero rows for invalid detections."""
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
