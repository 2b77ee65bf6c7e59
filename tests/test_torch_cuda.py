"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (with the reason) where no CUDA device
is present. Run them on a machine with an NVIDIA card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Every check is bit-equality: the kernels and their plain versions are
integer-exact, and the "cv2" blend rounds each float operation alone.
"""
import numpy as np
import pytest
import torch

from roadvision_tpu_torch.kernels import launch_counts
from roadvision_tpu_torch.ops import clahe as C
from roadvision_tpu_torch.ops import median as M

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _plane(shape, seed, dev):
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 256, shape).astype(np.uint8)
    p[:, : shape[1] // 5] = 90            # flat band: clipping, atomics
    return torch.from_numpy(p).to(dev)


@pytest.mark.parametrize("shape,grid", [((3, 120, 161), (2, 3)),
                                        ((2, 1080, 1920), (8, 8)),
                                        ((2, 97, 203), (8, 8)),
                                        ((1, 64, 64), (16, 16))])
@pytest.mark.parametrize("blend", ["cv2", "fixed"])
def test_clahe_kernels_bit_equal(dev, shape, grid, blend):
    x = _plane(shape, sum(shape), dev)
    gy, gx = grid
    n, h, w = shape
    pad_h, pad_w, th, tw = C.pad_plan(h, w, gy, gx)
    xe = C._reflect_pad_101(x, pad_h, pad_w)
    clip, scale = C.clip_count(2.0, th * tw), C.lut_scale(th * tw)
    before = dict(launch_counts)
    luts = C.clahe_tile_luts(xe, gy, gx, clip, scale)
    assert torch.equal(luts, C.tile_luts_plain(xe, gy, gx, clip, scale))
    out = C.clahe_apply(x, luts, th, tw, blend)
    assert torch.equal(out, C.apply_plain(x, luts, th, tw, blend))
    assert launch_counts["clahe_tile_luts"] == before["clahe_tile_luts"] + 1
    assert launch_counts["clahe_apply"] == before["clahe_apply"] + 1


@pytest.mark.parametrize("k", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", [(3, 70, 93), (1, 1, 1), (2, 33, 2)])
def test_median_kernel_bit_equal(dev, k, shape):
    x = _plane(shape, k + sum(shape), dev)
    before = launch_counts["median_k"]
    assert torch.equal(M.median_planes(x, k), M.median_plain(x, k))
    assert launch_counts["median_k"] == before + 1
