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


def _plane(shape, seed, dev, offset=0):
    """Seeded noise; ``offset`` bytes shift the storage off its 16-byte
    boundary (the tensor stays contiguous), for the kernels' byte paths."""
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 256, shape).astype(np.uint8)
    p[:, : shape[1] // 5] = 90            # flat band: clipping, atomics
    flat = torch.empty(p.size + offset, dtype=torch.uint8, device=dev)
    out = flat[offset:].view(shape)
    out.copy_(torch.from_numpy(p))
    assert out.is_contiguous() and out.data_ptr() % 16 == offset % 16
    return out


@pytest.mark.parametrize("shape,grid,offset", [
    ((3, 120, 161), (2, 3), 0),
    ((2, 1080, 1920), (8, 8), 0),
    ((2, 97, 203), (8, 8), 0),
    ((1, 64, 64), (16, 16), 0),
    ((2, 270, 484), (16, 16), 0),      # word-aligned rows, ragged grid
    ((2, 97, 203), (16, 16), 0),
    ((1, 40, 30), (1, 1), 0),          # one tile: a single column interval
    ((2, 2160, 3840), (8, 8), 0),      # two column groups per thread
    ((2, 96, 128), (4, 4), 1),         # aligned width, odd pointer
    ((2, 61, 131), (4, 4), 3),         # odd width, odd pointer
])
@pytest.mark.parametrize("blend", ["cv2", "fixed"])
def test_clahe_kernels_bit_equal(dev, shape, grid, offset, blend):
    x = _plane(shape, sum(shape), dev, offset)
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


@pytest.mark.parametrize("shape,offset", [
    ((2, 37, 1917), 0), ((3, 13, 17), 0), ((2, 9, 15), 0), ((2, 2, 33), 0),
    ((1, 1, 1), 0), ((2, 5, 16), 0),       # one strip, less than one band
    ((2, 1080, 1920), 0),                  # the wide path
    ((2, 43, 64), 1),                      # aligned width, odd pointer
    ((2, 43, 77), 5),                      # odd width, odd pointer
])
def test_median3_kernel_edge_paths_bit_equal(dev, shape, offset):
    x = _plane(shape, sum(shape), dev, offset)
    before = launch_counts["median_k"]
    assert torch.equal(M.median_planes(x, 3), M.median_plain(x, 3))
    assert launch_counts["median_k"] == before + 1
