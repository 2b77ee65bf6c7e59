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


@pytest.mark.parametrize("shape,grid,offset,fill,clip_limit", [
    ((8, 1080, 1920), (8, 8), 0, None, 2.0),   # tile width 240 = 15 pieces
    ((1, 1080, 1920), (8, 8), 0, None, 2.0),   # one plane
    ((2, 1080, 1920), (8, 8), 0, 77, 2.0),     # one value: flat pieces only
    ((2, 1080, 1920), (8, 8), 0, None, 0.0),   # no clip limit
    ((2, 2160, 3840), (8, 8), 0, None, 2.0),   # several passes per thread
    ((2, 64, 96), (4, 4), 0, None, 2.0),       # tile width 24: guarded loads
    ((2, 64, 128), (4, 4), 5, None, 2.0),      # tile width 32, odd pointer
    ((2, 64, 96), (4, 4), 3, None, 2.0),
    ((1, 16, 16), (4, 4), 0, None, 2.0),       # 4 x 4-pixel tiles, area < 256
    ((3, 122, 162), (2, 3), 0, None, 3.5),     # row stride not a multiple of 16
    ((1, 40, 30), (1, 1), 0, 255, 2.0),
])
def test_tile_luts_kernel_bit_equal(dev, shape, grid, offset, fill,
                                    clip_limit):
    xe = _plane(shape, sum(shape), dev, offset)
    if fill is not None:
        xe.fill_(fill)
    gy, gx = grid
    th, tw = shape[1] // gy, shape[2] // gx
    clip, scale = C.clip_count(clip_limit, th * tw), C.lut_scale(th * tw)
    before = launch_counts["clahe_tile_luts"]
    luts = C.clahe_tile_luts(xe, gy, gx, clip, scale)
    assert torch.equal(luts, C.tile_luts_plain(xe, gy, gx, clip, scale))
    if shape[1] <= 128:         # the layout's numpy twin, where it is quick
        assert torch.equal(luts, C.tile_luts_by_pieces(xe, gy, gx, clip,
                                                       scale))
    assert launch_counts["clahe_tile_luts"] == before + 1


@pytest.mark.parametrize("blend", ["cv2", "fixed"])
@pytest.mark.parametrize("shape,grid,stride", [
    ((2, 1080, 1920), (8, 8), 3), ((2, 97, 131), (8, 8), 3),
    ((2, 96, 128), (4, 4), 5),
])
def test_clahe_sampled_apply_bit_equal(dev, shape, grid, stride, blend):
    x = _plane(shape, sum(shape), dev)
    n, h, w = shape
    off = (stride - 1) // 2
    py, px = (stride, off, h // stride), (stride, off, w // stride)
    before = dict(launch_counts)
    got = C.clahe_planar_sampled(x, py, px, 2.0, grid, blend)
    assert launch_counts["clahe_tile_luts"] == before["clahe_tile_luts"] + 1
    assert launch_counts["clahe_apply"] == before["clahe_apply"] + 1
    full = C.clahe_planar(x, 2.0, grid, blend)
    assert torch.equal(got, full[:, off::stride, off::stride]
                       [:, :py[2], :px[2]])
    assert torch.equal(got.cpu(), C.clahe_planar_sampled(x.cpu(), py, px, 2.0,
                                                         grid, blend))


@pytest.mark.parametrize("cfg", [
    {"auto_gate": {"enable_low_contrast_gate": True, "stat": "pspan",
                   "contrast_thresh": 20.0, "impulse_thresh": 2.5}},
    {"chain": [{"name": "CLAHEDehaze", "params": {"space": "LAB"}},
               {"name": "MedianDerain", "params": {"ksize": 3}}]},
], ids=["gated", "lab"])
def test_preprocess_pipeline_on_the_card_equals_the_cpu_path(dev, cfg):
    from roadvision_tpu_torch.preprocess import PreprocessPipeline
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (4, 180, 320, 3)).astype(np.uint8)
    frames[1] = frames[1] // 16 + 100                    # low contrast
    base = {"enabled": True, "chain": [
        {"name": "CLAHEDehaze", "params": {}},
        {"name": "MedianDerain", "params": {"ksize": 3}}]}
    pipe = PreprocessPipeline(dict(base, **cfg))
    x = torch.from_numpy(frames)
    assert torch.equal(pipe.apply_batch(x.to(dev)).cpu(), pipe.apply_batch(x))


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
