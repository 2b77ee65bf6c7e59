"""roadvision_tpu_torch ops vs the JAX package, on the CPU.

Inputs are made with seeded numpy and go through the JAX function and
its port. Colour, CLAHE (tile LUTs and both blend modes) and the median
are integer-exact, so they must be bit-equal; the CLAHE tap lookup and
the median are also held against the Pallas kernels themselves, run in
interpret mode. Letterbox, NMS and geometry compare as stated per test.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roadvision_tpu.geometry import projector as jproj
from roadvision_tpu.ops import clahe as jclahe
from roadvision_tpu.ops import color as jcolor
from roadvision_tpu.ops import letterbox as jlb
from roadvision_tpu.ops import median as jmedian
from roadvision_tpu.ops import nms as jnms
from roadvision_tpu.ops.pallas_clahe import sweep_pallas
from roadvision_tpu.ops.pallas_median import median3_pallas
from roadvision_tpu_torch.geometry import projector as tproj
from roadvision_tpu_torch.ops import clahe as tclahe
from roadvision_tpu_torch.ops import color as tcolor
from roadvision_tpu_torch.ops import letterbox as tlb
from roadvision_tpu_torch.ops import median as tmedian
from roadvision_tpu_torch.ops import nms as tnms


def _all_bgr():
    v = np.arange(256 ** 3, dtype=np.int64)
    return tuple(((v >> s) & 255).astype(np.int32) for s in (16, 8, 0))


@pytest.mark.parametrize("fn", ["bgr_planes_to_ycrcb_i32",
                                "ycrcb_planes_to_bgr_i32",
                                "gray_from_bgr_planes"])
def test_color_bit_equal_full_u8_domain(fn):
    planes = _all_bgr()
    want = getattr(jcolor, fn)(*(jnp.asarray(p) for p in planes))
    got = getattr(tcolor, fn)(*(torch.from_numpy(p) for p in planes))
    if fn == "gray_from_bgr_planes":
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_color_keeps_uint8_planes():
    rng = np.random.RandomState(3)
    b, g, r = (torch.from_numpy(rng.randint(0, 256, (4, 5), dtype=np.uint8))
               for _ in range(3))
    y, cr, cb = tcolor.bgr_planes_to_ycrcb_i32(b, g, r)
    assert y.dtype == torch.uint8 and cr.dtype == torch.uint8
    want = jcolor.bgr_planes_to_ycrcb_i32(
        *(jnp.asarray(p.numpy().astype(np.int32)) for p in (b, g, r)))
    for w, t in zip(want, (y, cr, cb)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def _plane(shape, seed):
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 256, shape).astype(np.int32)
    p[..., : shape[-2] // 4, :] = 117      # a flat band: heavy clipping
    return p


@pytest.mark.parametrize("shape,grid", [
    ((2, 120, 161), (2, 3)),     # ragged width: both dims padded
    ((2, 120, 161), (8, 8)),
    ((1, 96, 128), (4, 4)),      # divisible: no pad
    ((3, 72, 96), (8, 8)),
])
def test_tile_luts_bit_equal(shape, grid):
    p = _plane(shape, sum(shape) + grid[0])
    want = np.asarray(jclahe.compute_tile_luts(jnp.asarray(p), 2.0, grid))
    got = tclahe.compute_tile_luts(torch.from_numpy(p.astype(np.uint8)),
                                   2.0, grid)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("blend", ["cv2", "fixed"])
@pytest.mark.parametrize("shape,grid,clip", [
    ((2, 120, 161), (2, 3), 2.0),    # ragged: both dims padded
    ((2, 96, 128), (4, 4), 3.5),
    ((1, 67, 90), (8, 8), 0.0),  # no clipping
])
def test_clahe_planar_bit_equal(blend, shape, grid, clip):
    p = _plane(shape, 7 * shape[-1] + grid[1])
    want = np.asarray(jclahe.clahe_planar_i32(jnp.asarray(p), clip, grid,
                                              blend=blend))
    got = tclahe.clahe_planar(torch.from_numpy(p), clip, grid, blend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_clahe_taps_match_pallas_sweep():
    """The port's per-pixel tap lookup against sweep_pallas itself: on
    one row band the four taps of every pixel, packed
    l11 | l12<<8 | l21<<16 | l22<<24, equal what the TPU kernel reads
    out of the packed per-(bin, column) table (interpret mode)."""
    rng = np.random.RandomState(11)
    n, h, w, gy, gx = 2, 64, 200, 4, 5
    plane = rng.randint(0, 256, (n, h, w)).astype(np.uint8)
    x = torch.from_numpy(plane)
    pad_h, pad_w, th, tw = tclahe.pad_plan(h, w, gy, gx)
    luts = tclahe.clahe_tile_luts(tclahe._reflect_pad_101(x, pad_h, pad_w),
                                  gy, gx, tclahe.clip_count(2.0, th * tw),
                                  tclahe.lut_scale(th * tw))
    ri, _ = tclahe.interp_tables(h, th, gy)
    ci, _ = tclahe.interp_tables(w, tw, gx)
    y0 = int(np.argmax(ri[:, 0] == 1))           # a band: rows with
    y1 = y0 + int(np.sum((ri[:, 0] == 1) & (ri[:, 1] == 2)))  # ty = (1, 2)
    assert y1 - y0 > 4
    lut = luts.numpy().astype(np.uint32)
    l1 = lut[:, 1][:, ci[:, 0]]                  # (n, w, 256) tile row 1
    l2 = lut[:, 2][:, ci[:, 0]]
    r1 = lut[:, 1][:, ci[:, 1]]
    r2 = lut[:, 2][:, ci[:, 1]]
    packed = (l1 | (r1 << 8) | (l2 << 16) | (r2 << 24)).transpose(0, 2, 1)
    want = np.asarray(sweep_pallas(plane[:, y0:y1].astype(np.int32),
                                   packed, interpret=True))
    taps = tclahe.lut_taps(x, luts, th, tw)
    l11, l12, l21, l22 = (t.numpy().astype(np.uint32)[:, y0:y1] for t in taps)
    got = l11 | (l12 << 8) | (l21 << 16) | (l22 << 24)
    np.testing.assert_array_equal(got, want)


# the shapes behind the CUDA kernels' edge paths: the plain versions are
# the oracle the kernels are held to on the card, so they are held to the
# JAX functions here at the same shapes
@pytest.mark.parametrize("blend", ["cv2", "fixed"])
@pytest.mark.parametrize("shape,grid", [
    ((3, 120, 161), (2, 3)),     # ragged tail, two tile rows
    ((2, 50, 37), (2, 3)),
    ((1, 64, 64), (16, 16)),     # tiles of 4 x 4 pixels: two-row bands
    ((2, 97, 203), (16, 16)),    # ragged in both dims on the fine grid
    ((1, 270, 484), (16, 16)),
])
def test_clahe_planar_edge_shapes_bit_equal(blend, shape, grid):
    p = _plane(shape, 3 * shape[-1] + grid[0])
    want = np.asarray(jclahe.clahe_planar_i32(jnp.asarray(p), 2.0, grid,
                                              blend=blend))
    got = tclahe.clahe_planar(torch.from_numpy(p), 2.0, grid, blend)
    np.testing.assert_array_equal(got.numpy(), want)


def _taps_case(n, h, w, gy, gx, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 256, (n, h, w)).astype(np.uint8))
    pad_h, pad_w, th, tw = tclahe.pad_plan(h, w, gy, gx)
    luts = tclahe.clahe_tile_luts(tclahe._reflect_pad_101(x, pad_h, pad_w),
                                  gy, gx, tclahe.clip_count(2.0, th * tw),
                                  tclahe.lut_scale(th * tw))
    return x, luts, th, tw


@pytest.mark.parametrize("chunk_rows", [1, 5, 24])
@pytest.mark.parametrize("shape,grid", [
    ((2, 64, 200), (4, 5)), ((1, 64, 64), (16, 16)), ((2, 97, 203), (8, 8)),
    ((1, 40, 30), (1, 1)), ((2, 120, 161), (2, 3)),
])
def test_clahe_packed_table_matches_lut_taps(shape, grid, chunk_rows):
    """The layout the apply kernel gathers from (row chunks, column
    intervals, one packed word per interval and bin) reads the same four
    taps as the direct lookup, at every pixel."""
    x, luts, th, tw = _taps_case(*shape, *grid, seed=sum(shape) + chunk_rows)
    l11, l12, l21, l22 = (t.long() for t in tclahe.lut_taps(x, luts, th, tw))
    want = l11 | (l12 << 8) | (l21 << 16) | (l22 << 24)
    got = tclahe.packed_taps_plain(x, luts, th, tw, chunk_rows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,tile,tiles,chunk_rows", [
    (1080, 135, 8, 24), (64, 4, 16, 24), (97, 13, 8, 5), (40, 40, 1, 16),
    (1, 1, 1, 24), (120, 60, 2, 7),
])
def test_clahe_row_chunks_partition_the_rows(h, tile, tiles, chunk_rows):
    """Chunks tile [0, h) in order, none longer than asked, and every row
    of a chunk blends the chunk's pair of tile rows."""
    ri, _ = tclahe.interp_tables(h, tile, tiles)
    chunks = tclahe.row_chunks(ri, chunk_rows)
    assert chunks.dtype == np.int32 and chunks.shape[1] == 4
    assert chunks[0, 0] == 0 and chunks[-1, 1] == h
    np.testing.assert_array_equal(chunks[1:, 0], chunks[:-1, 1])
    assert (chunks[:, 1] > chunks[:, 0]).all()
    assert (chunks[:, 1] - chunks[:, 0]).max() <= chunk_rows
    for y0, y1, r1, r2 in chunks:
        assert (ri[y0:y1, 0] == r1).all() and (ri[y0:y1, 1] == r2).all()


@pytest.mark.parametrize("w,tile,tiles", [(1920, 240, 8), (161, 54, 3),
                                          (64, 4, 16), (30, 30, 1),
                                          (203, 26, 8)])
def test_clahe_col_intervals_name_the_tile_pair(w, tile, tiles):
    ci, _ = tclahe.interp_tables(w, tile, tiles)
    c = tclahe.col_intervals(ci, tiles)
    assert c.min() >= 0 and c.max() <= tiles
    np.testing.assert_array_equal(np.maximum(c - 1, 0), ci[:, 0])
    np.testing.assert_array_equal(np.minimum(c, tiles - 1), ci[:, 1])


@pytest.mark.parametrize("th,tw", [(135, 240), (4, 4), (61, 54), (7, 16),
                                   (3, 33), (1, 1)])
def test_clahe_tile_pieces_cover_the_tile_once(th, tw):
    """The LUT kernel's pieces: 16 adjacent bytes of one tile row (fewer
    at a ragged right edge), in row-major order, every pixel in exactly
    one piece."""
    pieces = tclahe.tile_pieces(th, tw)
    assert pieces.dtype == np.int32
    assert len(pieces) == th * -(-tw // 16)
    seen = np.zeros((th, tw), np.int32)
    for row, col, nvalid in pieces:
        assert 1 <= nvalid <= 16 and col % 16 == 0
        seen[row, col:col + nvalid] += 1
    assert (seen == 1).all()
    assert (np.diff(pieces[:, 0] * 100000 + pieces[:, 1]) > 0).all()
    if tw % 16 == 0:
        assert (pieces[:, 2] == 16).all()


@pytest.mark.parametrize("name", ["LUT_THREADS", "LUT_PIECE"])
def test_clahe_piece_layout_constants_are_the_kernels(name):
    """The numpy twin of the LUT kernel's layout deals pieces of the
    kernel's size to the kernel's number of threads."""
    import re
    from pathlib import Path
    src = (Path(tclahe.__file__).resolve().parents[1] / "csrc"
           / "clahe.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert found == [str(getattr(tclahe, name))]


@pytest.mark.parametrize("clip_limit", [2.0, 0.0])
@pytest.mark.parametrize("shape,grid,fill", [
    ((2, 96, 128), (4, 4), None),     # tile width 32: whole pieces
    ((2, 120, 161), (2, 3), None),    # padded to 122 x 162: tile width 54
    ((1, 64, 64), (16, 16), None),    # tiles of 4 x 4 pixels, area < 256
    ((1, 270, 480), (2, 2), None),    # 4050 pieces: many per thread
    ((2, 96, 128), (4, 4), 77),       # one value: every piece flat
    ((1, 135, 240), (1, 1), 0),
])
def test_clahe_piece_layout_matches_tile_luts_plain(shape, grid, fill,
                                                    clip_limit):
    """The layout the LUT kernel works in (pieces dealt to 256 threads,
    one histogram per warp, flat pieces added 16 at a time, the scan as
    32 bins per warp plus the warps before) gives the plain LUTs."""
    p = _plane(shape, sum(shape)).astype(np.uint8)
    if fill is not None:
        p[:] = fill
    x = torch.from_numpy(p)
    pad_h, pad_w, th, tw = tclahe.pad_plan(shape[1], shape[2], *grid)
    xe = tclahe._reflect_pad_101(x, pad_h, pad_w)
    clip, scale = tclahe.clip_count(clip_limit, th * tw), \
        tclahe.lut_scale(th * tw)
    want = tclahe.tile_luts_plain(xe, *grid, clip, scale)
    got = tclahe.tile_luts_by_pieces(xe, *grid, clip, scale)
    assert torch.equal(got, want)


@pytest.mark.parametrize("h", [1, 2, 9])
@pytest.mark.parametrize("w", [1, 2, 15, 17, 33])
def test_median3_edge_shapes_bit_equal(h, w):
    rng = np.random.RandomState(100 * h + w)
    x = rng.randint(0, 256, (2, h, w)).astype(np.int32)
    want = np.asarray(jmedian.median_planar_i32(jnp.asarray(x), 3))
    got = tmedian.median_planar(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_median_bit_equal(k):
    rng = np.random.RandomState(40 + k)
    x = rng.randint(0, 256, (3, 37, 53)).astype(np.int32)
    want = np.asarray(jmedian.median_planar_i32(jnp.asarray(x), k))
    got = tmedian.median_planar(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ksize,k", [(2, 3), (4, 5), (11, 9), (1, 3)])
def test_median_ksize_normalisation(ksize, k):
    assert tmedian.normalize_ksize(ksize) == jmedian._normalize_ksize(ksize)
    assert tmedian.normalize_ksize(ksize) == k


def test_median_matches_pallas_kernel():
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (2, 70, 90, 3), dtype=np.uint8)
    want = np.asarray(median3_pallas(img, interpret=True))
    got = tmedian.median_blur_u8(torch.from_numpy(img), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(270, 480), (320, 320), (120, 160),
                                (97, 153), (250, 333)])
@pytest.mark.parametrize("rect", [False, True])
def test_letterbox_matches_jax(hw, rect):
    """slice/avg2/id plans are exact; the general plan (jax linear,
    antialias off) agrees within 5e-5 of [0, 1] — 0.013 of a u8 level —
    from the f32 contraction order."""
    rng = np.random.RandomState(hw[0])
    frames = rng.randint(0, 256, (2, hw[0], hw[1], 3), dtype=np.uint8)
    jfn = jlb.letterbox_rect_u8 if rect else jlb.letterbox_u8
    tfn = tlb.letterbox_rect_u8 if rect else tlb.letterbox_u8
    ji, jr, jp = jfn(jnp.asarray(frames), size=160)
    ti, tr, tp = tfn(torch.from_numpy(frames), size=160)
    assert tuple(ti.shape) == ji.shape
    assert float(tr) == float(jr)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    plans = (tlb.axis_plan(hw[0], round(hw[0] * float(tr))),
             tlb.axis_plan(hw[1], round(hw[1] * float(tr))))
    err = float(np.abs(ti.numpy() - np.asarray(ji)).max())
    assert err <= (5e-5 if ("general",) in plans else 0.0), err
    assert tlb.rect_target_hw(*hw, 160) == jlb.rect_target_hw(*hw, 160)


def test_scale_boxes_matches_jax():
    rng = np.random.RandomState(2)
    boxes = rng.uniform(-20, 700, (3, 10, 4)).astype(np.float32)
    want = np.asarray(jlb.scale_boxes(jnp.asarray(boxes), jnp.float32(1 / 3),
                                      jnp.asarray([0.0, 12.0]), (1080, 1920)))
    got = tlb.scale_boxes(torch.from_numpy(boxes),
                          torch.tensor(1 / 3, dtype=torch.float32),
                          torch.tensor([0.0, 12.0]), (1080, 1920))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def _nms_inputs(seed, b=2, n=400, nc=6):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 300, (b, n, 2))
    wh = rng.uniform(5, 60, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # coarse scores: many exact ties, across and within classes
    scores = (rng.randint(0, 20, (b, n, nc)) / 20.0).astype(np.float32)
    boxes[:, 50:60] = boxes[:, 40:50]            # duplicate boxes
    return boxes, scores


@pytest.mark.parametrize("keep", [None, (0, 2, 5)])
@pytest.mark.parametrize("iou,max_det", [(0.7, 100), (0.45, 300), (0.3, 20)])
def test_nms_keep_sets_equal(keep, iou, max_det):
    boxes, scores = _nms_inputs(int(iou * 100) + max_det)
    kw = dict(conf_thres=0.25, iou_thres=iou, max_det=max_det, pre_topk=300)
    want = jnms.nms_batch(jnp.asarray(boxes), jnp.asarray(scores),
                          classes_keep=keep, **kw)
    got = tnms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores),
                         classes_keep=keep, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms_single_fewer_anchors_than_max_det():
    boxes, scores = _nms_inputs(9, b=1, n=40)
    want = jnms.nms_single(jnp.asarray(boxes[0]), jnp.asarray(scores[0]))
    got = tnms.nms_single(torch.from_numpy(boxes[0]),
                          torch.from_numpy(scores[0]))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("keep", [None, (0, 2, 5)])
@pytest.mark.parametrize("iou,max_det", [(0.7, 100), (0.3, 20)])
def test_nms_batch_return_idx_matches_jax(keep, iou, max_det):
    """The fifth output names each kept entry's source anchor: equal to
    the JAX indices where valid, and it gathers the kept boxes."""
    boxes, scores = _nms_inputs(int(iou * 10) + max_det)
    kw = dict(conf_thres=0.25, iou_thres=iou, max_det=max_det, pre_topk=300,
              classes_keep=keep, return_idx=True)
    want = [np.asarray(w) for w in jnms.nms_batch(
        jnp.asarray(boxes), jnp.asarray(scores), **kw)]
    got = [g.numpy() for g in tnms.nms_batch(
        torch.from_numpy(boxes), torch.from_numpy(scores), **kw)]
    assert len(got) == 5 and got[4].dtype == np.int32
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(g, w)
    valid = got[3]
    assert valid.any()
    np.testing.assert_array_equal(got[4][valid], want[4][valid])
    b_idx = np.nonzero(valid)[0]
    np.testing.assert_array_equal(boxes[b_idx, got[4][valid]], got[0][valid])


@pytest.mark.parametrize("n,max_det,keep", [
    (400, 100, None), (400, 100, (0, 2, 5)), (400, 20, (1,)),
    (40, 100, None), (7, 20, (0, 1, 2, 3, 4, 5)), (100, 100, None)])
def test_select_topk_batch_bit_equal_with_ties(n, max_det, keep):
    """Coarse scores give many exact ties: the lower index must come
    first, as ``jax.lax.top_k`` orders them. N < max_det takes the pad
    branch."""
    boxes, scores = _nms_inputs(n + max_det, b=3, n=n)
    scores[1] = 0.5                       # one image of nothing but ties
    kw = dict(conf_thres=0.25, max_det=max_det, classes_keep=keep)
    want = jnms.select_topk_batch(jnp.asarray(boxes), jnp.asarray(scores),
                                  **kw)
    got = tnms.select_topk_batch(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), **kw)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.shape[1] == max_det
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool
    assert bool(got[3].any())


@pytest.mark.parametrize("hw", [(1080, 1920), (270, 480), (320, 320),
                                (97, 153), (720, 1280), (480, 640)])
@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("size", [640, 160])
def test_letterbox_meta_matches_jax_and_the_transform(hw, rect, size):
    want = jlb.letterbox_meta(*hw, size=size, rect=rect)
    got = tlb.letterbox_meta(*hw, size=size, rect=rect)
    assert got == want and isinstance(got[0], float)
    if hw[0] <= 320:          # and it is what the transform itself returns
        tfn = tlb.letterbox_rect_u8 if rect else tlb.letterbox_u8
        _, ratio, pad = tfn(torch.zeros((1, *hw, 3), dtype=torch.uint8),
                            size=size)
        assert float(ratio) == np.float32(got[0])
        assert tuple(pad.tolist()) == got[1]


@pytest.mark.parametrize("hw,size", [((270, 480), 160), ((480, 480), 160),
                                     ((320, 640), 160), ((97, 153), 64),
                                     ((64, 64), 64), ((250, 333), 160)])
def test_resize_stretch_u8_matches_jitted_jax(hw, size):
    """Against the JAX function under ``jit`` (as decorated): the exact
    plans (slice, 2-tap average, identity) bit for bit; the general plan
    within 5e-5 of [0, 1], as the letterbox."""
    rng = np.random.RandomState(hw[1])
    frames = rng.randint(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(jlb.resize_stretch_u8(jnp.asarray(frames), size=size))
    got = tlb.resize_stretch_u8(torch.from_numpy(frames), size=size)
    assert tuple(got.shape) == want.shape == (2, size, size, 3)
    assert got.dtype == torch.float32
    plans = (tlb.axis_plan(hw[0], size), tlb.axis_plan(hw[1], size))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= (5e-5 if ("general",) in plans else 0.0), (plans, err)
    one = tlb.resize_stretch_u8(torch.from_numpy(frames[0]), size=size)
    np.testing.assert_array_equal(one.numpy()[0], got.numpy()[0])


def _proj_cfg():
    return {"type": "homography",
            "image_points": [[0, 480], [640, 480], [0, 192], [640, 192]],
            "world_points": [[0, 0], [20, 0], [0, 120], [20, 120]],
            "origin": [10.0, 0.0], "max_distance": 60.0}


def test_homography_and_device_projection_match_jax():
    cfg = _proj_cfg()
    jp = jproj.HomographyProjector(cfg)
    tp = tproj.HomographyProjector(cfg, device="cpu")
    np.testing.assert_allclose(tp.H, jp.H, rtol=1e-12)
    rng = np.random.RandomState(4)
    boxes = rng.uniform(0, 640, (5, 7, 4)).astype(np.float32)
    boxes[..., 3] = rng.uniform(150, 480, (5, 7))     # some above horizon
    h_j, o_j, m_j = jp.device_params()
    h_t, o_t, m_t = tp.device_params()
    g_j, v_j = jproj.project_boxes_device(h_j, jnp.asarray(boxes))
    g_t, v_t = tproj.project_boxes_device(h_t, torch.from_numpy(boxes))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-4)
    d_j = np.asarray(jproj.distance_device(g_j, v_j, o_j, m_j))
    d_t = tproj.distance_device(g_t, v_t, o_t, m_t).numpy()
    np.testing.assert_array_equal(np.isnan(d_t), np.isnan(d_j))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-4)
    assert np.nanmax(d_t) <= 60.0
