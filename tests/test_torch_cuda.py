"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (with the reason) where no CUDA device
is present. Run them on a machine with an NVIDIA card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Every check is bit-equality: the kernels and their plain versions are
integer-exact, and the "cv2" blend rounds each float operation alone.
The int8 convolution (``torch._int_mm`` on the card) is bit-equal too up
to its activation (SiLU, ReLU, GELU), which is held within an ulp.
RT-DETR-L's forward (float32, TF32 off), its deformable sampling and the
fog synthesizer run float ops in another order on the card: they are
held to the CPU path within the tolerances stated in each test. The
sampling's backward (K8) sums with atomics in an order that changes from
run to run: it is held to its plain version within K8_RTOL / K8_ATOL.
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


# ---------------------------------------------------------------------------
# the engine around the kernels: state files, the reader-side upload, the
# pinned rings

def _engine_cfg(batch=4):
    from roadvision_tpu_torch.config import DEFAULTS, merge
    h, w = 288, 480
    return merge(DEFAULTS, {
        "preprocess": {"enabled": True, "chain": [
            {"name": "CLAHEDehaze", "params": {}},
            {"name": "MedianDerain", "params": {"ksize": 3}}]},
        "detect": {"enabled": True,
                   "model": "assets/yolov8n_synthetic_256.npz", "imgsz": 160,
                   "max_det": 20, "classes_keep": [2],
                   "compute_dtype": "float32"},
        "tracking": {"enabled": True, "max_staleness": 1.2,
                     "iou_threshold": 0.35, "speed_window": 0.8},
        "geometry": {"enabled": True, "projector": {
            "type": "homography",
            "image_points": [[0, h], [w, h], [0, 115], [w, 115]],
            "world_points": [[0, 0], [20, 0], [0, 120], [20, 120]],
            "origin": [10.0, 0.0], "max_distance": 1000.0}},
        "tpu": {"batch_size": batch, "compute_dtype": "float32"}})


def _batches(n, batch=4):
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    src = SyntheticRoadSource(480, 288, num_vehicles=6)
    return [(np.stack([src.render(k * batch + i) for i in range(batch)]),
             1000.0 + (k * batch + np.arange(batch)) / 30.0)
            for k in range(n)]


def _ids(results):
    return [[d.track_id for d in r.detections] for r in results]


@pytest.mark.parametrize("first,second", [("cuda", "cpu"), ("cpu", "cuda")])
def test_state_saved_on_one_device_loads_on_the_other(dev, tmp_path, first,
                                                      second):
    """Three batches on ``first``, ``save_state``; a fresh engine on
    ``second`` loads the file and goes on with the same identities as
    ``first`` going on by itself; the loaded tensors lie on ``second``
    with the dtypes ``init_state`` uses."""
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.track import init_state
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = _batches(5)
    a = PipelineEngine(_engine_cfg(), device=first)
    for f, t in batches[:3]:
        a.process_batch(f, t, want_proc=False)
    a.save_state(tmp_path / "s.npz")
    b = PipelineEngine(_engine_cfg(), device=second)
    b.load_state(tmp_path / "s.npz")
    ref = init_state(4, second)
    for k, v in b.sort_state._asdict().items():
        assert v.device.type == second and v.dtype == getattr(ref, k).dtype
        assert np.array_equal(v.cpu().numpy(),
                              getattr(a.sort_state, k).cpu().numpy(),
                              equal_nan=True), k
    assert b._t0 == a._t0
    for f, t in batches[3:]:
        want = a.process_batch(f, t, want_proc=False)
        got = b.process_batch(f, t, want_proc=False)
        assert _ids(got) == _ids(want) and any(_ids(got))


@pytest.mark.parametrize("want_proc", [False, True])
def test_stream_with_reader_side_upload_equals_process_batch(dev, want_proc):
    """``stream`` (reader thread uploads through the pinned ring, two
    batches in flight) gives what ``process_batch`` gives for the same
    frames and stamps, bit for bit, a short last batch included."""
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.tools.bench import ReplaySource
    batches = _batches(7)
    frames = [f for f, _ in batches]
    n = 7 * 4 - 2
    eng = PipelineEngine(_engine_cfg(), device=dev)
    got = list(eng.stream(ReplaySource(frames), max_frames=n,
                          want_proc=want_proc))
    assert len(got) == n
    ref = PipelineEngine(_engine_cfg(), device=dev)
    src = ReplaySource(frames)
    want = []
    for k in range(7):
        f, t, m = src.read_batch(4 if k < 6 else 2)
        want += ref.process_batch(f, t, want_proc=want_proc)
    for g, w in zip(got, want):
        assert g.ts == w.ts and g.detections == w.detections
        assert np.array_equal(g.proc, w.proc)
        assert np.array_equal(g.raw, w.raw)
    assert sum(len(r.detections) for r in got) > n
    assert eng.timer.count["upload"] == 7


def test_pinned_ring_is_not_overwritten_under_a_slow_consumer(dev):
    """The consumer sleeps between results while the reader runs ahead:
    every batch must still come out as its own frames gave it (a buffer
    refilled too early would show another batch's frames), and results
    already handed out must not change afterwards."""
    import time

    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.runtime.engine import UPLOAD_SLOTS
    from roadvision_tpu_torch.tools.bench import ReplaySource
    n_batches = 3 * UPLOAD_SLOTS
    frames = [f for f, _ in _batches(n_batches)]
    eng = PipelineEngine(_engine_cfg(), device=dev)
    got, copies = [], []
    for i, r in enumerate(eng.stream(ReplaySource(frames),
                                     max_frames=n_batches * 4)):
        got.append(r)
        copies.append(r.proc.copy())
        if i % 4 == 0:
            time.sleep(0.05)
    ref = PipelineEngine(_engine_cfg(), device="cpu")
    src = ReplaySource(frames)
    for k in range(n_batches):
        f, t, _ = src.read_batch(4)
        for j, w in enumerate(ref.process_batch(f, t)):
            g = got[4 * k + j]
            assert np.array_equal(g.proc, w.proc), (k, j)
            assert np.array_equal(g.proc, copies[4 * k + j]), (k, j)
            assert np.array_equal(g.raw, f[j])
    assert len(eng._upload_ring) == UPLOAD_SLOTS
    assert not any(s.uploaded for s in eng._upload_ring)
    up = [eng.upload(frames[0]) for _ in range(UPLOAD_SLOTS)]
    with pytest.raises(RuntimeError, match="waiting to be dispatched"):
        eng.upload(frames[0])
    assert torch.equal(up[0].frames.cpu(), torch.from_numpy(frames[0]))


@pytest.mark.parametrize("cin,cout,k,stride,groups,pad,hw", [
    (3, 16, 3, 2, 1, None, (64, 96)),      # the v8 stem: K = 27 → 32
    (64, 255, 1, 1, 1, None, (12, 20)),    # the v5 head: N = 255 → 256
    (32, 32, 3, 1, 32, None, (20, 24)),    # depthwise: int32 elementwise
    (3, 16, 6, 2, 1, 2, (64, 96)),         # the v5 6 × 6 stem
    (256, 64, 3, 1, 1, None, (4, 4)),      # K = 2304, M = 16 → 17 rows
    (80, 80, 1, 1, 1, None, (32, 32)),     # a 1 x 1 im2col view of one
])                                         # image: made row-major
def test_int8_conv_on_the_card_equals_the_cpu_path(dev, cin, cout, k, stride,
                                                    groups, pad, hw):
    """``torch._int_mm`` on the card (K and N padded to multiples of 8, M
    past 16 rows): int32 accumulators equal to the CPU path's, the
    dequantised output bit-equal, SiLU (f64, rounded once) within an
    ulp."""
    from roadvision_tpu_torch.models.yolo import quant
    from roadvision_tpu_torch.models.yolo.yolov8 import Conv
    g = torch.Generator().manual_seed(cin + cout + k)
    conv = Conv(cin, cout, k, stride, groups=groups, pad=pad)
    conv.weight.data = torch.randn(conv.weight.shape, generator=g) * 0.1
    conv.bias.data = torch.randn(cout, generator=g) * 0.1
    q = quant.QConv(conv)
    x = torch.randn((1, cin) + hw, generator=g)
    x_i8 = torch.randint(-127, 128, x.shape, generator=g, dtype=torch.int8)
    p = q.pad
    acc = quant.int8_conv(x_i8, q.w_i8, stride, p)
    acc_d = quant.int8_conv(x_i8.to(dev), q.w_i8.to(dev), stride, p)
    assert acc_d.dtype == torch.int32
    assert torch.equal(acc_d.cpu(), acc)
    qd = quant.QConv(conv).to(dev)
    for act in (False, True):
        q.act = qd.act = act
        want, got = q(x), qd(x.to(dev)).cpu()
        if act:
            assert torch.allclose(got, want, rtol=1.2e-7, atol=0.0)
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
def test_int8_conv_activations_on_the_card_equal_the_cpu_path(dev, act):
    """``QConv`` with each of ``conv_i8``'s activations (RT-DETR's convs):
    the card's output within an ulp of the CPU path's (the activation in
    f64, rounded once; GELU as x·σ(2z), which does not cancel), bit-equal
    without one."""
    from roadvision_tpu_torch.models import rtdetr
    from roadvision_tpu_torch.models.yolo import quant
    g = torch.Generator().manual_seed(7)
    conv = rtdetr.Conv(48, 32, 3, 1, act=act)
    conv.weight.data = torch.randn(conv.weight.shape, generator=g) * 0.1
    conv.bias.data = torch.randn(32, generator=g) * 0.1
    q, qd = quant.QConv(conv), quant.QConv(conv).to(dev)
    x = torch.randn((2, 48, 20, 24), generator=g)
    want, got = q(x), qd(x.to(dev)).cpu()
    if act is None:
        assert torch.equal(got, want)
    else:
        assert torch.allclose(got, want, rtol=1.2e-7, atol=1e-30)


@pytest.mark.parametrize("bf16_vals", [False, True])
def test_deform_attn_on_the_card_equals_the_cpu_path(dev, bf16_vals):
    from roadvision_tpu_torch.models import rtdetr as T
    g = torch.Generator().manual_seed(3)
    p = T.DeformAttn()
    for lin in (p.off, p.attw, p.val, p.out):
        lin.weight.data = torch.randn(lin.weight.shape, generator=g) * 0.1
    shapes = [(20, 20), (10, 10), (5, 5)]
    n = sum(a * b for a, b in shapes)
    args = (torch.randn(2, 100, T.HD, generator=g),
            torch.rand(2, 100, 4, generator=g) * 0.9 + 0.05,
            torch.randn(2, n, T.NH, T.HD // T.NH, generator=g))
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        want = T.deform_attn(p, *args, shapes, bf16_vals=bf16_vals)
        got = T.deform_attn(p.to(dev), *(a.to(dev) for a in args), shapes,
                            bf16_vals=bf16_vals).cpu()
    assert (got - want).abs().max() < 1e-4


def test_rtdetr_forward_on_the_card_equals_the_cpu_path(dev):
    """RT-DETR-L from the asset in float32 (TF32 off) at 2 × 128²: the
    encoder's top-100 anchors equal, boxes and scores within 1e-4."""
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    from roadvision_tpu_torch.models import rtdetr as T
    tree, _, _ = T.load_params_rtdetr("assets/rtdetr_l_synthetic_256.npz")
    cpu = T.model_from_params(tree).eval()
    gpu = T.model_from_params(tree).eval().to(dev)
    src = SyntheticRoadSource(128, 128, num_vehicles=5, seed=0)
    x = torch.from_numpy(np.stack([src.render(5 * i) for i in range(2)])
                         [..., ::-1].astype(np.float32) / 255.0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        k_cpu = cpu.dec.proposals(cpu.features(x), 100)[3]
        k_gpu = gpu.dec.proposals(gpu.features(x.to(dev)), 100)[3].cpu()
        b_cpu, s_cpu = cpu(x, num_queries=100)
        b_gpu, s_gpu = gpu(x.to(dev), num_queries=100)
    assert torch.equal(k_gpu, k_cpu)
    assert (b_gpu.cpu() - b_cpu).abs().max() < 1e-4
    assert (s_gpu.cpu() - s_cpu).abs().max() < 1e-4


def test_fog_synthesis_on_the_card_equals_the_cpu_path(dev):
    """The synthesizer on the card: the same RandomState draws, uint8
    output within the bound tests/test_torch_fog.py holds it to against
    the JAX synthesizer (≤ 2 levels in ≤ 0.1 % of the pixels)."""
    from roadvision_tpu_torch.augment.fog import (CLI_OVERRIDES,
                                                  EnhancedFogSynthesizer)
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    img = SyntheticRoadSource(320, 240, num_vehicles=5, seed=0).render(4)
    outs = [EnhancedFogSynthesizer(level="heavy", seed=5, device=d,
                                   **CLI_OVERRIDES).synthesize(img)[0]
            for d in ("cpu", dev)]
    diff = np.abs(outs[0].astype(np.int32) - outs[1].astype(np.int32))
    assert diff.max() <= 2 and (diff > 0).mean() <= 1e-3


# the tracker family, GMC and the gate: torch ops on the card against the
# CPU path (TF32 off), ids equal, the Kalman state within rtol 1e-5,
# atol 1e-4, the appearance memory within 1e-5, shifts and gate decisions
# equal (this file imports no JAX: the card's machine has none)

@pytest.fixture
def no_tf32():
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = old


def _track_sequence(n_frames=24, d=12, n=8, seed=7):
    """Moving boxes of distinct sizes (one hidden for a while), varying
    confidences, per-identity descriptors with noise, a camera pan."""
    from roadvision_tpu_torch.track.appearance import EMB_DIM
    rng = np.random.RandomState(seed)
    pos = rng.uniform(40, 520, (n, 2))
    vel = rng.uniform(-7, 7, (n, 2))
    size = rng.uniform(30, 90, (n, 2))
    ident = rng.normal(size=(n, EMB_DIM))
    cam, t = np.zeros(2), 0.0
    for f in range(n_frames):
        shift = rng.uniform(-6, 6, 2).round() if f else np.zeros(2)
        cam += shift
        t += 1 / 30
        boxes = np.zeros((d, 4), np.float32)
        conf = np.zeros(d, np.float32)
        emb = np.zeros((d, EMB_DIM), np.float32)
        valid = np.zeros(d, bool)
        for slot, k in enumerate(k for k in range(n)
                                 if not (k == 3 and 6 <= f < 12)):
            xy = pos[k] + vel[k] * f + cam
            boxes[slot] = (*xy, *(xy + size[k]))
            conf[slot] = rng.choice([rng.uniform(0.62, 0.98),
                                     rng.uniform(0.15, 0.45)], p=[.8, .2])
            e = ident[k] + rng.normal(0, 0.15, EMB_DIM)
            emb[slot] = e / np.linalg.norm(e)
            valid[slot] = True
        yield (boxes, np.full(d, 2, np.int32), conf, valid,
               np.float32(t)), emb, shift.astype(np.float32)


@pytest.mark.parametrize("cfg", [
    {}, {"association": "hungarian"}, {"backend": "bytetrack"},
    {"backend": "ocsort"}, {"backend": "deepsort"},
    {"backend": "strongsort"}, {"backend": "botsort"}])
def test_tracker_step_on_the_card_equals_the_cpu_path(dev, no_tf32, cfg):
    from roadvision_tpu_torch.track import registry as treg
    from roadvision_tpu_torch.track import sort as tsort
    step = treg.build_device_step(dict(cfg, max_staleness=1.2,
                                       speed_window=0.8))
    needs_emb = getattr(step, "needs_embeddings", False)
    states = {d: tsort.init_state(24, device=d) for d in ("cpu", dev)}
    for args, emb, shift in _track_sequence():
        outs = {}
        for d in states:
            states[d], outs[d] = step(
                states[d], *(torch.from_numpy(np.asarray(a)).to(d)
                             for a in args), None,
                torch.from_numpy(emb).to(d) if needs_emb else None,
                torch.from_numpy(shift).to(d))
        assert torch.equal(outs[dev].track_id.cpu(), outs["cpu"].track_id)
    for k in tsort.SortState._fields:
        a, b = getattr(states[dev], k).cpu(), getattr(states["cpu"], k)
        if k == "app":
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        elif a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-4, equal_nan=True, err_msg=k)
        else:
            assert torch.equal(a, b), k
    assert int(states[dev].next_id) > 6


def test_reid_and_gmc_on_the_card_equal_the_cpu_path(dev, no_tf32):
    from roadvision_tpu_torch.track import gmc as tgmc
    from roadvision_tpu_torch.track import reid as treid
    rng = np.random.RandomState(8)
    frame = rng.randint(0, 256, (96, 160, 3), np.uint8)
    xy = rng.uniform(-10, 80, (7, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(3, 60, (7, 2))], 1) \
        .astype(np.float32)
    p = {d: treid.load_reid_params("assets/reid_synthetic.npz", device=d)
         for d in ("cpu", dev)}
    got = {d: treid.reid_embeddings(
        p[d], torch.from_numpy(frame).to(d), torch.from_numpy(boxes).to(d),
        torch.ones(7, dtype=torch.bool, device=d)).cpu().numpy() for d in p}
    np.testing.assert_allclose(got[dev], got["cpu"], atol=1e-5)
    tex = torch.nn.functional.avg_pool2d(
        torch.from_numpy(rng.rand(3, 264, 392)).float()[None] * 255, 9, 1)[0]
    base = tex.permute(1, 2, 0).to(torch.uint8).numpy()    # 256 x 384
    rolls = [(0, 0), (3, -2), (-7, 5), (8, 0)]
    frames = np.stack([np.roll(base, (dy * 2, dx * 3), axis=(0, 1))
                       for dx, dy in rolls])
    shifts = {}
    for d in ("cpu", dev):
        g = tgmc.gray_thumbnail(torch.from_numpy(frames).to(d))
        shifts[d] = tgmc.batch_shifts(g[0], g[1:], torch.tensor(
            1.0, device=d), (3, 2)).cpu().numpy()
    np.testing.assert_array_equal(shifts[dev], shifts["cpu"])
    np.testing.assert_array_equal(shifts["cpu"], np.diff(
        np.array(rolls, np.float32), axis=0) * (3, 2))


def test_gate_on_the_card_equals_the_cpu_path(dev, no_tf32):
    from roadvision_tpu_torch.runtime import PipelineEngine
    cfg = {"detect": {"enabled": True,
                      "model": "assets/yolov8n_synthetic_256.npz",
                      "imgsz": 64, "conf_thres": 1e-6, "max_det": 8,
                      "compute_dtype": "float32",
                      "temporal_gate": {"enable": True,
                                        "max_skip_batches": 3}},
           "tracking": {"enabled": True}, "preprocess": {"enabled": False},
           "tpu": {"batch_size": 2, "compute_dtype": "float32"}}
    base = np.random.RandomState(0).randint(0, 255, (48, 64, 3), np.uint8)
    clip = [(np.stack([base, base]), 0.1 * i + np.arange(2) / 30)
            for i in range(6)]
    clip += [(np.stack([np.roll(base, 5 * (2 * i + j), axis=1)
                        for j in range(2)]), 1 + 0.1 * i + np.arange(2) / 30)
             for i in range(3)]
    eng = {d: PipelineEngine(cfg, device=d) for d in ("cpu", dev)}
    res = {d: [r for f, t in clip for r in e.process_batch(f, t)]
           for d, e in eng.items()}
    assert eng[dev].gate_frames_coasted == eng["cpu"].gate_frames_coasted > 0
    for a, b in zip(res[dev], res["cpu"]):
        assert [(d.cls_id, d.track_id) for d in a.detections] == \
            [(d.cls_id, d.track_id) for d in b.detections]
        for da, db in zip(a.detections, b.detections):
            assert abs(da.x1 - db.x1) < 0.05 and abs(da.conf - db.conf) < 2e-3


# the camera fleet: the fleet step on the card, and the kernels at the
# fleet's folded shapes (S·B planes: 4 streams x 8 frames)

def test_fleet_step_on_the_card_equals_the_cpu_path(dev, no_tf32):
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import MultiStreamEngine
    from roadvision_tpu_torch.runtime.graph import WARMUP_CALLS
    cfg = merge(_engine_cfg(batch=2), {"tpu": {"mesh": {"enable": True}}})
    s = 3
    clip = _batches(2 * s, batch=2)
    fleet = [(np.stack([clip[k * s + i][0] for i in range(s)]),
              np.stack([clip[k * s + i][1] for i in range(s)]))
             for k in range(2)]
    eng = {d: MultiStreamEngine(cfg, s, devices=[d]) for d in ("cpu", dev)}
    launch_counts.update({k: 0 for k in launch_counts})
    got = [eng[dev].process_batch(f, t) for f, t in fleet]
    # one launch of each kernel per fleet step, not per stream; the
    # stacked tracker's association once a frame for all streams; two
    # fleet batches and the warm-up steps of the graph's capture
    steps = 2 + WARMUP_CALLS
    assert launch_counts == {"clahe_tile_luts": steps, "clahe_apply": steps,
                             "median_k": steps, "nms_keep": steps,
                             "assoc_greedy": 2 * steps, "assoc_auction": 0,
                             "deform_sample": 0, "deform_sample_bwd": 0}
    want = [eng["cpu"].process_batch(f, t) for f, t in fleet]
    n = 0
    for g, w in zip(got, want):
        for gs, ws in zip(g, w):
            assert _ids(gs) == _ids(ws)
            for a, b in zip(gs, ws):
                for da, db in zip(a.detections, b.detections):
                    assert max(abs(p - q) for p, q in zip(
                        (da.x1, da.y1, da.x2, da.y2),
                        (db.x1, db.y1, db.x2, db.y2))) < 0.05
                    assert abs(da.conf - db.conf) < 2e-3
                    n += 1
    assert n > 0


def test_fleet_short_last_batch_through_the_pinned_ring(dev):
    """A clip whose length is not a multiple of the batch: the fleet's
    short last batch (S, m < B, H, W, 3) is uploaded while the full batch
    before it still waits to be dispatched, and ``stream`` at 1.5 batches
    ends on it; both give what ``process_batch`` gives, bit for bit."""
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import MultiStreamEngine
    from roadvision_tpu_torch.tools.bench import ReplaySource
    cfg = merge(_engine_cfg(batch=4), {"tpu": {"mesh": {"enable": True}}})
    s, m = 3, 2
    clip = [f for f, _ in _batches(2 * s)]

    def sources():
        return [ReplaySource([clip[i], clip[s + i]]) for i in range(s)]

    reads = [[src.read_batch(n) for n in (4, m)] for src in sources()]
    fleet = [(np.stack([r[k][0] for r in reads]),
              np.stack([r[k][1] for r in reads])) for k in range(2)]
    ref = MultiStreamEngine(cfg, s, devices=[dev])
    want = [ref.process_batch(f, t) for f, t in fleet]
    eng = MultiStreamEngine(cfg, s, devices=[dev])
    ups = [eng.upload(f) for f, _ in fleet]     # both queued at once
    got = [eng.collect_batch(eng.dispatch_batch(f, t, up))
           for (f, t), up in zip(fleet, ups)]
    eng.reset()
    streamed = list(eng.stream(sources(), max_frames=4 + m))
    assert [len(g[0]) for g in streamed] == [4, m]
    for g, st, w in zip(got, streamed, want):
        for gs, ss, ws in zip(g, st, w):
            assert [r.detections for r in gs] == [r.detections for r in ws]
            assert [r.detections for r in ss] == [r.detections for r in ws]
    assert any(r.detections for ws in want[1] for r in ws)


@pytest.mark.parametrize("h,w", [(720, 1280), (1080, 1920)])
def test_kernels_bit_equal_at_fleet_shapes(dev, h, w):
    n = 32                                   # S·B luma planes
    plane = _plane((n, h, w), 5, dev)
    pad_h, pad_w, th, tw = C.pad_plan(h, w, 8, 8)
    xe = C._reflect_pad_101(plane, pad_h, pad_w)
    clip, scale = C.clip_count(2.0, th * tw), C.lut_scale(th * tw)
    luts = C.clahe_tile_luts(xe, 8, 8, clip, scale)
    assert torch.equal(luts, C.tile_luts_plain(xe, 8, 8, clip, scale))
    assert torch.equal(C.clahe_apply(plane, luts, th, tw, "cv2"),
                       C.apply_plain(plane, luts, th, tw, "cv2"))
    planes = _plane((3 * n, h, w), 6, dev)   # 3 colour planes a frame
    assert torch.equal(M.median_planes(planes, 3), M.median_plain(planes, 3))


# --- multi-card parallelism (parallel/) ------------------------------------
# Over one card repeated and, where two cards or more are visible, over
# distinct cards, float32 with TF32 off: the dp x tp step against one
# replica at the CPU tests' tolerances (loss rtol 1e-5, parameters and
# momentum rtol 2e-4, atol 2e-6); pipelines and row bands against the
# plain forward within 1e-2 px and 1e-4 (cuDNN may pick another
# algorithm for a microbatch's or a band's shape), RT-DETR's normalised
# boxes within 1e-4 and its scores within 1e-3 (chip_smoke.py's bounds).

def _cards(dev, k, distinct):
    if not distinct:
        return [torch.device("cuda", torch.cuda.current_device())] * k
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(k)]


def _close_outputs(got, want, box_atol=1e-2, score_atol=1e-4):
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=0, atol=box_atol)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=0, atol=score_atol)


@pytest.mark.parametrize("distinct", [False, True])
def test_dp_tp_step_on_the_card_equals_one_replica(dev, no_tf32, distinct):
    from roadvision_tpu_torch.detect import dataset as ds
    from roadvision_tpu_torch.models.yolo import train as T
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.parallel import (DataParallelStep, make_mesh,
                                               merge_shards)
    tree = W.import_npz("assets/yolov8n_synthetic_256.npz")
    imgs, *gts = next(ds.synthetic_batches(4, imgsz=64, seed=3))
    batch = (torch.from_numpy(imgs).to(dev).float() / 255.0,
             *(torch.from_numpy(np.asarray(g)).to(dev) for g in gts))

    def model():
        return W.model_from_params(tree).set_compute_dtype(
            torch.float32).to(dev)

    step = T.make_train_step(lr=1e-3)
    single = model()
    mom = step.init(single)
    loss, aux = step(single, mom, *batch)
    mesh = make_mesh(model_parallel=2, devices=_cards(dev, 8, distinct))
    dp = DataParallelStep(step, model(), mesh)
    dloss, daux = dp(*batch)
    np.testing.assert_allclose(float(dloss), float(loss), rtol=1e-5)
    assert int(daux["num_fg"]) == int(aux["num_fg"]) > 0
    for want, got in ((single.state_dict(), dp.model.state_dict()),
                      (mom, dp.state)):
        got = merge_shards(got)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.cpu().numpy(),
                                       rtol=2e-4, atol=2e-6, err_msg=k)
    for others in dp.params[1:]:
        for a, b in zip(dp.params[0], others):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("distinct", [False, True])
def test_pipelines_on_the_card_equal_the_plain_forward(dev, no_tf32,
                                                       distinct):
    from roadvision_tpu_torch.models import rtdetr
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.parallel import PipelinedRTDETR, PipelinedYOLO
    from roadvision_tpu_torch.parallel.pipeline import v8_detect_model
    rng = np.random.RandomState(0)
    v8 = W.import_npz("assets/yolov8n_synthetic_256.npz")
    x = torch.from_numpy(rng.rand(4, 128, 192, 3).astype(np.float32)).to(dev)
    devs = _cards(dev, 4, distinct)
    with torch.inference_mode():
        want = v8_detect_model(v8, "n", 80, torch.float32).to(dev)(x)
        for n in (2, 4):
            got = PipelinedYOLO(v8, "n", 80, n, devs)(x)
            assert got[0].device == devs[n - 1]
            _close_outputs(got, want)
    rt = W.import_npz("assets/rtdetr_l_synthetic_256.npz")
    xr = torch.from_numpy(rng.rand(2, 160, 160, 3).astype(np.float32)) \
        .to(dev)
    with torch.inference_mode():
        want = rtdetr.model_from_params(rt).to(dev).eval()(
            xr, num_queries=rtdetr.NQ)
        got = PipelinedRTDETR(rt, rtdetr.nc_of(rt), 2, devs)(xr)
    _close_outputs(got, want, 1e-4, 1e-3)


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("h,w,k", [(256, 192, 8), (224, 160, 8),
                                   (640, 384, 4)])
def test_row_bands_on_the_card_equal_the_plain_forward(dev, no_tf32,
                                                       distinct, h, w, k):
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.parallel import (make_mesh,
                                               make_spatial_forward,
                                               spatial_sharding)
    from roadvision_tpu_torch.parallel.pipeline import v8_detect_model
    v8 = W.import_npz("assets/yolov8n_synthetic_256.npz")
    x = torch.from_numpy(np.random.RandomState(1).rand(1, h, w, 3).astype(
        np.float32)).to(dev)
    mesh = make_mesh(devices=_cards(dev, k, distinct))
    assert len(spatial_sharding(mesh, x).parts) == min(k, h // 32)
    with torch.inference_mode():
        _close_outputs(make_spatial_forward("n", 80, mesh)(v8, x),
                       v8_detect_model(v8, "n", 80, torch.float32).to(dev)(x))


# the host-free device step: the association and NMS loops as kernels
# (K4-K6), bit-equal to their plain versions, and the step replayed from a
# CUDA graph against the eager step

def _assoc_case(name, p, t, d, seed):
    rng = np.random.RandomState(seed)
    iou = rng.uniform(0, 1, (p, t, d)).astype(np.float32)
    alive = rng.rand(p, t) < 0.7
    dvalid = rng.rand(p, d) < 0.8
    if name == "ties":
        iou = (rng.randint(0, 4, (p, t, d)) / 4.0).astype(np.float32)
    elif name == "chain":
        # a strictly descending staircase: one pair a round
        i, j = np.indices((t, d))
        iou = np.where(np.abs(i - j) <= 1, 0.99 - 0.009 * np.minimum(i, j)
                       - 0.004 * (i != j), 0.0).astype(np.float32)
        iou = np.broadcast_to(iou, (p, t, d)).copy()
        alive[:], dvalid[:] = True, True
    elif name == "invalid":
        alive[:] = False
        dvalid[1::2] = False
    elif name == "nan":
        iou[rng.rand(p, t, d) < 0.02] = np.nan
    return iou, alive, dvalid


@pytest.mark.parametrize("name,p,t,d", [
    ("random", 8, 100, 100), ("ties", 4, 100, 100), ("chain", 2, 100, 100),
    ("invalid", 3, 100, 100), ("nan", 4, 100, 100), ("random", 5, 7, 130),
    ("ties", 1, 160, 40), ("random", 2, 300, 300), ("ties", 2, 300, 300),
    ("chain", 1, 300, 300)])
def test_association_kernels_bit_equal(dev, name, p, t, d):
    from roadvision_tpu_torch.track import sort as tsort
    host = _assoc_case(name, p, t, d, p * t + d)
    args = [torch.from_numpy(a).to(dev) for a in host]
    for wrapper, plain, key in (
            (tsort.greedy_associate, tsort.greedy_associate_plain,
             "assoc_greedy"),
            (tsort.auction_associate, tsort.auction_associate_plain,
             "assoc_auction")):
        before = launch_counts[key]
        got = wrapper(*args, 0.3)
        assert launch_counts[key] == before + 1
        want = plain(*[torch.from_numpy(a) for a in host], 0.3)
        assert torch.equal(got.cpu(), want), (name, key)
        for i in range(p):          # one problem alone: the same rows
            assert torch.equal(wrapper(*(a[i] for a in args), 0.3).cpu(),
                               want[i])


@pytest.mark.parametrize("name,b,k", [("random", 8, 300), ("all", 2, 300),
                                      ("none", 2, 300), ("chain", 3, 300),
                                      ("random", 2, 600), ("random", 1, 33),
                                      ("random", 1, 1024)])
def test_nms_keep_kernel_bit_equal(dev, name, b, k):
    from roadvision_tpu_torch.ops import nms as tnms
    rng = np.random.RandomState(b * k)
    over = rng.rand(b, k, k) < 0.05
    over = over | over.transpose(0, 2, 1)
    valid = rng.rand(b, k) < 0.9
    if name == "all":
        over[:] = True
    elif name == "none":
        valid[:] = False
    elif name == "chain":
        i, j = np.indices((k, k))
        over[:] = np.abs(i - j) == 1
        valid[:] = True
    before = launch_counts["nms_keep"]
    got = tnms.greedy_keep(torch.from_numpy(over).to(dev),
                           torch.from_numpy(valid).to(dev))
    assert launch_counts["nms_keep"] == before + 1
    want = tnms.greedy_keep_plain(torch.from_numpy(over),
                                  torch.from_numpy(valid))
    assert torch.equal(got.cpu(), want)


def _box_assoc_case(name, p, t, d):
    """K4 boxes-mode inputs: ``name`` road (live slots spread over t,
    predicting boxes near a valid prefix of detections), dense (most of
    the slots and detections live, overlapping), at threshold (IoU
    exactly 0.5 or 0.25 in float32), ties (twin tracks and detections),
    nan (NaN, infinite and zero-area boxes), invalid → (mean, boxes,
    alive, dvalid, thresh)."""
    rng = np.random.RandomState(p * t + d + len(name))
    live_t, live_d = (max(1, t * 4 // 5), max(1, d * 4 // 5)) \
        if name == "dense" else (max(1, t // 5), max(1, d // 6))
    n = max(live_t, live_d)
    xy = rng.uniform(0, 1800, (p, n, 2))
    wh = rng.uniform(40, 200, (p, n, 2))
    mean = rng.normal(0, 50, (p, t, 7)).astype(np.float32)
    alive = np.zeros((p, t), bool)
    for i in range(p):
        slots = rng.choice(t, live_t, replace=False)
        mean[i, slots, :2] = xy[i, :live_t] + wh[i, :live_t] / 2
        mean[i, slots, 2] = wh[i, :live_t, 0] * wh[i, :live_t, 1]
        mean[i, slots, 3] = wh[i, :live_t, 0] / wh[i, :live_t, 1]
        alive[i, slots] = True
    boxes = np.zeros((p, d, 4), np.float32)
    dxy = xy[:, :live_d] + rng.normal(0, 6, (p, live_d, 2))
    boxes[:, :live_d] = np.concatenate([dxy, dxy + wh[:, :live_d]], -1)
    dvalid = np.zeros((p, d), bool)
    dvalid[:, :live_d] = True
    thresh = 0.1 if name == "dense" else 0.35
    if name.startswith("at threshold"):
        mean[:, :, :4] = (5, 5, 100, 1)
        mean[:, :, 0] += np.arange(t) * 100.0
        shapes = np.array([[0, 0, 10, 5], [0, 0, 10, 2.5], [0, 0, 5, 5]],
                          np.float32)
        boxes = shapes[rng.randint(0, 3, (p, d))]
        boxes[..., ::2] += np.arange(d)[:, None] * 100.0
        alive[:], dvalid[:] = True, True
        thresh = float(name.split()[-1])
    elif name == "ties":
        mean[:, 1::2] = mean[:, 0::2]
        boxes[:, 1::2] = boxes[:, 0::2]
        alive |= np.roll(alive, 1, 1)
    elif name == "nan":
        mean[:, 3::7, 2] = 0.0
        mean[:, 5::11, 0] = np.nan
        mean[:, 6::13, 3] = np.inf
        boxes[:, 2::5, 2] = boxes[:, 2::5, 0]
        boxes[:, 4::9, 1] = np.nan
        boxes[:, 8::9, 3] = np.inf
    elif name == "invalid":
        alive[0::2] = False
        dvalid[1::2] = False
    return mean, boxes, alive, dvalid, thresh


@pytest.mark.parametrize("name,p,t,d", [
    ("road", 1, 100, 100), ("road", 8, 100, 100),
    ("at threshold 0.5", 2, 100, 100), ("at threshold 0.25", 2, 100, 100),
    ("ties", 4, 100, 100), ("nan", 4, 100, 100), ("invalid", 3, 100, 100),
    ("road", 3, 7, 130), ("road", 2, 300, 300), ("dense", 2, 300, 300),
    ("road", 1, 1024, 1024)])
def test_association_boxes_mode_bit_equal(dev, name, p, t, d):
    """K4's boxes mode (x_to_bbox, IoU, rounds, inverse map in one launch)
    against greedy_associate_boxes_plain: both maps bit-equal; at 300 and
    1024 the cells are recomputed from the boxes."""
    from roadvision_tpu_torch.track import sort as tsort
    *host, thresh = _box_assoc_case(name, p, t, d)
    before = launch_counts["assoc_greedy"]
    got = tsort.greedy_associate_boxes(
        *[torch.from_numpy(a).to(dev) for a in host], thresh)
    assert launch_counts["assoc_greedy"] == before + 1
    want = tsort.greedy_associate_boxes_plain(
        *[torch.from_numpy(a) for a in host], thresh)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), name
    if name not in ("invalid",):
        assert bool((want[0] >= 0).any())


# K5 in its three modes: matrix (scores), boxes (x_to_bbox and the IoU in
# the launch) and matcher (RT-DETR training's cost, no dummy columns)

def _auction_case(mode, name, p, t, d):
    """K5 inputs → (host arrays, keyword arguments): matrix and boxes as
    the K4 cases above plus ``cap`` (max_iters 3), ``floor`` (a bidder whose
    alternatives are all below -1e9: its second best is exactly -1e9),
    ``inf`` (±inf and ±0 scores) and ``global`` (T, D in the thousands: the
    state outgrows shared memory and lives in the workspace); matcher: t
    queries, d gts, a random cost with masked gts, and ``floor``, ``cap``,
    ``nan``."""
    rng = np.random.RandomState(p * t + d + len(name) + len(mode))
    kw = {"eps": 0.01, "max_iters": 512}
    if mode == "matcher":
        cost = rng.uniform(0, 20, (p, d, t)).astype(np.float32)
        mask = rng.rand(p, d) < 0.8
        kw = {"eps": 1e-3, "max_iters": 1024}
        if name == "floor":
            # gt 0's runner-up is -1.5e9, gt 1's -3e9: with the floor both
            # bid 1e9 + eps and gt 0 (first) wins query 0; without it gt 1
            cost = np.float32([[[0, 1.5e9], [0, 3e9]]]).repeat(p, 0)
            mask = np.ones((p, 2), bool)
        elif name == "cap":
            kw["max_iters"] = 5
        elif name == "nan":
            cost[rng.rand(*cost.shape) < 0.02] = np.nan
            cost[rng.rand(*cost.shape) < 0.01] = np.inf
        return (cost, mask), kw
    if mode == "boxes":
        if name == "global":
            *host, thresh = _box_assoc_case("road", p, t, d)
        elif name == "cap":
            *host, thresh = _box_assoc_case("dense", p, t, d)
            kw["max_iters"] = 3
        else:
            *host, thresh = _box_assoc_case(name, p, t, d)
        return tuple(host), dict(kw, thresh=thresh)
    if name == "cap":
        host = _assoc_case("random", p, t, d, p * t + d)
        kw["max_iters"] = 3
    elif name == "floor":
        # a live track scored -inf and a second bidder: after the first
        # round's dummy is priced 1e10, the second bidder's runner-up is
        # below -1e9
        iou = np.full((p, t, d), -np.inf, np.float32)
        host = (iou, np.ones((p, t), bool), np.ones((p, d), bool))
        kw["eps"] = 1e10
    elif name == "inf":
        iou = rng.choice(np.float32([np.inf, -np.inf, 0.0, -0.0, 0.5,
                                     np.nan]), (p, t, d),
                         p=[0.02, 0.05, 0.3, 0.3, 0.32, 0.01])
        host = (iou.astype(np.float32), rng.rand(p, t) < 0.8,
                rng.rand(p, d) < 0.9)
    elif name == "global":
        # 150 live tracks, each overlapping one of 150 valid detections
        # (a few rounds: the plain version's rounds cost seconds here)
        iou = np.zeros((p, t, d), np.float32)
        n = np.arange(150)
        iou[:, n, n] = rng.uniform(0.5, 1, (p, 150))
        alive = np.zeros((p, t), bool)
        dvalid = np.zeros((p, d), bool)
        alive[:, :150] = dvalid[:, :150] = True
        host = (iou, alive, dvalid)
    else:
        host = _assoc_case(name, p, t, d, p * t + d)
    return host, dict(kw, thresh=0.3)


def _auction_fns(mode):
    """(kernel wrapper, plain version) of a K5 mode; each takes the host
    arrays' tensors and the case's keyword arguments and gives a tuple."""
    from roadvision_tpu_torch.models import rtdetr_train as RT
    from roadvision_tpu_torch.track import sort as tsort
    if mode == "matcher":
        return ((lambda *a, **k: (RT.hungarian_match(*a, **k),)),
                (lambda *a, **k: (RT.hungarian_match_plain(*a, **k),)))
    if mode == "boxes":
        return tsort.auction_associate_boxes, \
            tsort.auction_associate_boxes_plain
    return ((lambda *a, **k: (tsort.auction_associate(*a, **k),)),
            (lambda *a, **k: (tsort.auction_associate_plain(*a, **k),)))


AUCTION_CASES = [
    ("matrix", "random", 8, 100, 100), ("matrix", "ties", 4, 100, 100),
    ("matrix", "chain", 2, 100, 100), ("matrix", "invalid", 3, 100, 100),
    ("matrix", "nan", 4, 100, 100), ("matrix", "random", 5, 7, 130),
    ("matrix", "ties", 1, 160, 40), ("matrix", "random", 2, 300, 300),
    ("matrix", "chain", 1, 300, 300), ("matrix", "cap", 2, 300, 300),
    ("matrix", "floor", 2, 1, 2), ("matrix", "inf", 3, 64, 80),
    ("matrix", "global", 1, 4000, 4000),
    ("boxes", "road", 1, 100, 100), ("boxes", "road", 8, 100, 100),
    ("boxes", "at threshold 0.5", 2, 100, 100),
    ("boxes", "ties", 4, 100, 100), ("boxes", "nan", 4, 100, 100),
    ("boxes", "invalid", 3, 100, 100), ("boxes", "road", 3, 7, 130),
    ("boxes", "dense", 2, 300, 300), ("boxes", "cap", 2, 300, 300),
    ("boxes", "road", 1, 1024, 1024), ("boxes", "global", 1, 2500, 2500),
    ("matcher", "random", 28, 300, 50), ("matcher", "random", 4, 300, 290),
    ("matcher", "random", 2, 64, 64), ("matcher", "random", 3, 1, 1),
    ("matcher", "floor", 2, 2, 2), ("matcher", "cap", 4, 300, 50),
    ("matcher", "nan", 4, 300, 50)]


@pytest.mark.parametrize("mode,name,p,t,d", AUCTION_CASES)
def test_auction_modes_bit_equal(dev, mode, name, p, t, d):
    """K5 in each mode against its plain version, bit for bit; one launch
    a call; each problem alone equal to the batch."""
    host, kw = _auction_case(mode, name, p, t, d)
    kernel, plain = _auction_fns(mode)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host]
    before = launch_counts["assoc_auction"]
    got = kernel(*args, **kw)
    assert launch_counts["assoc_auction"] == before + 1
    want = plain(*[torch.from_numpy(np.ascontiguousarray(a)) for a in host],
                 **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), (mode, name)
    for i in range(min(p, 4)):
        one = kernel(*(a[i:i + 1] for a in args), **kw)
        for g, w in zip(one, want):
            assert torch.equal(g.cpu()[0], w[i]), (mode, name, i)
    if name != "invalid" and (mode, name) != ("matrix", "floor"):
        assert bool((want[0] >= 0).any())     # (floor: every score -inf)


@pytest.mark.parametrize("mode,name,p,t,d", [
    ("matrix", "random", 8, 100, 100), ("matrix", "random", 2, 300, 300),
    ("boxes", "road", 1, 100, 100), ("boxes", "dense", 2, 300, 300),
    ("matcher", "random", 28, 300, 50)])
def test_auction_modes_replay_in_a_graph(dev, mode, name, p, t, d):
    """Each mode captured into a CUDA graph replays the eager result; a
    replay launches once (the count is the wrapper's, at capture)."""
    host, kw = _auction_case(mode, name, p, t, d)
    kernel, _ = _auction_fns(mode)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host]
    eager = [g.clone() for g in kernel(*args, **kw)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts["assoc_auction"]
    with torch.cuda.graph(graph):
        outs = kernel(*args, **kw)
    assert launch_counts["assoc_auction"] == before + 1
    for o in outs:
        o.fill_(-7)
    graph.replay()
    torch.cuda.synchronize()
    for o, e in zip(outs, eager):
        assert torch.equal(o, e), (mode, name)


def test_rtdetr_train_step_matches_through_the_kernel(dev, no_tf32,
                                                      monkeypatch):
    """An RT-DETR train step on the card matches its B·7 problems in one
    K5 launch with no host read, and the queries equal the CPU plain
    version's on the same cost."""
    from roadvision_tpu_torch.models import rtdetr
    from roadvision_tpu_torch.models import rtdetr_train as RT
    seen = []
    kernel = RT.hungarian_match

    def spy(cost, gt_mask, *a, **k):
        q = kernel(cost, gt_mask, *a, **k)
        seen.append((cost.cpu(), gt_mask.cpu(), q.cpu()))
        return q
    monkeypatch.setattr(RT, "hungarian_match", spy)
    rng = np.random.RandomState(3)
    bs = 2
    xy = rng.uniform(5, 40, (bs, 3, 2)).astype(np.float32)
    wh = rng.uniform(8, 20, (bs, 3, 2)).astype(np.float32)
    batch = [torch.from_numpy(a).to(dev) for a in (
        rng.rand(bs, 64, 64, 3).astype(np.float32),
        np.concatenate([xy, xy + wh], -1),
        rng.randint(0, 7, (bs, 3)).astype(np.int32),
        np.array([[True, True, False], [True, True, True]]))]
    model = rtdetr.random_model(7, seed=2).to(dev).train()
    step = RT.make_train_step_rtdetr(lr=1e-4)
    opt = step.init(model)
    RT.reset_host_syncs()
    before = launch_counts["assoc_auction"]
    loss, _ = step(model, opt, *batch)
    assert launch_counts["assoc_auction"] == before + 1
    assert RT.host_syncs == 0 and bool(torch.isfinite(loss))
    (cost, mask, q), = seen
    assert cost.shape[0] == bs * 7 and q.dtype == torch.int64
    assert torch.equal(q, RT.hungarian_match_plain(cost, mask))
    assert bool((q[mask] >= 0).all()) and bool((q[~mask] == -1).all())


def _box_nms_case(name, b, k):
    """K6 boxes-mode inputs: score-sorted candidates of a road scene (a
    valid prefix, jittered around 18 vehicles), or at threshold (IoU
    exactly 0.5), same (one box), classes (overlapping, other classes),
    offsets (near 7680), nan (NaN, infinite, zero-area), none, scattered
    (a random valid mask) → (boxes, cls, valid, iou_thres)."""
    rng = np.random.RandomState(b * k + len(name))
    objects = 18
    xy = rng.uniform(0, 1800, (b, objects, 2))
    wh = rng.uniform(40, 200, (b, objects, 2))
    who = rng.randint(0, objects, (b, k))
    c = np.take_along_axis(xy + wh / 2, who[..., None], 1) \
        + rng.normal(0, 5, (b, k, 2))
    half = np.take_along_axis(wh, who[..., None], 1) / 2 \
        * rng.uniform(0.85, 1.15, (b, k, 2))
    boxes = np.concatenate([c - half, c + half], -1).astype(np.float32)
    cls = np.take_along_axis(rng.choice([2, 5, 7], (b, objects)), who, 1) \
        .astype(np.int32)
    valid = np.zeros((b, k), bool)
    valid[:, :k * 2 // 5] = True
    thresh = 0.7
    if name == "at threshold":
        shapes = np.array([[0, 0, 10, 10], [0, 0, 10, 5], [0, 0, 5, 5]],
                          np.float32)
        boxes = shapes[np.arange(k) % 3][None].repeat(b, 0)
        boxes[..., ::2] += (np.arange(k) // 3 * 20.0)[:, None]
        cls[:], valid[:], thresh = 0, True, 0.5
    elif name in ("same", "classes"):
        boxes[:] = boxes[:, :1]
        cls = rng.randint(0, 3 if name == "same" else 80, (b, k)) \
            .astype(np.int32)
        valid[:] = True
    elif name == "offsets":
        boxes[:, 0::2] = [7670, 7675, 7690, 7700]
        boxes[:, 1::2] = [-10, -5, 10, 20]
        boxes += rng.normal(0, 2, boxes.shape).astype(np.float32)
        cls = np.tile([0, 1], (b, k // 2)).astype(np.int32)
        valid[:], thresh = True, 0.3
    elif name == "nan":
        boxes[:, 3::7, 0] = np.nan
        boxes[:, 5::11, 3] = np.inf
        boxes[:, 2::5, 2] = boxes[:, 2::5, 0]
        boxes[:, 6::9] = boxes[:, 6::9, :1]
    elif name == "none":
        valid[:] = False
    elif name == "scattered":
        valid = rng.rand(b, k) < 0.5
        thresh = 0.45
    return boxes, cls, valid, thresh


@pytest.mark.parametrize("name,b,k", [
    ("road", 8, 300), ("at threshold", 2, 300), ("same", 2, 300),
    ("classes", 2, 300), ("offsets", 2, 300), ("nan", 4, 300),
    ("none", 2, 300), ("scattered", 2, 300), ("road", 2, 600),
    ("road", 1, 1024), ("road", 3, 33)])
def test_nms_keep_boxes_mode_bit_equal(dev, name, b, k):
    """K6's boxes mode (class offset, IoU, > iou_thres, keep in one
    launch) against greedy_keep_boxes_plain, bit for bit."""
    from roadvision_tpu_torch.ops import nms as tnms
    *host, thresh = _box_nms_case(name, b, k)
    before = launch_counts["nms_keep"]
    got = tnms.greedy_keep_boxes(
        *[torch.from_numpy(a).to(dev) for a in host], thresh)
    assert launch_counts["nms_keep"] == before + 1
    want = tnms.greedy_keep_boxes_plain(
        *[torch.from_numpy(a) for a in host], thresh)
    assert torch.equal(got.cpu(), want), name


def test_nms_batch_on_the_card_equals_the_cpu(dev):
    """nms_batch on the card (K6 in boxes mode, one launch) against the
    CPU path: every output bit-equal."""
    from roadvision_tpu_torch.ops import nms as tnms
    rng = np.random.RandomState(13)
    boxes, _, _, _ = _box_nms_case("road", 4, 400)
    scores = rng.uniform(0, 1, (4, 400, 8)).astype(np.float32) ** 3
    before = launch_counts["nms_keep"]
    got = tnms.nms_batch(torch.from_numpy(boxes).to(dev),
                         torch.from_numpy(scores).to(dev), max_det=300,
                         return_idx=True)
    assert launch_counts["nms_keep"] == before + 1
    want = tnms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores),
                          max_det=300, return_idx=True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[3].sum()) > 0


def test_rotated_nms_overlaps_through_the_matrix_mode(dev):
    """obb's rotated NMS hands K6 its ProbIoU overlaps (matrix mode): the
    same booleans give the plain keep mask, bit for bit."""
    from roadvision_tpu_torch.ops import nms as tnms
    from roadvision_tpu_torch.ops.obb import probiou_matrix
    rng = np.random.RandomState(14)
    rb = np.concatenate([rng.uniform(0, 400, (8, 300, 2)),
                         rng.uniform(8, 60, (8, 300, 2)),
                         rng.uniform(-1.5, 1.5, (8, 300, 1))], -1)
    rb[:, 150:] = rb[:, :150] + rng.normal(0, 1.5, (8, 150, 5)) \
        * [1, 1, 1, 1, 0.02]
    rb[..., :2] += rng.randint(0, 3, (8, 300, 1)) * 7680.0
    over = probiou_matrix(torch.from_numpy(rb.astype(np.float32))) > 0.7
    valid = torch.from_numpy(rng.rand(8, 300) < 0.9)
    got = tnms.greedy_keep(over.to(dev), valid.to(dev))
    want = tnms.greedy_keep_plain(over, valid)
    assert torch.equal(got.cpu(), want) and int(want.sum()) < 8 * 300


def test_graph_replay_equals_the_eager_step(dev, no_tf32):
    """The main path's configuration (float32) replays a captured graph:
    its batches equal the eager step's from the same state, bit for bit,
    with the eager path's launch counts and no host read. The capture's
    warm-up runs the step WARMUP_CALLS times, and those launches count."""
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.runtime.graph import WARMUP_CALLS
    from roadvision_tpu_torch.track import sort as tsort
    cfg = _engine_cfg(batch=4)
    graph, eager = (PipelineEngine(cfg, device=dev) for _ in range(2))
    assert graph.step_mode == "graph" and graph.eager_reason is None
    frames, ts = _batches(1)[0]
    x = torch.from_numpy(frames).to(dev)
    t = torch.from_numpy((ts - 1000.0).astype(np.float32)).to(dev)
    launch_counts.update({k: 0 for k in launch_counts})
    graph.step_batch(x, t, want_proc=False)          # the capture
    assert launch_counts["median_k"] == 1 + WARMUP_CALLS
    assert launch_counts["assoc_greedy"] == 4 * (1 + WARMUP_CALLS)
    counts = []
    for eng, run in ((graph, graph.step_batch), (eager, eager.step)):
        eng.reset()
        launch_counts.update({k: 0 for k in launch_counts})
        tsort.reset_host_syncs()
        outs = []
        for frames, ts in _batches(3):
            x = torch.from_numpy(frames).to(dev)
            t = torch.from_numpy((ts - 1000.0).astype(np.float32)).to(dev)
            _, arrays = run(x, t, want_proc=False)
            outs.append([a.cpu().clone() for a in arrays])
        counts.append((dict(launch_counts), tsort.host_syncs))
        eng.outs = outs
    assert counts[0] == counts[1] and counts[0][1] == 0
    assert counts[0][0]["assoc_greedy"] == 12 and counts[0][0]["nms_keep"] == 3
    for g, e in zip(graph.outs, eager.outs):
        for a, b in zip(g, e):
            assert torch.equal(a, b) or torch.allclose(
                a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(graph.sort_state, eager.sort_state):
        assert torch.equal(a, b) or torch.allclose(a, b, rtol=0, atol=0,
                                                   equal_nan=True)


# the hooked backends and GMC, captured: name → (tracking overrides,
# association launches a frame)
HOOKED_GRAPHS = {
    "bytetrack": ({"backend": "bytetrack"}, 2),
    "ocsort": ({"backend": "ocsort"}, 2),
    "deepsort": ({"backend": "deepsort"}, 1),
    "deepsort_reid": ({"backend": "deepsort",
                       "reid_weights": "assets/reid_synthetic.npz"}, 1),
    "strongsort": ({"backend": "strongsort"}, 1),
    "botsort_gmc": ({"backend": "botsort", "gmc": True}, 2),
    "sort_gmc": ({"gmc": True}, 1),
}


def _panned(batches):
    """The batches of :func:`_batches` under a camera pan by whole GMC
    thumbnail blocks (3 x 2 source px at 480 x 288)."""
    rng = np.random.RandomState(11)
    cam, out = np.zeros(2, int), []
    for frames, ts in batches:
        rolled = []
        for f in frames:
            cam += rng.randint(-3, 4, 2)
            rolled.append(np.roll(f, (2 * cam[1], 3 * cam[0]), axis=(0, 1)))
        out.append((np.stack(rolled), ts))
    return out


@pytest.mark.parametrize("name", list(HOOKED_GRAPHS))
def test_hooked_and_gmc_graph_replay_equals_the_eager_step(dev, no_tf32,
                                                           name):
    """Every hooked backend, and GMC, replays a captured graph on a
    panned source: its batches equal the eager step's from the same
    reset state bit for bit, the track state and GMC's carry after them
    too, with the eager path's launch counts (the association ``k``
    launches a frame) and no host read."""
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.runtime.graph import WARMUP_CALLS
    from roadvision_tpu_torch.track import sort as tsort
    over, per_frame = HOOKED_GRAPHS[name]
    cfg = merge(_engine_cfg(batch=4), {"tracking": over})
    graph, eager = (PipelineEngine(cfg, device=dev) for _ in range(2))
    assert graph.step_mode == "graph" and graph.eager_reason is None
    batches = [(torch.from_numpy(f).to(dev),
                torch.from_numpy((t - 1000.0).astype(np.float32)).to(dev))
               for f, t in _panned(_batches(3))]
    launch_counts.update({k: 0 for k in launch_counts})
    graph.step_batch(*batches[0], want_proc=False)          # the capture
    assert launch_counts["assoc_greedy"] \
        == 4 * per_frame * (1 + WARMUP_CALLS)
    counts = []
    for eng, run in ((graph, graph.step_batch), (eager, eager.step)):
        eng.reset()
        launch_counts.update({k: 0 for k in launch_counts})
        tsort.reset_host_syncs()
        eng.outs = [[a.cpu().clone() for a in run(x, t, want_proc=False)[1]]
                    for x, t in batches]
        counts.append((dict(launch_counts), tsort.host_syncs))
    assert counts[0] == counts[1] and counts[0][1] == 0
    assert counts[0][0]["assoc_greedy"] == 12 * per_frame
    assert counts[0][0]["nms_keep"] == 3 and len(graph._graphs) == 1
    for g, e in zip(graph.outs, eager.outs):
        for a, b in zip(g, e):
            assert torch.equal(a, b) or torch.allclose(
                a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(graph.step_state(), eager.step_state()):
        assert torch.equal(a, b) or torch.allclose(a, b, rtol=0, atol=0,
                                                   equal_nan=True)
    if graph.gmc_enabled:
        assert float(graph.gmc_valid) == 1.0 and graph.gmc_prev.any()


@pytest.mark.parametrize("name", ["deepsort", "botsort_gmc"])
def test_hooked_fleet_replays_and_equals_eager(dev, no_tf32, name):
    """The fleet at S = 4 with a hooked backend (and GMC's (S, G, G)
    carry) replays one graph a fleet batch: its results equal the same
    fleet run eagerly, and the association launches once a stage a frame
    for all four streams (B · k a fleet batch, not S · B · k); a reset()
    keeps the graph's state tensors."""
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    from roadvision_tpu_torch.runtime import MultiStreamEngine
    over, per_frame = HOOKED_GRAPHS[name]
    cfg = merge(_engine_cfg(batch=2), {"tracking": over})
    graph, eager = (MultiStreamEngine(cfg, 4, devices=[dev])
                    for _ in range(2))
    assert graph.step_mode == "graph"
    eager.groups[0].engine.step_mode = "eager"
    srcs = [SyntheticRoadSource(480, 288, num_vehicles=6, seed=s)
            for s in range(4)]
    fleet = [(np.stack([np.stack([np.roll(src.render(2 * k + i),
                                          3 * (2 * k + i), axis=1)
                                  for i in range(2)]) for src in srcs]),
              1000.0 + np.tile((2 * k + np.arange(2)) / 30.0, (4, 1)))
             for k in range(3)]
    got = {"graph": [], "eager": []}
    for k, (frames, ts) in enumerate(fleet):
        for mode, eng in (("graph", graph), ("eager", eager)):
            launch_counts.update({c: 0 for c in launch_counts})
            got[mode].append(eng.process_batch(frames, ts))
            if k or mode == "eager":       # the capture's warm-ups aside
                assert launch_counts["assoc_greedy"] == 2 * per_frame
                assert launch_counts["nms_keep"] == 1
    assert len(graph.groups[0].engine._graphs) == 1
    # a reset() copies fresh values into the graph's state; the first
    # batch then comes out as it did
    held = graph.groups[0].step_state()
    for mode, eng in (("graph", graph), ("eager", eager)):
        eng.reset()
        got[mode].append(eng.process_batch(*fleet[0]))
    assert graph.groups[0].step_state() is held
    assert len(graph.groups[0].engine._graphs) == 1
    n = 0
    for g, e in zip(got["graph"], got["eager"]):
        for gs, es in zip(g, e):
            for a, b in zip(gs, es):
                assert a.detections == b.detections
                n += len(a.detections)
    assert n > 0
    for run in got.values():
        assert [[r.detections for r in st] for st in run[-1]] \
            == [[r.detections for r in st] for st in run[0]]


def test_a_capture_that_uploads_raises(dev):
    """A step that uploads a host value on every call cannot be captured:
    the engine raises, and neither keeps a graph nor runs it eagerly."""
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.runtime.graph import WARMUP_CALLS
    eng = PipelineEngine(_engine_cfg(batch=4), device=dev)
    calls = []

    def fn(state, x):
        calls.append(1)
        return (x + torch.tensor(1.0).to(x.device),), state

    x = torch.zeros(4, device=dev)
    with pytest.raises(RuntimeError):
        eng.run_step(("upload", (4,)), fn, None, (x,))
    assert not eng._graphs and eng.step_mode == "graph"
    assert len(calls) == WARMUP_CALLS + 1     # the warm-ups and the capture
    # the card goes on working
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 4.0


def test_reset_and_load_state_reach_the_captured_state(dev, tmp_path):
    from roadvision_tpu_torch.runtime import PipelineEngine
    cfg = _engine_cfg(batch=4)
    eng = PipelineEngine(cfg, device=dev)
    batches = _batches(4)
    first = [_ids(eng.process_batch(f, t, want_proc=False))
             for f, t in batches[:2]]
    eng.save_state(tmp_path / "s.npz")
    rest = [_ids(eng.process_batch(f, t, want_proc=False))
            for f, t in batches[2:]]
    eng.reset()            # the same ids again from a fresh state
    assert [_ids(eng.process_batch(f, t, want_proc=False))
            for f, t in batches[:2]] == first
    eng.load_state(tmp_path / "s.npz")
    assert [_ids(eng.process_batch(f, t, want_proc=False))
            for f, t in batches[2:]] == rest
    assert len(eng._graphs) == 1 and any(any(r) for r in rest)


def test_max_det_300_tracks_on_the_card_as_on_the_cpu(dev, no_tf32):
    """detect.max_det = 300 (T = D = 300 slots and detections: the
    association's cells outgrow a block's shared memory and K4's boxes
    mode computes each again from the boxes) runs its graph on the card
    with the CPU path's ids."""
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    cfg = merge(_engine_cfg(batch=4), {"detect": {"max_det": 300}})
    gpu = PipelineEngine(cfg, device=dev)
    cpu = PipelineEngine(cfg, device="cpu")
    assert gpu.track_slots == 300 and gpu.step_mode == "graph"
    before = launch_counts["assoc_greedy"]
    got, want = [], []
    for frames, ts in _batches(3):
        got.append(_ids(gpu.process_batch(frames, ts, want_proc=False)))
        want.append(_ids(cpu.process_batch(frames, ts, want_proc=False)))
    assert launch_counts["assoc_greedy"] > before
    assert got == want and any(any(r) for r in got)


@pytest.mark.parametrize("distinct", [False, True])
def test_fleet_graphs_on_distinct_cards_equal_one_card(dev, no_tf32,
                                                       distinct):
    """The fleet over two groups (two cards, or one card twice): each
    group's engine captures and replays its own graph on its own card,
    and the ids equal the fleet on one card; the launches are each
    group's two fleet batches and its capture's warm-ups."""
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import MultiStreamEngine
    from roadvision_tpu_torch.runtime.graph import WARMUP_CALLS
    cfg = merge(_engine_cfg(batch=2), {"tpu": {"mesh": {"enable": True}}})
    s = 4
    clip = _batches(2 * s, batch=2)
    fleet = [(np.stack([clip[k * s + i][0] for i in range(s)]),
              np.stack([clip[k * s + i][1] for i in range(s)]))
             for k in range(2)]
    many = MultiStreamEngine(cfg, s, devices=_cards(dev, 2, distinct))
    one = MultiStreamEngine(cfg, s, devices=[dev])
    launch_counts.update({k: 0 for k in launch_counts})
    got = [many.process_batch(f, t) for f, t in fleet]
    steps = 2 * (2 + WARMUP_CALLS)
    assert launch_counts == {"clahe_tile_luts": steps, "clahe_apply": steps,
                             "median_k": steps, "nms_keep": steps,
                             "assoc_greedy": 2 * steps, "assoc_auction": 0,
                             "deform_sample": 0, "deform_sample_bwd": 0}
    for grp in many.groups:
        graphs = grp.engine._graphs
        assert grp.engine.step_mode == "graph" and len(graphs) == 1
        assert all(g.device == grp.engine.device for g in graphs.values())
    want = [one.process_batch(f, t) for f, t in fleet]
    for g, w in zip(got, want):
        for gs, ws in zip(g, w):
            assert _ids(gs) == _ids(ws)
    assert any(any(_ids(gs)) for g in got for gs in g)


# ----------------------------------------------------------------------
# K7 deform_sample and the captured RT-DETR step

K7_RTOL, K7_ATOL = 1e-5, 1e-5      # f32 sums of O(1) values, both orders


def _k7_inputs(nq, shapes, seed=5, edges=False, b=8):
    """Decoder-like K7 inputs on the CPU: offsets of a few points, logits,
    boxes in (0.05, 0.95), values. ``edges``: boxes (0.5, 0.5, 1, 1) and
    offsets that put points on and just outside the map edges, one NaN
    location."""
    from roadvision_tpu_torch.models import rtdetr as T
    g = torch.Generator().manual_seed(seed)
    rows = sum(h * w for h, w in shapes)
    off = torch.randn(b, nq, T.NH, T.NL, T.NDP, 2, generator=g) * 3
    logits = torch.randn(b, nq, T.NH, T.NL * T.NDP, generator=g)
    refer = torch.rand(b, nq, 4, generator=g) * 0.9 + 0.05
    if edges:
        refer[:] = torch.tensor([0.5, 0.5, 1.0, 1.0])
        for lvl, (hl, wl) in enumerate(shapes):
            locs = torch.tensor([0.0, 0.5 / wl, (wl - 0.5) / wl, 1.0,
                                 -0.5 / wl, 1.0 + 0.5 / wl, -0.25, 1.25])
            pick = torch.randint(0, len(locs), off[:, :, :, lvl].shape,
                                 generator=g)
            off[:, :, :, lvl] = (locs[pick] - 0.5) * 8.0
        off[0, 1, 2, 0, 1, 0] = float("nan")
    values = torch.randn(b, rows, T.NH, T.HD // T.NH, generator=g)
    return off, logits, refer, values


def _assert_k7_close(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.allclose(got[~nan], want[~nan], rtol=K7_RTOL, atol=K7_ATOL)


@pytest.mark.parametrize("nq", [100, 300])
@pytest.mark.parametrize("vals", ["f32", "f32 as bf16", "bf16"])
@pytest.mark.parametrize("case", ["square", "ragged", "edges"])
def test_deform_sample_kernel_against_its_plain_version(dev, nq, vals, case):
    """K7 at the decoder's shapes (8 × nq queries, levels 80², 40², 20²;
    non-square levels; edges, just outside and a NaN location) against
    ``deform_sample_plain`` on the card, one launch a call."""
    from roadvision_tpu_torch.ops import deform as D
    shapes = [(48, 80), (24, 40), (12, 20)] if case == "ragged" \
        else [(80, 80), (40, 40), (20, 20)]
    off, logits, refer, values = (t.to(dev) for t in _k7_inputs(
        nq, shapes, edges=case == "edges"))
    bf16 = vals == "f32 as bf16"
    if vals == "bf16":
        values = values.to(torch.bfloat16)
    before = launch_counts["deform_sample"]
    with torch.no_grad():
        got = D.deform_sample(off, logits, refer, values, shapes, bf16)
        want = D.deform_sample_plain(off, logits, refer, values, shapes,
                                     bf16)
    torch.cuda.synchronize()
    assert launch_counts["deform_sample"] == before + 1
    _assert_k7_close(got, want)
    if case == "edges":
        assert torch.isnan(got[0, 1, 2]).all()
        assert int(torch.isnan(got).sum()) == got.shape[-1]


K8_RTOL, K8_ATOL = 1e-4, 1e-5     # atomics' order; ATOL × the largest |g|


def _assert_k8_close(got, want):
    """K8's gradients against the plain backward's: non-finite values in
    the same tensors; where both are finite |Δ| ≤ K8_RTOL |want| +
    K8_ATOL · max |want| (the value and box gradients are sums taken by
    atomics, the others sums over lanes in another order)."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        bad_g, bad_w = ~torch.isfinite(g), ~torch.isfinite(w)
        assert bool(bad_g.any()) == bool(bad_w.any())
        ok = ~(bad_g | bad_w)
        scale = float(w[ok].abs().max()) if ok.any() else 0.0
        assert torch.allclose(g[ok], w[ok], rtol=K8_RTOL,
                              atol=K8_ATOL * scale)


@pytest.mark.parametrize("b,nq", [(4, 300), (8, 100)])
@pytest.mark.parametrize("case", ["square", "ragged", "edges"])
def test_deform_sample_backward_kernel_against_its_plain_version(dev, b, nq,
                                                                 case):
    """K8 at the training shape (4 × 300 queries) and the serving one (8 ×
    100), levels 80², 40², 20²; non-square levels; points on and just
    outside the edges and a NaN location: against
    ``deform_sample_backward_plain`` on the card, one launch a call."""
    from roadvision_tpu_torch.ops import deform as D
    shapes = [(48, 80), (24, 40), (12, 20)] if case == "ragged" \
        else [(80, 80), (40, 40), (20, 20)]
    args = [t.to(dev) for t in _k7_inputs(nq, shapes, seed=9,
                                          edges=case == "edges", b=b)]
    grad_out = torch.randn(b, nq, 8, 32, generator=torch.Generator()
                           .manual_seed(3)).to(dev)
    before = launch_counts["deform_sample_bwd"]
    got = D._sample_backward_cuda(grad_out, *args, shapes)
    want = D.deform_sample_backward_plain(grad_out, *args, shapes)
    torch.cuda.synchronize()
    assert launch_counts["deform_sample_bwd"] == before + 1
    _assert_k8_close(got, want)
    if case == "edges":
        # the NaN location's (batch, query, head): its logits' gradient
        assert torch.isnan(got[1][0, 1, 2]).all()


def test_deform_sample_under_autograd_launches_k7_then_k8(dev):
    """On the card a call that needs gradients launches K7 once and, on
    ``.backward()``, K8 once, giving the plain version's output and
    gradients; bf16 values that need a gradient raise; RT-DETR's
    ``forward_train`` + backward launches each once a decoder layer."""
    from roadvision_tpu_torch.models import rtdetr as T
    from roadvision_tpu_torch.ops import deform as D
    shapes = [(20, 20), (10, 10), (5, 5)]
    args = [t.to(dev) for t in _k7_inputs(20, shapes, b=2)]
    ins = [t.clone().requires_grad_(True) for t in args]
    before = dict(launch_counts)
    out = D.deform_sample(*ins, shapes)
    assert launch_counts["deform_sample"] == before["deform_sample"] + 1
    assert launch_counts["deform_sample_bwd"] == before["deform_sample_bwd"]
    grad_out = torch.randn_like(out)
    out.backward(grad_out)
    torch.cuda.synchronize()
    assert launch_counts["deform_sample_bwd"] \
        == before["deform_sample_bwd"] + 1
    _assert_k7_close(out.detach(), D.deform_sample_plain(*args, shapes))
    _assert_k8_close([t.grad for t in ins], D.deform_sample_backward_plain(
        grad_out, *args, shapes))
    bf16 = args[3].to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(ValueError, match="float32 values"):
        D.deform_sample(args[0], args[1], args[2], bf16, shapes)
    with pytest.raises(ValueError, match="bf16_vals"):
        D.deform_sample(ins[0], *args[1:], shapes, bf16_vals=True)
    model = T.random_model(nc=3, seed=0).to(dev)
    launch_counts.update({k: 0 for k in launch_counts})
    aux = model.forward_train(torch.rand(1, 64, 64, 3, device=dev))
    assert launch_counts["deform_sample"] == len(model.dec.layers)
    (aux["boxes"][-1].sum() + aux["scores"][-1].sum()).backward()
    torch.cuda.synchronize()
    assert launch_counts["deform_sample_bwd"] == len(model.dec.layers)
    for lp in model.dec.layers:
        assert lp.ca.off.weight.grad is not None
        assert torch.isfinite(lp.ca.val.weight.grad).all()


def _rtdetr_engine_cfg(batch=4):
    from roadvision_tpu_torch.config import merge
    return merge(_engine_cfg(batch), {"detect": {
        "model": "assets/rtdetr_l_synthetic_256.npz", "imgsz": 256,
        "max_det": 20, "classes_keep": [2], "compute_dtype": "float32"}})


def _same_dets(g, e):
    """Replayed against eager arrays: valid, classes and ids equal, boxes
    within 0.05 px, confidences within 2e-3 (the smoke's limits for a
    replayed batch)."""
    boxes, conf, cls_id, valid, ids = g[:5]
    assert torch.equal(valid, e[3]) and valid.any()
    assert torch.equal(cls_id[valid], e[2][valid])
    assert torch.equal(ids[valid], e[4][valid])
    assert (boxes[valid] - e[0][valid]).abs().max() <= 0.05
    assert (conf[valid] - e[1][valid]).abs().max() <= 2e-3


def test_rtdetr_graph_replay_equals_the_eager_step(dev, no_tf32):
    """RT-DETR-L (the asset, 256², float32) replays a captured graph: its
    batches equal the eager step's from the same state, with the eager
    path's launch counts (K7 six a batch, one a decoder layer) and no
    host read."""
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.runtime.graph import WARMUP_CALLS
    from roadvision_tpu_torch.track import sort as tsort
    cfg = _rtdetr_engine_cfg()
    graph, eager = (PipelineEngine(cfg, device=dev) for _ in range(2))
    assert graph.step_mode == "graph" and graph.eager_reason is None
    frames, ts = _batches(1)[0]
    x = torch.from_numpy(frames).to(dev)
    t = torch.from_numpy((ts - 1000.0).astype(np.float32)).to(dev)
    launch_counts.update({k: 0 for k in launch_counts})
    graph.step_batch(x, t, want_proc=False)          # the capture
    assert launch_counts["deform_sample"] == 6 * (1 + WARMUP_CALLS)
    counts = []
    for eng, run in ((graph, graph.step_batch), (eager, eager.step)):
        eng.reset()
        launch_counts.update({k: 0 for k in launch_counts})
        tsort.reset_host_syncs()
        outs = []
        for frames, ts in _batches(3):
            x = torch.from_numpy(frames).to(dev)
            t = torch.from_numpy((ts - 1000.0).astype(np.float32)).to(dev)
            _, arrays = run(x, t, want_proc=False)
            outs.append([a.cpu().clone() for a in arrays])
        counts.append((dict(launch_counts), tsort.host_syncs))
        eng.outs = outs
    assert counts[0] == counts[1] and counts[0][1] == 0
    assert counts[0][0]["deform_sample"] == 18
    assert counts[0][0]["nms_keep"] == 0
    for g, e in zip(graph.outs, eager.outs):
        _same_dets(g, e)


def test_rtdetr_int8_stays_eager(dev):
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    cfg = merge(_rtdetr_engine_cfg(), {"detect": {"compute_dtype": "int8"}})
    eng = PipelineEngine(cfg, device=dev)
    assert eng.step_mode == "eager" and "int8" in eng.eager_reason


def test_recalibrated_gate_drops_its_graphs(dev):
    """An "auto" gate: resolved from the first batch before the capture;
    each ``calibrate_gate`` drops the graphs, and the replay that follows
    holds the new threshold (0: no frame runs the chain; 1e6: every
    frame does)."""
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    cfg = merge(_engine_cfg(), {"preprocess": {"auto_gate": {
        "enable_low_contrast_gate": True, "contrast_thresh": "auto"}}})
    eng = PipelineEngine(cfg, device=dev)
    assert eng.step_mode == "graph"
    frames, ts = _batches(1)[0]
    x = torch.from_numpy(frames).to(dev)
    t = torch.zeros(4, device=dev)
    eng.step_batch(x, t)
    first = next(iter(eng._graphs.values()))
    eng.step_batch(x, t)
    assert next(iter(eng._graphs.values())) is first
    eng.pipeline.calibrate_gate(stats=np.array([0.0]))
    proc, _ = eng.step_batch(x, t)
    assert next(iter(eng._graphs.values())) is not first
    assert torch.equal(proc, x)
    eng.pipeline.calibrate_gate(stats=np.array([1e6]))
    proc, _ = eng.step_batch(x, t)
    assert len(eng._graphs) == 1 and not torch.equal(proc, x)
    assert torch.equal(proc, eng.pipeline.apply_batch(x))
