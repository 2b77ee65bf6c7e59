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
held to the CPU path within the tolerances stated in each test.
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
    cfg = merge(_engine_cfg(batch=2), {"tpu": {"mesh": {"enable": True}}})
    s = 3
    clip = _batches(2 * s, batch=2)
    fleet = [(np.stack([clip[k * s + i][0] for i in range(s)]),
              np.stack([clip[k * s + i][1] for i in range(s)]))
             for k in range(2)]
    eng = {d: MultiStreamEngine(cfg, s, devices=[d]) for d in ("cpu", dev)}
    launch_counts.update({k: 0 for k in launch_counts})
    got = [eng[dev].process_batch(f, t) for f, t in fleet]
    # one launch of each kernel per fleet batch, not per stream
    assert set(launch_counts.values()) == {2}
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
