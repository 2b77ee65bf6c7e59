#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (roadvision_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from roadvision_tpu_torch/csrc (one nvcc per
     source, started together) and print the build time;
  3. hold every kernel against its plain PyTorch version on the card, at
     the main path's shapes (8 x 1080p luma for CLAHE in both blend
     modes plus a ragged 1079 x 1917 plane; 3 x 8 planes of 1080p for the
     median at k = 3, and k = 5, 7, 9 at a smaller shape) and at the
     shapes that reach the kernels' edge paths (other tile grids, widths
     with a ragged tail, one-pixel planes, pointers off a 16-byte
     boundary; for the LUT kernel also a plane of one value, a single
     plane, no clip limit, 4 x 4-pixel tiles and 4K planes; for the
     apply kernel also the 360 x 640 sample grid of the 1080p plane):
     bit-equality, times by CUDA events at a warm L2 and with L2 flushed
     before every call (the LUT kernel also on noise, one value and a
     camera-like plane, since its time depends on the data), and the
     bound (the larger of bytes read once and written once over
     3.35 TB/s and scalar operations over 67 T/s); then the tail's loops,
     K4 ``assoc_greedy``, K5 ``assoc_auction`` and K6 ``nms_keep``,
     bit-equal to their plain versions: K4's matrix mode and K5's on
     road-scene IoU matrices (one 100 x 100 problem; eight, a fleet's),
     ties, all invalid, a 100-round chain, NaN scores, ragged sizes,
     max_det = 300 (random and a 300-round chain), K5's also under a
     max_iters cap; K4's and K5's boxes modes (their own IoU from Kalman
     means and detections, both maps) on road scenes, IoU exactly at the
     threshold, twins, NaN / infinite / zero-area boxes, nothing valid,
     max_det = 300 and 1024 x 1024; K5's matcher mode on RT-DETR
     training's cost (28 x 50 x 300), M close to NQ, M = NQ, one gt, the
     second best's -1e9 floor, all gts masked, a max_iters cap, NaN and
     infinite costs; K6's boxes mode
     (its own class-offset IoU) on the main path's 8 x 300 road
     candidates, IoU at the threshold, one box for all, other classes
     overlapping, coordinates near the class offsets, NaN / zero-area
     boxes, none valid, a scattered valid mask, 600 and 1024 candidates;
     K6's matrix mode on 8 x 300 overlaps, all overlapping, none valid, a
     chain, 600, 1024, 33 and obb's ProbIoU overlaps; each K4 and K5
     problem alone equal to the batch; K4-K6 timed in every mode as 50 queued
     eager calls and as 50 launches in one CUDA graph, warm and with L2
     flushed, beside an empty kernel's launch in a graph (the card's
     launch floor); their bound's operations counted from the rounds and
     live cells these inputs take; then K7 ``deform_sample`` against
     ``deform_sample_plain`` (DEFORM_RTOL / DEFORM_ATOL, NaN where the
     plain version's are, bit-equality reported) on RT-DETR-L's own
     decoder inputs at 640 x 8 (every layer, 100 and 300 queries, bf16
     and f32 values), random 8 x 100 / 300 inputs (f32, f32 as bf16,
     bf16 storage), non-square levels, points on and just outside the
     edges and a NaN location; timed four ways at the main path's layer
     beside the plain version (both gather formulations), the
     ``grid_sample`` composition (the library column: a composition, not
     one call) and its bound from the value rows the call touches, and
     at RT-DETR-L's training shape in f32; before K7, K8
     ``deform_sample_bwd`` against ``deform_sample_backward_plain``
     (DEFORM_BWD_RTOL / DEFORM_BWD_ATOL times each gradient's largest
     magnitude, non-finite in the same gradients) on RT-DETR-L's own
     training inputs and output gradients (one AdamW step at 640 x 4,
     every layer), random 4 x 300 and 8 x 100 inputs, non-square levels,
     edges and a NaN location, timed at layer 0 of the training inputs
     beside the plain backward, the backward of the ``grid_sample``
     composition and its bound (the value rows touched, the zero-filled
     value gradient), and its wrapper's parts apart in a graph: the zero
     fills alone and K8 alone into buffers zero-filled once; the build
     prints ``nvcc -Xptxas=-v``'s registers, spills and shared memory a
     kernel;
  4. drive the realtime pipeline (bench.py's 1080p x batch 8 config:
     CLAHE -> median -> YOLOv8n -> NMS -> SORT -> geometry) through
     PipelineEngine.process_batch: one batch in float32 with TF32 off
     against the CPU plain path (processed frames bit-equal, detections
     within the tests' tolerance, identical track ids); then, the same
     way, one float32 batch each of the engine with the auto-gate on
     (span + impulse statistic, on a batch that mixes clean,
     low-contrast and impulse-noise frames), with ``space: LAB``, and
     with ``tpu.sampled_preprocess``, each also timed over two more
     batches with its own launch counts; then the default bfloat16 path with the kernels' launch counters reset just before
     and read just after (each kernel once per batch), timed in
     frames/s, and sanity-checked: on the first batch it tracks as many
     distinct objects as the float32 run;
  4b. ``[graph]``: the main path at 1080p x 8 bf16 replays one CUDA graph
     a batch (``engine.step_mode == "graph"``): GRAPH_BATCHES replayed
     batches against as many eager ``engine.step`` batches from the same
     state (ids, classes, counts exact, boxes BOX_TOL, confidences
     CONF_TOL), the same exact launch counts both ways (K1-K3 and K6 once
     a batch, K4 once a frame), no host read in a replayed batch, no call
     of the torch IoU helpers that K4's and K6's boxes modes replace
     (``x_to_bbox``, ``iou_matrix``, ``trk2det_map``,
     ``iou_matrix_xyxy``) in an eager batch; stage
     ms eager and graph (each stage captured alone), frames/s eager and
     graph (device-resident, in turns), the fleet at 1080p x 8 a stream for S = 1, 2, 4, 8
     eager and graph, and multi_stream.yaml's fleet replayed with no host
     read; ``[graph] rtdetr``: RT-DETR-L at 640 behind the chain at
     1080p x 8, an eager batch under ``set_sync_debug_mode("error")``,
     replayed batches against eager ones with exact launch counts (K7
     six a batch), frames/s eager and replayed, the forward eager by
     stage and replayed; ``[graph]
     rtdetr_demo``: configs/rtdetr_demo.yaml as shipped replayed against
     eager (processed frames too; K3 twice a batch);
  5. drive the serving surface at 1080p x batch 8 with the default chain,
     each path with the launch counters set to 0 just before and read
     just after (on every path K1-K3 once a step, K6 once a step that
     runs the YOLO detector, K4 / K5 as often as the tracker associates,
     all exact; a step is a batch, or a warm-up call of a CUDA graph's
     capture, which the window of an engine's first batch holds):
     ``[entry] api`` (``Pipeline`` over 16 frames against
     ``process_batch`` on the same frames and stamps: ids, classes,
     boxes, confidences, distance and speed equal bit for bit;
     ``detect_image``; ``process_video`` to chiprun_out/api.avi),
     ``[entry] preview`` (the preview ``main`` with ``--max-frames 48
     --no-show --record``: valid RIFF, 48 JPEG frames, the first decodes,
     ``MJPEGAviReader`` reads 48 back), ``[entry] serve`` (the HTTP
     server on 127.0.0.1 port 0: ``/stats``, ``/detections``, three
     parts of ``/stream``, shutdown with every thread joined),
     ``[state]`` (three batches, ``save_state``, three more; a fresh
     engine, ``load_state``, the same three: bit-equal; the file holds
     the JAX format's 25 ``sort_*`` arrays by name; again with OC-SORT
     and GMC, ``gmc_prev`` included), ``[tracker]``
     (``SortTracker.update`` over the engine's detections gives the
     engine's ids), ``[entry] track --gt`` (``tools/track.py`` over 16
     frames with the synthetic road's ground truth on the card and on
     the CPU: MOTA, IDF1, HOTA equal to 1e-6) and ``[bench]`` (the port
     bench in-process at a small iteration count);
  5b. the tracker family, each path with its launch counts:
     ``[tracker] <backend>`` for sort, hungarian, bytetrack, ocsort,
     deepsort, strongsort (GMC on), botsort (GMC on) and deepsort with
     ``reid_weights: assets/reid_synthetic.npz`` (three float32 batches
     against the CPU path: ids equal, distance and speed within
     TRACK_RTOL; bfloat16 frames/s as ``tools/bench.py`` times a path,
     the SORT + geometry stage ms, the association's host syncs in one
     batch); ``[gmc]`` (a pan by known shifts through strongsort: the
     card's shifts equal the CPU's and the known ones); ``[gate]``
     (``detect.temporal_gate`` on a static and a moving scene through
     ``stream``: the same coasted frames on the card and on the CPU, > 0
     and 0, ids included; then ``tools/bench.py --mode gate``
     in-process). The CPU engines of 5b share one preprocess + detector
     pass per distinct batch (``SharedFront``);
  6. ``[detector]``: the same config with the detector swapped — (a)
     YOLOv5n from its asset (conf 0.5), (b) YOLO11n, (c-e) v8n seg /
     pose / obb, (f) int8 with ``int8_calibration: 8``, (g) TTA, (h)
     tiling (tile 640, overlap 0.25, full frame), (j) RT-DETR-L from its
     asset (stretch to 640, ``num_queries`` at its default), (k) the same
     in int8 with ``int8_calibration: 8`` — each one float32 (f, k:
     int8) batch on the card against the CPU path (TTA, tiling and
     RT-DETR in float32: the CPU takes the first 2 frames; masks,
     keypoints and rotated boxes held to the tolerances printed; int8 to
     float32's; for RT-DETR the encoder's top-k anchors must be the same
     set on the card and on the CPU, else the score gap at rank nq is
     printed and the phase fails) and timed bfloat16 (int8) batches as
     tools/bench.py times them (median, min and max of 2 windows of 2
     batches; stage ms of 2 batches; RT-DETR also by backbone, encoder
     and decoder), launches 1 / 1 / 1 per batch; (i) the yolov8n asset
     as ONNX (``detect.backend: onnx``) and as a ``.pt`` state dict:
     detections ``==`` to the ``.npz`` run (``chiprun_out/detector.json``);
  7. ``[weather]``: ``synthetic_fog:heavy:6`` at 1080p, synthesized on the
     card, through ``stream`` with weather_demo.yaml's gate and detector
     in float32 against the CPU path on the same frames (processed
     frames bit-equal, detections within BOX_TOL / CONF_TOL, the chain
     run on every fogged frame), a batch of 4 clean and 4 fogged frames
     that the gate must split, one frame's fog synthesized on the CPU
     too (≤ 2 levels in ≤ 0.1 % of the pixels), launches 1 / 1 / 2 per
     batch (the impulse statistic's median, then the chain's);
     ``[entry] rtdetr_demo`` and ``[entry] weather_demo``: the preview
     ``main`` on each shipped config, ``--max-frames 16 --no-show
     --record``, the AVI checked, launches 1 / 1 / 2 per batch;
  7b. the camera fleet (configs/multi_stream.yaml: 4 synthetic streams at
     720p, batch 8, the CLAHE + median chain, with the repo's yolov8n
     checkpoint) and traffic analytics, each path with its launch
     counts: ``[streams]`` (one float32 fleet batch on the card against
     the CPU path and against 4 single-stream engines on the card; then
     bfloat16 timed: aggregate and per-stream frames/s against one
     stream alone, the fleet step's stage ms, host syncs a fleet batch;
     K1, K2 and K3 exactly once per fleet batch), ``[streams] gate``
     (the fleet gate on 4 static streams, then 3 static and 1 moving:
     coasted frames equal on card and CPU), ``[entry] multi_preview``
     (32 grid canvases recorded), ``[entry] analytics_demo`` (the shipped
     config through the preview, ``tools/analyze.py`` on the card
     against the CPU in float32, the server's /events and /metrics),
     ``[entry] multi_serve``, ``[entry] streams_api``
     (``Pipeline.streams`` bit-equal to ``process_batch``) and ``[bench]
     streams`` (the port bench's fleet mode at 1080p x batch 8 for 1, 2,
     4 and 8 streams); results also in chiprun_out/streams.json. The
     kernel phase also holds K1, K2 and K3 bit-equal at the fleet's
     folded shapes (32 luma planes and 96 colour planes, 720p and 1080p)
     and times them there;
  7c. training, with the kernels' counts 0 across it but RT-DETR-L's
     on the card: K5 once a step (its matcher, with no host read), K7
     once a decoder layer forward and K8 once a layer backward:
     ``[train] <family>`` for v8n, yolo11n and
     v5n at 640 x 16, v8n-seg / -pose / -obb at 640 x 8, RT-DETR-L at
     640 x 4 and the re-id embedder — one float32 step (TF32 off) from the
     same tree and batch on the card and on the CPU (2 images; RT-DETR 1):
     loss, components and gradient norm within TRAIN_LOSS_RTOL,
     parameters after the step within TRAIN_PARAM_ATOL; 10 steps on one
     fixed batch on the card must lower the loss; warm steps timed (median,
     min, max), split into forward + loss, assignment / matching, backward
     and optimiser, images/s, peak memory, host syncs a step (by
     ``torch.cuda.set_sync_debug_mode``); TF32 off throughout. Then
     ``[entry] train``: ``cli.train`` at 640 x 16 for 20 steps with
     ``--eval-every 10 --save-every 10``, ``--resume`` to step 30, a ``--fog
     0.5`` run, ``train_reid``, and the ``.weights.npz`` serving one 1080p
     batch in a ``PipelineEngine`` (one launch of each kernel); results
     also in chiprun_out/training.json;
  7d. ``[parallel]``, multi-card parallelism over lists that repeat
     cuda:0, float32 with TF32 off unless timed, the kernels' counts 0
     throughout but the dry run's fleet's, the serving forwards' K7 and,
     once an RT-DETR-L objective, K5 and K7 / K8 once a decoder layer:
     the dp x tp train step ({data: 4, model: 2}) of v8n and
     RT-DETR-L at the JAX dry run's 64² x 8 against one replica (loss
     PAR_LOSS_RTOL, parameters and optimiser state PAR_RTOL / PAR_ATOL,
     replicas identical); v8n, YOLO11n and v5n at 640² x 16 a replica,
     dp 2 against dp 1 on the same images, v8n's timed; PipelinedYOLO (384 x 640 x 8) and
     PipelinedRTDETR (640² x 8, 300 queries) at 2 and 4 stages and the
     row bands of one 2176 x 3840 frame over 4 entries against the plain
     forward (PAR_BOX_ATOL / PAR_SCORE_ATOL; RT-DETR PAR_RT_*), then
     timed in bfloat16 against the plain bfloat16 forward; the bands'
     224 x 160 (7 bands of 8 entries) and 256 x 192 (8 bands) cases; then
     ``dryrun_multicard([cuda:0] * 8)`` and its ``[dryrun]`` lines;
     results also in chiprun_out/parallel.json;
  8. print the command time, the kernels' JSON line (each kernel's
     launches summed over every path above), the card line, and last the
     ok line.

  7e. the offline and auxiliary modules, each with its launch counts
     (any other count fails): ``[native]`` (the C++ host ops and the
     libjpeg helpers built from runtime/native/*.cpp with g++; the
     overlay and both canvases equal to the numpy paths on a 1080p frame;
     a 2 x 1080p canvas JPEG-encoded and decoded, against PIL; the host
     tail's frames/s, native against numpy + PIL; where libjpeg is
     missing, a ``jpeg: unavailable (<reason>)`` line and PIL named as the
     encoder), ``[entry] preview --profile`` (a trace file holding the
     card's kernels), ``[entry] warmup`` (the gate on: 4 launches),
     ``[entry] calibrate`` and ``[entry] calibrate_gate`` (the card's
     report equal to the CPU's), ``[eval] weather``, ``[eval] trackers``,
     ``[eval] benchmark_trackers`` and ``[eval] dtype_ladder`` (the tools
     at their defaults, 96 frames at 256 px, JSON to chiprun_out/; then
     by stage against the CPU: fog within 2 levels in <= 0.1 %, float32
     detections within BOX_TOL / CONF_TOL with ids equal, off-row scores
     and false positives equal, the host scenarios' table equal, the
     dtype rows within 1e-3), ``[profile] rtdetr / detect / preprocess``
     (1080p x 8, RT-DETR at 720p; every preprocess candidate equal to its
     plain version; chiprun_out/profile_*.json) and ``[autotune] --quick
     --sweeps clahe_chunk`` (five bench processes; each trial's batches
     launch each kernel once); results in chiprun_out/tools.json;
Every path's counts hold K1-K3 as before; K4-K6 are held exactly where a
path names them (the main path, ``[graph]``, the second paths, the
tracker backends, the fleet, the bench lines) and summed into the
``kernels`` line everywhere.

Options: ``--kernels-only`` stops after phase 3; ``--graph-only`` runs
phase 3 and the ``[graph]`` phases; ``--rtdetr-only`` runs K7's checks
and ``[graph] rtdetr`` / ``rtdetr_demo`` alone; ``--train-only`` runs
only phase 7c (training); ``--parallel-only`` only phase 7d;
``--tools-only`` only phase 7e; ``--fleet-cards`` runs
only the fleet on every visible card against the same fleet on one
(``fleet_cards_phase``; needs 2 cards or more); ``--multi-cards`` runs
``multi_cards_phase`` on 2 and 4 distinct cards (needs 2 or more): the
dp step and the dp x tp step against one replica, the dp step timed on
1, 2 and 4 cards (images/s, step ms, peak memory a card, host syncs),
``cli.train --dp n`` with a save and ``--resume``, ``forward_paths``
over the cards, and profiler timelines of how long two cards or more
were busy at once (chiprun_out/multi_cards.json,
chiprun_out/pipeline_2cards_trace.json); ``--profile`` adds a
torch.profiler pass over one bfloat16 batch (device busy share, kernel
launches, top kernels; tables in chiprun_out/profile.txt).
The pass also prints the hand-written kernels' device times.

Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
# H100 SXM float32 rate outside the tensor cores; the kernels' integer
# compares and adds are counted against it too (no faster scalar rate)
SCALAR_OPS_PER_S = 67e12
# scalar operations per element, as the kernels compute them
K1_OPS_PER_PIXEL = 1               # one histogram increment
K1_OPS_PER_BIN = 14                # clip, redistribute, 8-step scan, scale
K2_OPS_PER_PIXEL = 14              # 4 converts, 6 mul, 3 add, 1 rounding add
# the pixel's column of three sorted once for the three outputs it feeds
# (min3 + max3 = 4 compares, 4 adds for the middle), then max3 + min3 of
# the neighbouring columns (4) and two med3 (8 each)
K3_OPS_PER_PIXEL = 28
L2_FLUSH_BYTES = 256 << 20         # well over the card's 50 MB L2
BATCH, HEIGHT, WIDTH = 8, 1080, 1920
BOX_TOL, CONF_TOL = 0.05, 2e-3     # as tests/test_torch_pipeline.py
T_START = time.perf_counter()
GATE_RTOL = 1e-5                   # impulse statistic, card against CPU


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events. The calls queue behind a few milliseconds of fills, so the
    card runs them one after the other however long the host takes to
    enqueue each: a kernel shorter than its wrapper's launch cost would
    otherwise be timed at the host's pace."""
    import torch
    for _ in range(warmup):
        fn()
    blocker = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(40):
        blocker.fill_(i & 1)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_flushed(fn, iters: int = 20) -> float:
    """Median time of ``fn`` alone when a write of L2_FLUSH_BYTES has
    just gone through L2: what a caller pays whose input other stages
    have pushed out of the cache. Events sit around the one call; the
    time of an empty event pair is taken off."""
    import torch
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(2 * iters)]
    fn()
    for i, (start, end) in enumerate(pairs):
        scratch.fill_(i & 1)
        start.record()
        if i < iters:
            fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs[:iters])
    empty = sorted(a.elapsed_time(b) for a, b in pairs[iters:])
    return max(times[iters // 2] - empty[iters // 2], 0.0)


def bound(nbytes: int, nops: int) -> dict:
    """The least time for the work: the larger of bytes over the memory
    rate and scalar operations over the scalar rate, and which one it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def pipeline_cfg(model: str):
    """bench.py::_cfg(1080, 1920, 8) with the demo checkpoint."""
    from roadvision_tpu_torch.tools.bench import bench_cfg
    return bench_cfg(HEIGHT, WIDTH, BATCH, model)


def render_batches(n: int, seed: int = 0):
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    src = SyntheticRoadSource(WIDTH, HEIGHT, num_vehicles=6, seed=seed)
    out = []
    for k in range(n):
        frames = np.stack([src.render(k * BATCH + i) for i in range(BATCH)])
        ts = 1000.0 + (k * BATCH + np.arange(BATCH)) / 30.0
        out.append((frames, ts))
    return out


def check_kernels(frames: np.ndarray):
    """Phase 3: every kernel against its plain version on the card."""
    import torch
    from roadvision_tpu_torch.ops import clahe as C
    from roadvision_tpu_torch.ops import color
    from roadvision_tpu_torch.ops import median as M

    dev = torch.device("cuda")
    x = torch.from_numpy(frames).to(dev)
    y = color.bgr_planes_to_ycrcb_i32(x[..., 0], x[..., 1], x[..., 2])[0] \
        .contiguous()                                     # (8, 1080, 1920)
    rng = np.random.RandomState(0)
    noise = torch.from_numpy(
        rng.randint(0, 256, (BATCH, 1079, 1917)).astype(np.uint8)).to(dev)
    rows = {}

    errs = {"clahe_tile_luts": 0, "clahe_apply": 0, "median_k": 0}

    def same(a, b, what):
        torch.cuda.synchronize()
        err = int((a.int() - b.int()).abs().max())
        name = what.split()[0]
        errs[name] = max(errs[name], err)
        if err != 0:
            fail(f"{what}: kernel differs from its plain version "
                 f"(max |err| {err})")

    def rand_planes(shape, offset=0):
        """Seeded noise with a flat band; ``offset`` shifts the storage
        off its 16-byte boundary (the tensor stays contiguous)."""
        p = rng.randint(0, 256, shape).astype(np.uint8)
        p[:, : shape[1] // 5] = 90
        flat = torch.empty(p.size + offset, dtype=torch.uint8, device=dev)
        out = flat[offset:].view(shape)
        out.copy_(torch.from_numpy(p))
        return out

    def clahe_case(name, plane, gy, gx):
        n, h, w = plane.shape
        pad_h, pad_w, th, tw = C.pad_plan(h, w, gy, gx)
        xe = C._reflect_pad_101(plane, pad_h, pad_w)
        clip, scale = C.clip_count(2.0, th * tw), C.lut_scale(th * tw)
        k_luts = C.clahe_tile_luts(xe, gy, gx, clip, scale)
        p_luts = C.tile_luts_plain(xe, gy, gx, clip, scale)
        same(k_luts, p_luts, f"clahe_tile_luts ({name})")
        for blend in C.BLENDS:
            same(C.clahe_apply(plane, k_luts, th, tw, blend),
                 C.apply_plain(plane, k_luts, th, tw, blend),
                 f"clahe_apply {blend} ({name})")
        print(f"[kernels] CLAHE {name} {tuple(plane.shape)} grid {gy}x{gx}: "
              f"K1 and K2 (cv2, fixed) bit-equal to plain", flush=True)
        return plane, xe, k_luts, th, tw, clip, scale

    # K1 + K2 on the main-path plane and on a ragged plane, then the
    # shapes behind K2's edge paths: other grids, a tile of 4 x 4 pixels,
    # ragged tails, and a pointer that is not word-aligned
    cases = {"main": clahe_case("main", y, 8, 8),
             "ragged": clahe_case("ragged", noise, 8, 8)}
    for shape, grid, offset in (((3, 120, 161), (2, 3), 0),
                                ((1, 64, 64), (16, 16), 0),
                                ((2, 270, 484), (16, 16), 0),
                                ((2, 97, 203), (8, 8), 0),
                                ((2, 96, 128), (4, 4), 1)):
        clahe_case("edge" + (" unaligned" if offset else ""),
                   rand_planes(shape, offset), *grid)

    def k1_case(name, xe, gy, gx, clip_limit=2.0):
        th, tw = xe.shape[1] // gy, xe.shape[2] // gx
        clip, scale = C.clip_count(clip_limit, th * tw), C.lut_scale(th * tw)
        same(C.clahe_tile_luts(xe, gy, gx, clip, scale),
             C.tile_luts_plain(xe, gy, gx, clip, scale),
             f"clahe_tile_luts ({name})")

    # K1 alone: data and shapes behind its fast and its guarded paths
    one_value = torch.full((BATCH, HEIGHT, WIDTH), 77, dtype=torch.uint8,
                           device=dev)
    g = (np.linspace(40, 200, WIDTH)[None, None, :]
         + np.linspace(0, 30, HEIGHT)[None, :, None]
         + rng.normal(0, 2.0, (BATCH, HEIGHT, WIDTH)))
    camera = torch.from_numpy(np.clip(g, 0, 255).astype(np.uint8)).to(dev)
    full_noise = cases["ragged"][1]            # 1079 x 1917 padded to 1080p
    k1_case("one value", one_value, 8, 8)
    k1_case("camera-like", camera, 8, 8)
    k1_case("one plane", camera[:1], 8, 8)
    k1_case("no clip", y, 8, 8, clip_limit=0.0)
    k1_case("4x4-pixel tiles", rand_planes((1, 16, 16)), 4, 4)
    k1_case("tile width 24, unaligned", rand_planes((2, 64, 96), 3), 4, 4)
    k1_case("4K", rand_planes((2, 2160, 3840)), 8, 8)
    print("[kernels] K1 also bit-equal on a plane of one value, a "
          "camera-like plane, one plane, clip 0, 4x4-pixel tiles, tile "
          "width 24 at an odd pointer, and 2 x 2160 x 3840", flush=True)

    plane, xe, luts, th, tw, clip, scale = cases["main"]
    n, h, w = plane.shape
    # K2 on the letterbox's sample grid of the main plane (stride 3)
    sample = (h, w, (3, 1, h // 3), (3, 1, w // 3))
    grid_px = plane[:, 1::3, 1::3].contiguous()
    for blend in C.BLENDS:
        got = C.clahe_apply(grid_px, luts, th, tw, blend, sample=sample)
        same(got, C.apply_plain(grid_px, luts, th, tw, blend, sample=sample),
             f"clahe_apply {blend} (sampled)")
        same(got, C.clahe_apply(plane, luts, th, tw, blend)[:, 1::3, 1::3],
             f"clahe_apply {blend} (sampled vs full)")
    print(f"[kernels] K2 on the {h // 3} x {w // 3} sample grid: bit-equal "
          f"to plain and to the full result sliced", flush=True)
    rows["clahe_tile_luts"] = dict(
        ms=cuda_ms(lambda: C.clahe_tile_luts(xe, 8, 8, clip, scale), 50),
        plain_ms=cuda_ms(lambda: C.tile_luts_plain(xe, 8, 8, clip, scale),
                         5, 1),
        **bound(xe.numel() + luts.numel(),
                K1_OPS_PER_PIXEL * xe.numel()
                + K1_OPS_PER_BIN * luts.numel()))
    rows["clahe_apply"] = dict(
        ms=cuda_ms(lambda: C.clahe_apply(plane, luts, th, tw, "cv2"), 50),
        plain_ms=cuda_ms(lambda: C.apply_plain(plane, luts, th, tw, "cv2"),
                         5, 1),
        fixed_ms=cuda_ms(lambda: C.clahe_apply(plane, luts, th, tw,
                                               "fixed"), 50),
        **bound(2 * plane.numel() + luts.numel() + 20 * (h + w),
                K2_OPS_PER_PIXEL * plane.numel()))

    # K3 at the main path's shape: 3 planes x 8 frames of 1080p, k = 3
    planes = torch.stack([x[..., c] for c in range(3)]) \
        .reshape(3 * BATCH, HEIGHT, WIDTH).contiguous()
    same(M.median_planes(planes, 3), M.median_plain(planes, 3),
         "median_k k=3 (main)")
    small = torch.from_numpy(
        rng.randint(0, 256, (3, 270, 481)).astype(np.uint8)).to(dev)
    for k in (3, 5, 7, 9):
        same(M.median_planes(small, k), M.median_plain(small, k),
             f"median_k k={k} (small)")
    # the k = 3 kernel's edge paths: ragged widths, a height that is no
    # multiple of a thread's rows, one-pixel planes, an unaligned pointer
    edge = (((2, 37, 1917), 0), ((3, 13, 17), 0), ((2, 33, 2), 0),
            ((1, 1, 1), 0), ((2, 5, 16), 0), ((2, 43, 64), 1))
    for shape, offset in edge:
        p = rand_planes(shape, offset)
        same(M.median_planes(p, 3), M.median_plain(p, 3),
             f"median_k k=3 {shape}" + (" unaligned" if offset else ""))
    # the gate's impulse statistic: the stride-4 gray subsample of the
    # gated path's batch (clean, low-contrast and salt-and-pepper frames)
    mx = torch.from_numpy(mixed_batch(frames)).to(dev)
    gate_sub = color.gray_from_bgr_planes(mx[..., 0], mx[..., 1], mx[..., 2]) \
        [:, ::4, ::4].contiguous()
    if tuple(gate_sub.shape) != (BATCH, HEIGHT // 4, WIDTH // 4) \
            or gate_sub.dtype != torch.uint8:
        fail(f"gate subsample is {gate_sub.dtype} {tuple(gate_sub.shape)}")
    same(M.median_planes(gate_sub, 3), M.median_plain(gate_sub, 3),
         "median_k k=3 (gate subsample)")
    print("[kernels] median: K3 bit-equal to plain at k=3 (24 x 1080p), "
          "k=3 on the gate's 8 x 270 x 480 gray subsample, "
          "k=3,5,7,9 (3 x 270 x 481) and k=3 at "
          + ", ".join("x".join(map(str, sh)) for sh, _ in edge), flush=True)
    rows["median_k"] = dict(
        ms=cuda_ms(lambda: M.median_planes(planes, 3), 50),
        plain_ms=cuda_ms(lambda: M.median_plain(planes, 3), 5, 1),
        **bound(2 * planes.numel(), K3_OPS_PER_PIXEL * planes.numel()))
    flushed = {
        "clahe_tile_luts": lambda: C.clahe_tile_luts(xe, 8, 8, clip, scale),
        "clahe_apply": lambda: C.clahe_apply(plane, luts, th, tw, "cv2"),
        "median_k": lambda: M.median_planes(planes, 3)}
    for name, fn in flushed.items():
        rows[name]["flushed_ms"] = cuda_ms_flushed(fn)
        print(f"[kernels] {name}: {rows[name]['flushed_ms']:.4f} ms with L2 "
              f"flushed before each call (median of 20)", flush=True)
    # K1's counting depends on the data: the same shape, other planes
    for name, data in (("noise", full_noise), ("one value", one_value),
                       ("camera-like", camera)):
        def fn(data=data):
            return C.clahe_tile_luts(data, 8, 8, clip, scale)
        print(f"[kernels] clahe_tile_luts on {name}: {cuda_ms(fn, 50):.4f} "
              f"ms warm, {cuda_ms_flushed(fn):.4f} ms flushed", flush=True)
    # the camera fleet's folded batches (4 streams x 8 frames: 32 luma
    # planes, 96 colour planes) at multi_stream.yaml's 720p and at 1080p
    for r in rows.values():
        r["fleet"] = {}
    for fh, fw in ((720, 1280), (HEIGHT, WIDTH)):
        fp, fxe, fluts, fth, ftw, fclip, fscale = clahe_case(
            f"fleet {fh}p", torch.cat([y[:, :fh, :fw]] * 4).contiguous(),
            8, 8)
        fc = torch.cat([planes[:, :fh, :fw]] * 4).contiguous()
        same(M.median_planes(fc, 3), M.median_plain(fc, 3),
             f"median_k k=3 (fleet {fh}p)")
        work = {
            "clahe_tile_luts": (
                lambda: C.clahe_tile_luts(fxe, 8, 8, fclip, fscale),
                lambda: C.tile_luts_plain(fxe, 8, 8, fclip, fscale),
                bound(fxe.numel() + fluts.numel(),
                      K1_OPS_PER_PIXEL * fxe.numel()
                      + K1_OPS_PER_BIN * fluts.numel()), fxe.shape[0]),
            "clahe_apply": (
                lambda: C.clahe_apply(fp, fluts, fth, ftw, "cv2"),
                lambda: C.apply_plain(fp, fluts, fth, ftw, "cv2"),
                bound(2 * fp.numel() + fluts.numel() + 20 * (fh + fw),
                      K2_OPS_PER_PIXEL * fp.numel()), fp.shape[0]),
            "median_k": (
                lambda: M.median_planes(fc, 3),
                lambda: M.median_plain(fc, 3),
                bound(2 * fc.numel(), K3_OPS_PER_PIXEL * fc.numel()),
                fc.shape[0])}
        for name, (fn, plain, bd, n_planes) in work.items():
            row = dict(ms=cuda_ms(fn, 50), flushed_ms=cuda_ms_flushed(fn),
                       plain_ms=cuda_ms(plain, 3, 1), **bd)
            rows[name]["fleet"][f"{n_planes}x{fh}x{fw}"] = row
            print(f"[kernels] {name} at the fleet shape {n_planes} x {fh} x "
                  f"{fw}: bit-equal to plain; {row['ms']:.4f} ms warm, "
                  f"{row['flushed_ms']:.4f} ms flushed, plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})", flush=True)
    for name, r in rows.items():
        r["max_abs_err"] = errs[name]
        print(f"[kernels] {name}: {r['ms']:.4f} ms kernel, "
              f"{r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})"
              + (f", fixed blend {r['fixed_ms']:.4f} ms"
                 if "fixed_ms" in r else ""), flush=True)
    return rows


def compare_results(cpu, gpu) -> float:
    """Per-frame Detection lists: same count, class, track id; box and
    conf within the stated tolerance. Returns the max box error."""
    worst = 0.0
    for fi, (a, b) in enumerate(zip(cpu, gpu)):
        if not np.array_equal(a.proc, b.proc):
            fail(f"frame {fi}: processed frame differs from the CPU path")
        if len(a.detections) != len(b.detections):
            fail(f"frame {fi}: {len(a.detections)} CPU detections vs "
                 f"{len(b.detections)} on the card")
        for da, db in zip(a.detections, b.detections):
            if da.cls_id != db.cls_id or da.track_id != db.track_id:
                fail(f"frame {fi}: class/track id differ "
                     f"({da.cls_id},{da.track_id}) vs "
                     f"({db.cls_id},{db.track_id})")
            box = max(abs(p - q) for p, q in zip(
                (da.x1, da.y1, da.x2, da.y2), (db.x1, db.y1, db.x2, db.y2)))
            worst = max(worst, box)
            if box > BOX_TOL or abs(da.conf - db.conf) > CONF_TOL:
                fail(f"frame {fi}: box err {box} / conf err "
                     f"{abs(da.conf - db.conf)} over tolerance")
    return worst


def mixed_batch(frames: np.ndarray, seed: int = 1) -> np.ndarray:
    """A batch for the gate: frames 2 and 5 squeezed to a span under the
    contrast threshold, frames 3 and 6 with salt-and-pepper noise on 5 %
    of their pixels, the rest clean."""
    rng = np.random.RandomState(seed)
    out = frames.copy()
    for i in (2, 5):
        out[i] = out[i] // 16 + 100
    for i in (3, 6):
        hit = rng.rand(*out.shape[1:3]) < 0.05
        out[i][hit] = rng.choice([0, 255], size=(int(hit.sum()), 1))
    return out


def second_paths(model: str, batches, card: str) -> dict:
    """The gated, LAB and sampled engines at 1080p x 8 in float32: one
    batch each against the port's CPU path, then two timed batches with
    the launch counts from 0."""
    import torch
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.ops.color import gray_from_bgr_planes
    from roadvision_tpu_torch.runtime import PipelineEngine

    base = pipeline_cfg(model)
    base["tpu"]["compute_dtype"] = "float32"
    lab_chain = [{"name": "CLAHEDehaze",
                  "params": {"space": "LAB", "clip_limit": 2.0,
                             "tile_grid": 8}},
                 {"name": "MedianDerain", "params": {"ksize": 3}}]
    paths = {
        "gated": ({"preprocess": {"auto_gate": {
            "enable_low_contrast_gate": True, "stat": "span",
            "contrast_thresh": 20.0, "impulse_thresh": 2.5}}}, True),
        "lab": ({"preprocess": {"chain": lab_chain}}, True),
        "sampled": ({"tpu": {"sampled_preprocess": True}}, False),
    }
    from roadvision_tpu_torch.config import merge
    out = {}
    for name, (over, want_proc) in paths.items():
        cfg = merge(base, over)
        frames, ts = batches[0]
        if name == "gated":
            frames = mixed_batch(frames)
        gpu = PipelineEngine(cfg, device="cuda")
        cpu = PipelineEngine(cfg, device="cpu")
        r_gpu = gpu.process_batch(frames, ts, want_proc=want_proc)
        r_cpu = cpu.process_batch(frames, ts, want_proc=want_proc)
        worst = compare_results(r_cpu, r_gpu)
        n_dets = sum(len(r.detections) for r in r_cpu)
        if n_dets == 0:
            fail(f"{name} path: no detections to compare")
        note = ""
        if name == "gated":
            ran = [not np.array_equal(r.proc, r.raw) for r in r_gpu]
            if ran != [False, False, True, True, False, True, True, False]:
                fail(f"gated path: the chain ran on frames {ran}")
            # the statistics behind the decision, card against CPU
            bgr = torch.from_numpy(frames)
            stats = []
            for eng in (cpu, gpu):
                px = bgr.to(eng.device)
                gray = gray_from_bgr_planes(px[..., 0], px[..., 1],
                                            px[..., 2])
                stats.append([s.cpu().numpy()
                              for s in eng.pipeline.gate_stats(gray)])
            (span_c, imp_c), (span_g, imp_g) = stats
            if not np.array_equal(span_c, span_g):
                fail(f"gated path: span {span_g} on the card, {span_c} on "
                     f"the CPU")
            if not np.allclose(imp_g, imp_c, rtol=GATE_RTOL, atol=0.0):
                fail(f"gated path: impulse statistic {imp_g} on the card, "
                     f"{imp_c} on the CPU")
            if not ((span_c < 20.0) == np.isin(np.arange(BATCH), (2, 5))) \
                    .all() or not ((imp_c >= 2.5) == np.isin(
                        np.arange(BATCH), (3, 6))).all():
                fail(f"gated path: span {span_c} / impulse {imp_c} do not "
                     f"split the batch as built")
            note = (" the chain ran on frames 2, 3, 5, 6 only; span equal "
                    "and impulse statistic within "
                    f"{GATE_RTOL:g} relative of the CPU path's "
                    f"(max {np.abs(imp_g / imp_c - 1).max():.1e});")
        if name == "sampled" and gpu.sampled_plans(HEIGHT, WIDTH, False) \
                != ((3, 1, 360), (3, 1, 640)):
            fail("sampled path: 1080p -> 640 is not the stride-3 grid")
        timed = [(mixed_batch(f) if name == "gated" else f, t)
                 for f, t in batches[1:3]]
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for frames, ts in timed:
            gpu.process_batch(frames, ts, want_proc=want_proc)
        torch.cuda.synchronize()
        fps = 2 * BATCH / (time.perf_counter() - t0)
        counts = add_to_totals(dict(kernels.launch_counts))
        # per batch one launch of each kernel; the gate's impulse
        # statistic adds one of the median on the gray subsample
        want = {"clahe_tile_luts": 2, "clahe_apply": 2,
                "median_k": 4 if name == "gated" else 2,
                **tail_want(2, 2 * BATCH)}
        if counts != want:
            launch_mismatch(f"{name} path: launches {counts} in 2 batches, "
                            f"expected {want}")
        print(f"[e2e] {name} path, float32: {n_dets} detections match the "
              f"CPU path (max box err {worst:.2e} px), frames bit-equal;"
              f"{note} 2 more batches at {fps:.1f} frames/s ({card}); "
              f"launches in them {counts}", flush=True)
        out[name] = {"fps_f32": fps, "launches_2_batches": counts,
                     "detections": n_dets}
    return out


# every path's launches, read just after the path (launches made only to
# compare a kernel with its plain version are not counted)
PATH_TOTALS = {"clahe_tile_luts": 0, "clahe_apply": 0, "median_k": 0,
               "assoc_greedy": 0, "assoc_auction": 0, "nms_keep": 0,
               "deform_sample": 0, "deform_sample_bwd": 0}
# the preprocess kernels (K1-K3), held to one launch a batch on every
# path, and the rest, held to what each path runs: the tail's loops
# (K4-K6: NMS, then the association of every tracked frame) and
# RT-DETR's deformable sampling (K7, once a decoder layer of a forward;
# K8, its backward, once a decoder layer of a training step, and never
# on a serving path)
PRE_KERNELS = ("clahe_tile_luts", "clahe_apply", "median_k")
TAIL_KERNELS = ("nms_keep", "assoc_greedy", "assoc_auction", "deform_sample",
                "deform_sample_bwd")
RTDETR_LAYERS = 6                  # K7 launches a serving RT-DETR-L forward


def warm(captures: int) -> int:
    """Steps run by the warm-ups of ``captures`` CUDA graph captures
    (``runtime/graph.py``: each capture first runs its step
    WARMUP_CALLS times on a side stream, and those launches count)."""
    from roadvision_tpu_torch.runtime.graph import WARMUP_CALLS
    return WARMUP_CALLS * captures


def tail_want(batches: int, frames: int, per_frame: int = 1,
              assoc: str = "assoc_greedy", deform: int = 0) -> dict:
    """K4-K8 launches of ``batches`` detector batches whose tracker steps
    ``frames`` frames (a fleet's stacked step: frames of one stream),
    ``per_frame`` association launches a frame, and ``deform`` K7
    launches in all (K8: none, serving takes no gradient)."""
    return {"nms_keep": batches, "assoc_greedy": 0, "assoc_auction": 0,
            "deform_sample": deform, "deform_sample_bwd": 0,
            assoc: frames * per_frame}


def tracked(frames: int = BATCH, per_frame: int = 1,
            assoc: str = "assoc_greedy", nms: bool = True,
            deform: int = 0):
    """The tail of a path each of whose steps runs NMS (where ``nms``),
    ``deform`` K7 launches (RT-DETR: RTDETR_LAYERS) and then the tracker
    over ``frames`` frames: → K4-K7 of ``n`` steps."""
    return lambda n: tail_want(n if nms else 0, n * frames, per_frame,
                               assoc, n * deform)


NO_TAIL = {k: 0 for k in TAIL_KERNELS}


def per_batch_ok(per_batch: dict) -> bool:
    """A bench line's launches per (fleet) batch of BATCH frames: K1-K3
    and K6 once, K4 once a frame (a fleet's stacked step: once a frame
    for every stream), K5 never."""
    return per_batch == {**{k: 1.0 for k in PRE_KERNELS},
                         **tail_want(1, BATCH)}


def launch_mismatch(msg: str) -> None:
    """A path launched other kernels, or other counts, than it runs."""
    fail(msg)


def check_tail(what: str, counts: dict, want: dict) -> None:
    if {k: counts[k] for k in TAIL_KERNELS} != want:
        launch_mismatch(f"{what}: tail launches {counts}, expected {want}")


def add_to_totals(counts: dict) -> dict:
    for k, v in counts.items():
        PATH_TOTALS[k] += v
    return counts


class PathLaunches:
    """The kernels' launch counts around one path: 0 just before, read
    just after, and held to one launch of each preprocess kernel per
    batch and to the path's tail."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from roadvision_tpu_torch import kernels
        kernels.reset_launch_counts()
        return self

    def check(self, batches: int, tail, at_least: bool = False) -> dict:
        """``batches`` steps (at least, with ``at_least``), warm-ups of
        captures included; ``tail``: K4-K7 as a dict, or as a function of
        the steps counted."""
        from roadvision_tpu_torch import kernels
        counts = dict(kernels.launch_counts)
        pre = {counts[k] for k in PRE_KERNELS}
        ok = len(pre) == 1 and (
            counts["median_k"] >= batches if at_least
            else counts["median_k"] == batches)
        if not ok or batches < 1:
            launch_mismatch(f"{self.name}: launches {counts} for "
                            f"{'at least ' if at_least else ''}{batches} "
                            f"batches")
        check_tail(self.name, counts,
                   tail(counts["median_k"]) if callable(tail) else tail)
        return add_to_totals(counts)

    def __exit__(self, *exc):
        return False


def same_detections(a, b, what: str) -> int:
    """Two per-frame result lists: every field of every detection equal
    bit for bit. Returns the number of detections."""
    n = 0
    if len(a) != len(b):
        fail(f"{what}: {len(a)} frames against {len(b)}")
    for fi, (ra, rb) in enumerate(zip(a, b)):
        if len(ra.detections) != len(rb.detections):
            fail(f"{what}: frame {fi} has {len(ra.detections)} detections "
                 f"against {len(rb.detections)}")
        for da, db in zip(ra.detections, rb.detections):
            if da != db:
                fail(f"{what}: frame {fi} differs: {da} against {db}")
            n += 1
    return n


def check_avi(path: Path, n_frames: int, size) -> None:
    """RIFF structure, JPEG frame count, first frame decodes, and the
    port's reader reads every frame back at ``size`` (w, h)."""
    import io

    from PIL import Image
    from roadvision_tpu_torch.io_video import MJPEGAviReader
    data = path.read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI " or b"idx1" not in data \
            or int.from_bytes(data[4:8], "little") != len(data) - 8:
        fail(f"{path}: not a complete RIFF AVI")
    if data.count(b"\xff\xd8\xff") != n_frames:
        fail(f"{path}: {data.count(bytes([255, 216, 255]))} JPEG frames, "
             f"expected {n_frames}")
    first = data.index(b"\xff\xd8\xff")
    if Image.open(io.BytesIO(data[first:])).size != tuple(size):
        fail(f"{path}: first frame is not {size}")
    reader = MJPEGAviReader(str(path))
    try:
        if len(reader) != n_frames:
            fail(f"{path}: the reader finds {len(reader)} frames")
        for _ in range(n_frames):
            ok, img = reader.read_frame()
            if not ok or img.shape != (size[1], size[0], 3):
                fail(f"{path}: a frame does not read back")
    finally:
        reader.release()


def serving_cfg(model: str):
    """The main-path config with the camera the entry points open: the
    synthetic road scene at 1080p, six vehicles."""
    from roadvision_tpu_torch.config import merge
    return merge(pipeline_cfg(model), {
        "camera": {"source": "synthetic:6", "width": WIDTH, "height": HEIGHT,
                   "fps_request": 30}})


def entry_api(model: str, batches, out_dir: Path) -> dict:
    import roadvision_tpu_torch as rvt
    from roadvision_tpu_torch.runtime import PipelineEngine
    cfg = serving_cfg(model)
    pipe = rvt.Pipeline(cfg)
    n = 2 * BATCH
    with PathLaunches("[entry] api") as pl:
        got = list(pipe(max_frames=n))
        # the engine's first batch captures its graph
        counts = pl.check(n // BATCH + warm(1), tracked())
    if len(got) != n:
        fail(f"[entry] api: {len(got)} results for {n} frames")
    # the same frames and stamps through process_batch of a fresh engine
    ref = PipelineEngine(cfg)
    want = []
    for k in range(n // BATCH):
        rows = got[k * BATCH:(k + 1) * BATCH]
        frames = np.stack([r.raw for r in rows])
        if not np.array_equal(frames, batches[k][0]):
            fail("[entry] api: the source's frames differ from the renderer's")
        want += ref.process_batch(frames, np.array([r.ts for r in rows]))
    n_dets = same_detections(want, got, "[entry] api")
    for ra, rb in zip(want, got):
        if not np.array_equal(ra.proc, rb.proc):
            fail("[entry] api: processed frames differ")
    if n_dets == 0:
        fail("[entry] api: no detections to compare")
    # one image: the row that the batch of eight gives for it, in float32
    # (a batch of one may take another convolution algorithm, which
    # bfloat16 would show)
    if not pipe.detect_image(batches[0][0][3]):
        fail("[entry] api: detect_image finds nothing in bfloat16")
    det32 = rvt.Pipeline(cfg, tpu={"compute_dtype": "float32"}) \
        .engine.detector
    one = det32.infer(batches[0][0][3])
    row = det32.infer_batch(batches[0][0])
    names = [det32.names[i] for i in range(det32.nc)]
    from roadvision_tpu_torch.detect import DetectionBatch
    of8 = DetectionBatch(row.boxes[3], row.conf[3], row.cls_id[3],
                         row.valid[3]).to_detections(names)
    if not one or len(one) != len(of8):
        fail(f"[entry] api: detect_image gives {len(one)} detections, the "
             f"batch row {len(of8)}")
    worst = 0.0
    for da, db in zip(one, of8):
        box = max(abs(p - q) for p, q in zip(
            (da.x1, da.y1, da.x2, da.y2), (db.x1, db.y1, db.x2, db.y2)))
        worst = max(worst, box)
        if da.cls_id != db.cls_id or box > BOX_TOL \
                or abs(da.conf - db.conf) > CONF_TOL \
                or not all(math.isfinite(v) for v in
                           (da.x1, da.y1, da.x2, da.y2, da.conf)):
            fail(f"[entry] api: detect_image {da} against batch row {db}")
    pipe.reset()
    avi = out_dir / "api.avi"
    with PathLaunches("[entry] api process_video") as pl:
        summary = pipe.process_video(None, str(avi), max_frames=n)
        pl.check(n // BATCH, tracked())
    if summary["frames"] != n or summary["unique_tracks"] < 1:
        fail(f"[entry] api: process_video summary {summary}")
    check_avi(avi, n, (WIDTH, HEIGHT))
    print(f"[entry] api: Pipeline over {n} frames equals process_batch on "
          f"the same frames bit for bit ({n_dets} detections, processed "
          f"frames too); detect_image gives the batch row within "
          f"{worst:.1e} px; process_video wrote {avi} ({summary}); "
          f"launches {counts}", flush=True)
    return {"launches": counts, "batches": n // BATCH, "detections": n_dets}


def entry_preview(model: str, tmp: Path) -> dict:
    import yaml
    from roadvision_tpu_torch.tools import preview
    cfg_path = tmp / "preview.yaml"
    cfg_path.write_text(yaml.safe_dump(serving_cfg(model)))
    avi = tmp / "preview.avi"
    n = 48
    with PathLaunches("[entry] preview") as pl:
        t0 = time.perf_counter()
        rc = preview.main(["--config", str(cfg_path), "--max-frames", str(n),
                           "--no-show", "--record", str(avi)])
        elapsed = time.perf_counter() - t0
        counts = pl.check(n // BATCH + warm(1), tracked())
    if rc != 0:
        fail(f"[entry] preview: main returned {rc}")
    check_avi(avi, n, (2 * WIDTH + 4, HEIGHT))
    print(f"[entry] preview: {n} frames recorded to a valid MJPEG AVI "
          f"({avi.stat().st_size >> 10} KiB, canvas {2 * WIDTH + 4}x{HEIGHT}) "
          f"and read back; {n / elapsed:.1f} frames/s with overlay, canvas "
          f"and JPEG encode; launches {counts}", flush=True)
    return {"launches": counts, "batches": n // BATCH,
            "fps_with_record": n / elapsed}


def entry_serve(model: str) -> dict:
    import http.client
    import io

    from PIL import Image
    from roadvision_tpu_torch.tools import serve
    before = set(threading.enumerate())
    with PathLaunches("[entry] serve") as pl:
        server, hub, worker = serve.serve_background(
            serving_cfg(model), port=0, max_frames=96)
        host, port = server.server_address[:2]
        try:
            parts = serve.read_stream_parts(host, port, 3, timeout=60.0)

            def get(path):
                conn = http.client.HTTPConnection(host, port, timeout=30.0)
                try:
                    conn.request("GET", path, headers={"Connection": "close"})
                    resp = conn.getresponse()
                    if resp.status != 200:
                        fail(f"[entry] serve: GET {path} -> {resp.status}")
                    return json.loads(resp.read())
                finally:
                    conn.close()

            stats = get("/stats")
            dets = get("/detections")
        finally:
            hub.close()
            server.shutdown()
            server.server_close()
            worker.join(timeout=60.0)
            server.thread.join(timeout=60.0)
        if worker.is_alive() or server.thread.is_alive():
            fail("[entry] serve: a thread did not stop")
        if hub.error is not None:
            fail(f"[entry] serve: the pipeline failed: {hub.error!r}")
        frames = hub.stats["frames"]
        counts = pl.check(math.ceil(frames / BATCH) + warm(1), tracked(),
                          at_least=True)
    deadline = time.time() + 20.0
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    left = set(threading.enumerate()) - before
    if left:
        fail(f"[entry] serve: threads still alive: {left}")
    if len(parts) != 3:
        fail(f"[entry] serve: {len(parts)} stream parts, expected 3")
    for jpeg in parts:
        if Image.open(io.BytesIO(jpeg)).size != (2 * WIDTH + 4, HEIGHT):
            fail("[entry] serve: a stream part is not the compare canvas")
    if not {"frames", "fps", "tracks_per_frame", "clients", "done"} \
            <= set(stats) or stats["frames"] < 1:
        fail(f"[entry] serve: /stats gives {stats}")
    if not {"ts", "frame", "detections"} <= set(dets) or not dets["detections"] \
            or not {"bbox", "conf", "cls_id", "name", "track_id",
                    "distance_m", "speed_kmh"} <= set(dets["detections"][0]):
        fail(f"[entry] serve: /detections gives {str(dets)[:300]}")
    print(f"[entry] serve: /stats {stats}; /detections frame "
          f"{dets['frame']} with {len(dets['detections'])} detections; 3 "
          f"stream parts decode to the canvas; stopped after {frames} frames "
          f"with every thread joined; launches {counts}", flush=True)
    return {"launches": counts, "frames": frames}


def state_phase(model: str, batches, tmp: Path, tracking=None) -> dict:
    """``[state]``: three batches, ``save_state``, three more; a fresh
    engine, ``load_state``, the same three: bit-equal. The file carries
    the JAX format's 25 ``sort_*`` arrays (and ``gmc_prev`` with GMC on)
    by name, and loads on the CPU path too."""
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    cfg = merge(pipeline_cfg(model), {"tracking": tracking or {}})
    label = "[state]" if not tracking else \
        f"[state] {json.dumps(tracking, sort_keys=True)}"
    first = PipelineEngine(cfg)
    seen = set()
    with PathLaunches(label) as pl:
        for frames, ts in batches[:3]:
            for r in first.process_batch(frames, ts, want_proc=False):
                seen |= {d.track_id for d in r.detections}
        path = tmp / f"state_{len(tracking or {})}.npz"
        first.save_state(path)
        with np.load(path) as z:
            want_keys = {f"sort_{k}" for k in JAX_SORT_FIELDS} | {"t0"} \
                | ({"gmc_prev"} if first.gmc_enabled else set())
            if set(z.files) != want_keys:
                fail(f"{label}: the file holds {sorted(z.files)}, the JAX "
                     f"format {sorted(want_keys)}")
        want = [first.process_batch(f, t, want_proc=False)
                for f, t in batches[3:6]]
        second = PipelineEngine(cfg)
        second.load_state(path)
        got = [second.process_batch(f, t, want_proc=False)
               for f, t in batches[3:6]]
        # two engines, each capturing its graph at its first batch
        counts = pl.check(9 + warm(2 * (first.step_mode == "graph")),
                          tracked(BATCH, 2 if tracking else 1))
    n = sum(same_detections(a, b, label) for a, b in zip(want, got))
    ids = {d.track_id for rs in got for r in rs for d in r.detections}
    speeds = sum(d.speed_kmh is not None
                 for rs in got for r in rs for d in r.detections)
    # OC-SORT starts tracks from confident detections only: the others
    # keep no id
    if n == 0 or (None in ids and not tracking) or speeds == 0 \
            or not (ids & seen) - {None}:
        fail(f"{label}: nothing carried over (ids {sorted(ids, key=str)} "
             f"after {sorted(seen, key=str)}, {speeds} speeds)")
    # the file also loads on the CPU path
    cpu = PipelineEngine(cfg, device="cpu")
    cpu.load_state(path)
    with np.load(path) as z:
        if cpu.sort_state.ids.device.type != "cpu" or not np.array_equal(
                cpu.sort_state.ids.numpy(), z["sort_ids"]):
            fail(f"{label}: the CPU engine did not take the state over")
    print(f"{label} three batches after load_state equal the uninterrupted "
          f"run bit for bit ({n} detections: {len(ids)} ids, "
          f"{len(ids & seen)} of them from before the save, boxes, "
          f"distance, speed); the file holds the JAX format's 25 sort_* "
          f"arrays{' and gmc_prev' if first.gmc_enabled else ''}; launches "
          f"{counts}", flush=True)
    return {"launches": counts, "batches": 9, "detections": n}


def tracker_phase(model: str, batches) -> dict:
    from roadvision_tpu_torch.detect import Detection
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.track import SortTracker
    cfg = pipeline_cfg(model)
    engine = PipelineEngine(cfg)
    tracker = SortTracker(dict(cfg["tracking"], det_capacity=engine.max_det,
                               track_slots=engine.track_slots))
    n = 0
    with PathLaunches("[tracker]") as pl:
        for frames, ts in batches[:2]:
            for r in engine.process_batch(frames, ts, want_proc=False):
                bare = [Detection(d.x1, d.y1, d.x2, d.y2, d.conf, d.cls_id,
                                  d.cls_name) for d in r.detections]
                out = tracker.update(bare, r.ts, projector=engine.projector)
                for d, e in zip(out, r.detections):
                    if d != e:
                        fail(f"[tracker]: SortTracker gives {d}, the engine "
                             f"{e}")
                    n += 1
        # the engine: 2 batches and its capture's warm-ups; the
        # SortTracker on the card: one association a frame
        runs = 2 + warm(1)
        counts = pl.check(runs, tail_want(runs, runs * BATCH + 2 * BATCH))
    if n == 0:
        fail("[tracker]: no detections to compare")
    print(f"[tracker] SortTracker.update over the engine's detections of "
          f"two batches gives the engine's ids, distances and speeds "
          f"({n} detections); launches {counts}", flush=True)
    return {"launches": counts, "batches": 2, "detections": n}


def bench_phase(model: str, card: str) -> dict:
    """The port bench in-process: its line parses, names the card, and
    its pipeline launched each kernel once per batch."""
    import contextlib
    import io

    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.tools import bench
    buf = io.StringIO()
    with PathLaunches("[bench]"), contextlib.redirect_stdout(buf):
        rc = bench.main(["--iters", "3", "--windows", "3", "--warmup", "1",
                         "--model", model])
        add_to_totals(dict(kernels.launch_counts))
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        fail(f"[bench]: rc {rc}, {len(lines)} lines on stdout")
    line = json.loads(lines[0])
    need = {"host_fed_process_batch_fps", "host_fed_stream_fps",
            "device_resident_fps", "stage_ms", "timer_ms",
            "launches_per_batch", "batch", "iters", "dtype", "card", "device"}
    if not need <= set(line) or line["card"] != card \
            or line["device"]["platform"] != "gpu":
        fail(f"[bench]: line lacks {need - set(line)} or names another card "
             f"({line.get('card')!r})")
    if not per_batch_ok(line["launches_per_batch"]):
        fail(f"[bench]: launches per batch {line['launches_per_batch']}")
    for key in ("host_fed_process_batch_fps", "host_fed_stream_fps",
                "device_resident_fps"):
        if not line[key]["median"] > 0 or not math.isfinite(
                line[key]["median"]):
            fail(f"[bench]: {key} is {line[key]}")
    print("[bench] " + lines[0], flush=True)
    return line


# ----------------------------------------------------------------------
# the tracker family, GMC, the temporal gate, MOT scoring

TRACK_RTOL = 1e-3      # distance and speed, card against CPU (as the tests)
REID_NPZ = "assets/reid_synthetic.npz"
# name → tracking overrides; strongsort turns GMC on by default
TRACKER_PATHS = {
    "sort": {},
    "hungarian": {"association": "hungarian"},
    "bytetrack": {"backend": "bytetrack"},
    "ocsort": {"backend": "ocsort"},
    "deepsort": {"backend": "deepsort"},
    "strongsort": {"backend": "strongsort"},
    "botsort": {"backend": "botsort", "gmc": True},
    "deepsort reid": {"backend": "deepsort", "reid_weights": REID_NPZ},
}
# the default steps, whose association (K4 / K5 in boxes mode) computes
# the IoU and the inverse map itself: no torch IoU helper runs on the card
BOXES_MODE_PATHS = ("sort", "hungarian")
# name → (association launches a frame, which kernel)
ASSOC_PER_FRAME = {"sort": (1,), "hungarian": (1, "assoc_auction"),
                   "bytetrack": (2,), "ocsort": (2,), "deepsort": (1,),
                   "strongsort": (1,), "botsort": (2,), "deepsort reid": (1,)}
# the JAX SortState's fields, in its order (roadvision_tpu/track/
# sort_tpu.py:79-111): a state file must carry each as sort_<name>
JAX_SORT_FIELDS = (
    "mean", "cov", "alive", "ids", "last_predict_ts", "last_update_ts",
    "hits", "hit_streak", "cls_id", "conf", "dist", "speed", "hist_ts",
    "hist_x", "hist_y", "hist_head", "hist_len", "next_id", "last_obs",
    "last_obs_ts", "prev_obs", "prev_obs_ts", "obs_mean", "obs_cov", "app")


class SharedFront:
    """The CPU path's preprocess and detector, computed once per distinct
    batch and shared by the CPU engines it is attached to: they run the
    same chain and the same detector on the same frames, and only their
    trackers (and what the trackers compute from the raw frames: GMC,
    descriptors) differ, which each engine still runs itself."""

    def __init__(self):
        self.memo = {}

    def _key(self, tag, t):
        import hashlib
        return tag, tuple(t.shape), hashlib.blake2b(
            t.contiguous().numpy().tobytes(), digest_size=16).hexdigest()

    def attach(self, engine):
        apply, run = engine.pipeline.apply_batch, engine.detector.run

        def shared_apply(frames):
            key = self._key("pre", frames)
            if key not in self.memo:
                self.memo[key] = apply(frames)
            return self.memo[key]

        def shared_run(frames, lb=None):
            key = self._key("det", frames) + (lb is None,)
            if key not in self.memo:
                self.memo[key] = run(frames, lb)
            return self.memo[key]

        engine.pipeline.apply_batch = shared_apply
        engine.detector.run = shared_run
        return engine


def compare_tracks(cpu, gpu, worst: dict, what: str) -> int:
    """``compare_results`` plus distance and speed within TRACK_RTOL;
    updates ``worst`` and returns the number of detections."""
    worst["box"] = max(worst["box"], compare_results(cpu, gpu))
    n = 0
    for a, b in zip(cpu, gpu):
        for da, db in zip(a.detections, b.detections):
            for k in ("distance_m", "speed_kmh"):
                x, y = getattr(da, k), getattr(db, k)
                if (x is None) != (y is None) or (x is not None and abs(
                        x - y) > TRACK_RTOL * max(1.0, abs(x))):
                    fail(f"{what}: {k} {y} on the card, {x} on the CPU")
                if x is not None:
                    worst[k] = max(worst[k], abs(x - y))
            n += 1
    return n


def replay_vs_eager(eng, host_batches, what: str, per_frame: tuple
                    ) -> dict:
    """The engine's replayed batches (``step_batch``, its graph for the
    batches' shape, captured beforehand) against its eager ones
    (``step``), each run from a reset state over the same batches: every
    output array bit-equal (NaN where NaN), the track state and GMC's
    carry after the last batch too; launches exact both ways (K1-K3 and
    K6 once a batch, the association ``per_frame`` a frame); no host read
    in a replayed batch."""
    import torch
    from roadvision_tpu_torch import kernels
    t0 = float(host_batches[0][1][0])
    inputs = [(torch.from_numpy(f).to(eng.device),
               torch.from_numpy((t - t0).astype(np.float32)).to(eng.device))
              for f, t in host_batches]
    n = len(inputs)
    runs, syncs, ends = {}, {}, {}
    for mode, fn in (("graph", eng.step_batch), ("eager", eng.step)):
        eng.reset()
        kernels.reset_launch_counts()
        kept = []
        syncs[mode] = count_syncs(lambda: [kept.append(
            [a.clone() for a in fn(f, t)[1]]) for f, t in inputs])
        exact_launches(f"{what} {mode}", {
            **{k: n for k in PRE_KERNELS},
            **tail_want(n, n * BATCH, *per_frame)})
        runs[mode] = [[a.cpu().numpy() for a in r] for r in kept]
        ends[mode] = [t.cpu().numpy() for t in eng.step_state()]
    if syncs["graph"]:
        fail(f"{what}: {syncs['graph']} host syncs in {n} replayed batches")
    n_det = 0
    for i, (g, e) in enumerate(zip(runs["graph"], runs["eager"])):
        for j, (a, b) in enumerate(zip(g, e)):
            if not np.array_equal(a, b, equal_nan=True):
                fail(f"{what}: batch {i} array {j} replayed differs from "
                     f"eager")
        n_det += int(g[3].sum())
    if not all(np.array_equal(a, b, equal_nan=True)
               for a, b in zip(ends["graph"], ends["eager"])):
        fail(f"{what}: the state after the replayed batches differs")
    return {"batches": n, "detections": n_det, "host_syncs": syncs}


def tracker_backends(model: str, batches, card: str, front) -> dict:
    """``[tracker] <backend>``: every path replays a CUDA graph on the
    card; three float32 batches on the card against the CPU path (ids
    equal, distance and speed within TRACK_RTOL, the state carried
    across), then the same three replayed against eager from a reset
    state (bit-equal, exact launches, no host read replayed), then
    bfloat16 timed as ``tools/bench.py`` times a path (frames/s of
    DET_WINDOWS windows of DET_ITERS batches, SORT + geometry stage ms
    of DET_WINDOWS batches), the association's host reads in one batch,
    launches 1 / 1 / 1 per batch; the default steps (BOXES_MODE_PATHS)
    call none of the torch IoU helpers on the card."""
    import torch
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.tools.bench import stage_ms, windows_fps
    from roadvision_tpu_torch.track import sort as tsort
    print(f"[tracker] card vs CPU tolerances: ids equal, boxes {BOX_TOL} "
          f"px, conf {CONF_TOL}, distance and speed {TRACK_RTOL} relative",
          flush=True)
    out = {}
    for name, over in TRACKER_PATHS.items():
        t0 = time.perf_counter()
        cfg = merge(pipeline_cfg(model), {"tracking": over})
        cfg32 = merge(cfg, {"tpu": {"compute_dtype": "float32"}})
        gpu = PipelineEngine(cfg32, device="cuda")
        if gpu.step_mode != "graph":
            fail(f"[tracker] {name}: runs {gpu.step_mode} "
                 f"({gpu.eager_reason})")
        cpu = front.attach(PipelineEngine(cfg32, device="cpu"))
        if "reid_weights" in over and gpu._embed_fn.__name__ != "embed":
            fail(f"[tracker] {name}: the learned embedder did not load")
        worst = {"box": 0.0, "distance_m": 0.0, "speed_kmh": 0.0}
        n, ids = 0, set()
        with PathLaunches(f"[tracker] {name}") as pl:
            for frames, ts in batches[:3]:
                got = []
                calls = torch_iou_calls(
                    lambda: got.append(gpu.process_batch(frames, ts)))
                if name in BOXES_MODE_PATHS and any(calls.values()):
                    fail(f"[tracker] {name}: the card's step called the "
                         f"torch IoU helpers {calls}")
                r_gpu = got[0]
                n += compare_tracks(cpu.process_batch(frames, ts), r_gpu,
                                    worst, f"[tracker] {name}")
                ids |= {d.track_id for r in r_gpu for d in r.detections}
            runs = 3 + warm(1)
            pl.check(runs, tracked(BATCH, *ASSOC_PER_FRAME[name]))
        if n == 0 or len(ids - {None}) < 3:
            fail(f"[tracker] {name}: {n} detections, ids {sorted(ids, key=str)}")
        replay = replay_vs_eager(gpu, batches[:3], f"[tracker] {name}",
                                 ASSOC_PER_FRAME[name])
        eng = PipelineEngine(cfg, device="cuda")
        eng.process_batch(*batches[3], want_proc=False)       # warm-up
        fed = iter(range(4 * BATCH, 10 ** 9, BATCH))

        def window() -> int:
            for _ in range(DET_ITERS):
                k = next(fed)
                eng.process_batch(batches[3 + (k // BATCH) % 3][0],
                                  1000.0 + (k + np.arange(BATCH)) / 30.0,
                                  want_proc=False)
            return DET_ITERS * BATCH

        with PathLaunches(f"[tracker] {name} timed") as pl:
            fps = windows_fps(window, DET_WINDOWS, torch.device("cuda"))
            k = next(fed)
            tsort.reset_host_syncs()
            eng.process_batch(batches[4][0],
                              1000.0 + (k + np.arange(BATCH)) / 30.0,
                              want_proc=False)
            syncs = tsort.host_syncs
            counts = pl.check(DET_ITERS * DET_WINDOWS + 1,
                              tracked(BATCH, *ASSOC_PER_FRAME[name]))
        sort_ms = [stage_ms(eng, *batches[5])["sort_geometry"]
                   for _ in range(DET_WINDOWS)]
        row = {"fps": fps, "sort_geometry_ms": {
            "median": float(np.median(sort_ms)), "min": min(sort_ms),
            "max": max(sort_ms)}, "host_syncs_per_batch": syncs,
            "detections": n, "ids": len(ids - {None}), "worst": worst,
            "launches": counts, "replay_vs_eager": replay}
        out[name] = row
        print(f"[tracker] {name}: {n} detections of 3 float32 batches match "
              f"the CPU path ({len(ids - {None})} ids; worst "
              + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})
              + f"); 3 replayed batches bit-equal to 3 eager ones from "
              f"a reset state ({replay['detections']} detections, the "
              f"state after too; host syncs replayed "
              f"{replay['host_syncs']['graph']}, eager "
              f"{replay['host_syncs']['eager']}); bfloat16 frames/s "
              f"median {fps['median']:.1f} (min "
              f"{fps['min']:.1f}, max {fps['max']:.1f}), SORT + geometry "
              f"{row['sort_geometry_ms']['median']:.2f} ms [min "
              f"{min(sort_ms):.2f}, max {max(sort_ms):.2f}], {syncs} host "
              f"syncs in one batch; launches {counts} ({card}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def pan_batches(batches, n: int, seed: int = 3):
    """``n`` batches of a pan: each frame's top 1024 rows rolled by a
    cumulative known shift of whole thumbnail blocks (15 x 8 px at 1080p,
    so the gray thumbnail rolls exactly), the last 56 rows repeating the
    first. A fixed grain of ±16 levels on the scene gives the correlation
    texture (the sky is flat and the lane dashes repeat along y).
    Returns [(frames, ts, shifts (B, 2) source px)]."""
    from roadvision_tpu_torch.track.gmc import GMC_SIZE
    sx, sy = WIDTH // GMC_SIZE, HEIGHT // GMC_SIZE
    rows = sy * GMC_SIZE
    rng = np.random.RandomState(seed)
    grain = rng.randint(-16, 17, (rows, WIDTH, 1))
    cam = np.zeros(2, int)
    out = []
    for b in range(n):
        frames, shifts = [], []
        for i in range(BATCH):
            d = rng.randint(-3, 4, 2) if (b, i) != (0, 0) else np.zeros(2, int)
            cam += d
            scene = np.clip(batches[b][0][i][:rows] + grain, 0, 255)
            top = np.roll(scene.astype(np.uint8),
                          (cam[1] * sy, cam[0] * sx), axis=(0, 1))
            frames.append(np.concatenate([top, top[:HEIGHT - rows]]))
            shifts.append(d * (sx, sy))
        out.append((np.stack(frames), batches[b][1],
                    np.array(shifts, np.float32)))
    return out


def gmc_phase(model: str, batches, card: str, front) -> dict:
    """``[gmc]``: a panned source through strongsort (GMC on) in float32,
    replayed from a CUDA graph on the card (GMC's carry in the graph's
    state): each batch's shifts against the engine's carried thumbnail
    equal the CPU's and the known pan; ids equal; launches 1 / 1 / 1 per
    batch; then the pan replayed against eager from a reset state,
    bit-equal."""
    import torch
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.track.gmc import batch_shifts, gray_thumbnail
    cfg = merge(pipeline_cfg(model), {
        "tracking": {"backend": "strongsort"},
        "tpu": {"compute_dtype": "float32"}})
    gpu = PipelineEngine(cfg, device="cuda")
    if gpu.step_mode != "graph":
        fail(f"[gmc]: runs {gpu.step_mode} ({gpu.eager_reason})")
    cpu = front.attach(PipelineEngine(cfg, device="cpu"))
    worst = {"box": 0.0, "distance_m": 0.0, "speed_kmh": 0.0}
    n = 0
    pan = pan_batches(batches, 3)
    with PathLaunches("[gmc]") as pl:
        for frames, ts, known in pan:
            got = []
            for eng in (gpu, cpu):
                g = gray_thumbnail(torch.from_numpy(frames).to(eng.device))
                got.append(batch_shifts(
                    eng.gmc_prev, g, eng.gmc_valid,
                    (WIDTH // 128, HEIGHT // 128)).cpu().numpy())
            if not (np.array_equal(got[0], got[1])
                    and np.array_equal(got[0], known)):
                fail(f"[gmc]: shifts card {got[0].tolist()}, CPU "
                     f"{got[1].tolist()}, known {known.tolist()}")
            n += compare_tracks(cpu.process_batch(frames, ts),
                                gpu.process_batch(frames, ts), worst, "[gmc]")
        counts = pl.check(3 + warm(1),
                          tracked(BATCH, *ASSOC_PER_FRAME["strongsort"]))
    replay = replay_vs_eager(gpu, [(f, t) for f, t, _ in pan], "[gmc]",
                             ASSOC_PER_FRAME["strongsort"])
    print(f"[gmc] a pan of 24 frames through strongsort, replayed: the "
          f"card's shifts equal the CPU's and the known ones (up to "
          f"{int(np.abs(known).max())} px a frame); {n} detections match "
          f"(worst {json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}"
          f"); launches {counts}; the pan replayed equals it eager from a "
          f"reset state, bit for bit ({replay['detections']} detections, "
          f"the carry after too; host syncs replayed "
          f"{replay['host_syncs']['graph']})", flush=True)
    return {"detections": n, "worst": worst, "launches": counts,
            "replay_vs_eager": replay}


class ListSource:
    """Batches from a list, for ``PipelineEngine.stream``."""

    def __init__(self, batches):
        self.batches = list(batches)

    def read_batch(self, n):
        if not self.batches:
            return None, None, 0
        frames, ts = self.batches.pop(0)[:2]
        return frames, ts, len(frames)

    def release(self):
        pass


def gate_phase(model: str, batches, card: str, front) -> dict:
    """``[gate]``: ``detect.temporal_gate`` on a static and a moving scene
    through ``PipelineEngine.stream`` in float32, card against CPU: the
    same coasted frames (> 0 static, 0 moving) and detections, ids on the
    coasted frames included; launches 1 / 1 / 1 per batch (the chain runs
    on coasted batches too); then ``tools/bench.py --mode gate``
    in-process at a small iteration count."""
    import contextlib
    import io

    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.tools import bench
    cfg = merge(pipeline_cfg(model), {
        "detect": {"temporal_gate": {"enable": True}},
        "tpu": {"compute_dtype": "float32"}})
    still = np.repeat(batches[0][0][:1], BATCH, axis=0)
    scenes = {"static": [(still, batches[k][1]) for k in range(5)],
              "moving": [b[:2] for b in batches[:4]]}
    out = {}
    for scene, clip in scenes.items():
        gpu = PipelineEngine(cfg, device="cuda")
        cpu = front.attach(PipelineEngine(cfg, device="cpu"))
        worst = {"box": 0.0, "distance_m": 0.0, "speed_kmh": 0.0}
        with PathLaunches(f"[gate] {scene}") as pl:
            r_gpu = list(gpu.stream(ListSource(clip), want_proc=False))
            # a coasted batch runs no detector (no NMS) but tracks its
            # frames on the reused detections
            coast = gpu.gate_frames_coasted // BATCH
            counts = pl.check(len(clip), tail_want(len(clip) - coast,
                                                   len(clip) * BATCH))
        r_cpu = list(cpu.stream(ListSource(clip), want_proc=False))
        n = compare_tracks(r_cpu, r_gpu, worst, f"[gate] {scene}")
        coasted = (gpu.gate_frames_coasted, cpu.gate_frames_coasted)
        if coasted[0] != coasted[1] or (coasted[0] > 0) != (
                scene == "static") or n == 0:
            fail(f"[gate] {scene}: coasted frames card {coasted[0]}, CPU "
                 f"{coasted[1]}; {n} detections")
        print(f"[gate] {scene} scene, {len(clip)} batches through stream: "
              f"{coasted[0]} frames coasted on the card and on the CPU; "
              f"{n} detections match, ids included; launches {counts}",
              flush=True)
        out[scene] = {"coasted": coasted[0], "detections": n,
                      "launches": counts}
    buf = io.StringIO()
    with PathLaunches("[gate] bench") as pl, contextlib.redirect_stdout(buf):
        rc = bench.main(["--mode", "gate", "--iters", "2", "--windows", "2",
                         "--warmup", "1", "--model", model])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        # every step tracks its frames; a coasted one runs no detector
        counts = pl.check(1, lambda n: tail_want(
            n - line["coasted_batches"], n * BATCH), at_least=True)
    if rc != 0 or line["card"] != card or not line["static"][
            "coasted_share"] > 0 or line["moving"]["coasted_share"] != 0:
        fail(f"[gate] bench: rc {rc}, line {line}")
    out["bench"] = line
    print("[gate] bench " + json.dumps({
        k: line[k] for k in ("static", "moving", "staleness")}), flush=True)
    return out


def entry_track_gt(model: str, tmp: Path) -> dict:
    """``[entry] track --gt``: ``tools/track.py`` over 16 frames of the
    synthetic road at 1080p with its ground truth, in float32 on the card
    and on the CPU: MOTA, IDF1 and HOTA equal to 1e-6, launches 1 / 1 / 1
    per batch on the card."""
    import contextlib
    import io

    import yaml
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    from roadvision_tpu_torch.tools import track
    from roadvision_tpu_torch.track.eval import evaluate_all
    n = 2 * BATCH
    src = SyntheticRoadSource(WIDTH, HEIGHT, num_vehicles=6)
    gt = tmp / "gt.txt"
    gt.write_text("".join(
        f"{f + 1},{v + 1},{x1:.2f},{y1:.2f},{x2 - x1:.2f},{y2 - y1:.2f},1,"
        f"-1,-1,-1\n" for f in range(n)
        for x1, y1, x2, y2, v in src.gt_boxes(f)))
    cfg_path = tmp / "track.yaml"       # float32 on both devices
    cfg = pipeline_cfg(model)
    cfg["tpu"]["compute_dtype"] = "float32"
    cfg_path.write_text(yaml.safe_dump(cfg))
    scores, lines = {}, {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        out = tmp / f"mot_{dev}.txt"
        with PathLaunches("[entry] track --gt") as pl, \
                contextlib.redirect_stdout(buf):
            rc = track.main(["--source", "synthetic:6", "--frames", str(n),
                             "--out", str(out), "--config", str(cfg_path),
                             "--width", str(WIDTH), "--height", str(HEIGHT),
                             "--gt", str(gt), "--device", dev])
            if dev == "cuda":
                counts = pl.check(2 + warm(1), tracked())
        lines[dev] = json.loads(buf.getvalue().strip().splitlines()[-1])
        scores[dev] = evaluate_all(track.read_mot(gt, n),
                                   track.read_mot(out, n))
        if rc != 0:
            fail(f"[entry] track --gt on {dev}: rc {rc}")
    gap = max(abs(scores["cuda"][k] - scores["cpu"][k])
              for k in ("mota", "idf1", "hota"))
    if gap > 1e-6 or lines["cuda"] != lines["cpu"] \
            or scores["cuda"]["matches"] == 0:
        fail(f"[entry] track --gt: card {scores['cuda']}, CPU "
             f"{scores['cpu']}")
    print(f"[entry] track --gt: {n} frames at {WIDTH}x{HEIGHT}, card "
          + json.dumps(lines["cuda"]) + f" equal to the CPU's (max gap "
          f"{gap:.1e}); launches {counts}", flush=True)
    return {"scores": lines["cuda"], "launches": counts}


# [detector]: per path, what the card's float32 batch is held to against
# the CPU path beside the boxes and confidences (BOX_TOL, CONF_TOL):
# masks at prototype resolution, keypoints (x, y px; visibility),
# rotated boxes (cx, cy, w, h px; θ rad)
MASK_TOL = 1e-3                # soft mask values inside both crops
MASK_EDGE_SHARE = 1e-3         # pixels inside one crop only (box-edge ulps)
KPT_TOL, VIS_TOL = 0.05, 2e-3
RBOX_TOL, ANGLE_TOL = 0.05, 1e-4
# timed bf16 (int8) runs per path, as tools/bench.py times the main
# path: DET_WINDOWS windows of DET_ITERS batches (frames/s median, min,
# max), and the stage ms of DET_WINDOWS single batches (median, min, max)
DET_ITERS, DET_WINDOWS = 2, 2


def _trained_task_tree(task: str, nc: int, tmp: Path) -> str:
    """A v8n ``task`` tree, seeded, with the trained yolov8n's weights
    wherever the two share a parameter: the shapes of a random head
    (scores within 1e-4 of the prior everywhere) would leave the
    card-vs-CPU comparison to the order of equal scores. The single
    pose class takes the trained car row, the 15 obb classes the first
    15 rows. Written as the repo's .npz; returns its path."""
    from roadvision_tpu_torch.models.yolo import weights as W
    assets = Path(__file__).resolve().parent / "assets"
    trained = W.flatten_tree(W.import_npz(assets
                                          / "yolov8n_synthetic_256.npz"))
    tree = W.flatten_tree(W.tree_from_model(W.random_model("v8", task, "n",
                                                           nc, seed=0)))
    rows = {1: [2], 15: list(range(15)), 80: list(range(80))}[nc]
    for k, v in tree.items():
        if k not in trained:
            continue                       # cv4 / proto: seeded random
        t = trained[k]
        if t.shape != v.shape:
            # the class branch, 64 wide below 80 classes: its first
            # channels, and the chosen class rows in the last conv
            final = ".cv3." in k and k.rsplit(".", 2)[1] == "2"
            t = t[tuple(rows if final and d == t.ndim - 1 else slice(0, n)
                        for d, n in enumerate(v.shape))]
        tree[k] = t
    path = tmp / f"yolov8n-{task}.npz"
    W.export_npz(W.unflatten_tree(tree), path)
    return str(path)


def _spread_yolo11_tree(frames: np.ndarray, tmp: Path) -> str:
    """A seeded YOLO11n (nc 80) whose last box and class convs are
    rescaled about their mean so that the logits spread (σ 1 and 3):
    unscaled, every anchor's scores sit within 1e-4 of the prior.
    Measured on the first frame through the CPU model."""
    import torch
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.ops.letterbox import letterbox_rect_u8
    model = W.random_model("11", "detect", "n", 80, seed=0).eval()
    head = model.layers["23"]
    finals = [(head.cv2[lvl][2], 1.0) for lvl in range(3)] \
        + [(head.cv3[lvl][2], 3.0) for lvl in range(3)]
    seen = {}
    hooks = [conv.register_forward_hook(
        lambda m, i, o: seen.__setitem__(m, o - m.bias[:, None, None]))
        for conv, _ in finals]
    imgs = letterbox_rect_u8(torch.from_numpy(frames[:1]), 640)[0]
    with torch.no_grad():
        model(imgs)
        for conv, sigma in finals:
            raw = seen[conv]
            scale = sigma / float(raw.std())
            conv.weight.mul_(scale)
            conv.bias.sub_(scale * raw.mean(dim=(0, 2, 3)))
    for h in hooks:
        h.remove()
    path = tmp / "yolo11n-spread.npz"
    W.export_npz(W.tree_from_model(model), path)
    return str(path)


def detector_paths(frames: np.ndarray, tmp: Path) -> dict:
    """(name → (detect overrides, frames the CPU side takes)) for (a)-(h),
    (j) and (k)."""
    assets = Path(__file__).resolve().parent / "assets"
    v8 = str(assets / "yolov8n_synthetic_256.npz")
    rtdetr = str(assets / "rtdetr_l_synthetic_256.npz")
    return {
        "a yolov5n": ({"model": str(assets / "yolov5n_synthetic_256.npz"),
                       "conf_thres": 0.5}, BATCH),
        "b yolo11n": ({"model": _spread_yolo11_tree(frames, tmp)}, BATCH),
        "c v8n-seg": ({"model": _trained_task_tree("segment", 80, tmp)},
                      BATCH),
        # the 64-wide class branch keeps 64 of the trained 80 channels:
        # its best car scores reach ~0.16, so these two threshold at 0.01
        "d v8n-pose": ({"model": _trained_task_tree("pose", 1, tmp),
                        "conf_thres": 0.01}, BATCH),
        "e v8n-obb": ({"model": _trained_task_tree("obb", 15, tmp),
                       "conf_thres": 0.01}, BATCH),
        "f int8": ({"model": v8, "compute_dtype": "int8",
                    "int8_calibration": BATCH}, BATCH),
        "g tta": ({"model": v8, "tta": True}, 2),
        "h tiling": ({"model": v8, "tiling": {
            "enable": True, "tile": 640, "overlap": 0.25,
            "full_frame": True}}, 2),
        # RT-DETR-L (trained at 256) at the main path's 640 stretch; it
        # finds 21-22 cars a frame there, so 640 needs no fallback to 256
        "j rtdetr": ({"model": rtdetr, "imgsz": 640}, 2),
        # int8: the CPU calibrates on the same 8 frames as the card
        "k rtdetr int8": ({"model": rtdetr, "imgsz": 640,
                           "compute_dtype": "int8",
                           "int8_calibration": BATCH}, BATCH),
    }


def compare_task_results(cpu, gpu, name: str) -> dict:
    """The card's detections against the CPU path's: count, class and
    track id equal; boxes and confidences within BOX_TOL / CONF_TOL (int8
    too: both devices quantise the same activations to the same steps);
    the task's side output within its own. Returns the largest errors."""
    box_tol, conf_tol = BOX_TOL, CONF_TOL
    worst = {"box": 0.0, "conf": 0.0}
    for fi, (a, b) in enumerate(zip(cpu, gpu)):
        if not np.array_equal(a.proc, b.proc):
            fail(f"[detector] {name}: frame {fi}: processed frame differs")
        if len(a.detections) != len(b.detections):
            fail(f"[detector] {name}: frame {fi}: {len(a.detections)} CPU "
                 f"detections vs {len(b.detections)} on the card")
        for da, db in zip(a.detections, b.detections):
            if (da.cls_id, da.track_id) != (db.cls_id, db.track_id):
                fail(f"[detector] {name}: frame {fi}: class/track id "
                     f"({da.cls_id},{da.track_id}) vs "
                     f"({db.cls_id},{db.track_id})")
            box = max(abs(p - q) for p, q in zip(
                (da.x1, da.y1, da.x2, da.y2), (db.x1, db.y1, db.x2, db.y2)))
            conf = abs(da.conf - db.conf)
            worst["box"], worst["conf"] = max(worst["box"], box), \
                max(worst["conf"], conf)
            if box > box_tol or conf > conf_tol:
                fail(f"[detector] {name}: frame {fi}: box err {box} / conf "
                     f"err {conf} over {box_tol} / {conf_tol}")
            if da.mask is not None:
                ma, mb = np.asarray(da.mask), np.asarray(db.mask)
                both = (ma > 0) & (mb > 0)
                edge = float(((ma > 0) != (mb > 0)).mean())
                err = float(np.abs(ma - mb)[both].max()) if both.any() \
                    else 0.0
                worst["mask"] = max(worst.get("mask", 0.0), err)
                worst["mask_edge_share"] = max(
                    worst.get("mask_edge_share", 0.0), edge)
                if err > MASK_TOL or edge > MASK_EDGE_SHARE:
                    fail(f"[detector] {name}: mask err {err} / edge share "
                         f"{edge}")
            if da.keypoints is not None:
                ka, kb = np.asarray(da.keypoints), np.asarray(db.keypoints)
                xy = float(np.abs(ka[:, :2] - kb[:, :2]).max())
                vis = float(np.abs(ka[:, 2] - kb[:, 2]).max())
                worst["kpt"] = max(worst.get("kpt", 0.0), xy)
                worst["vis"] = max(worst.get("vis", 0.0), vis)
                if xy > KPT_TOL or vis > VIS_TOL:
                    fail(f"[detector] {name}: keypoint err {xy} / vis {vis}")
            if da.rbox is not None:
                ra, rb = np.asarray(da.rbox), np.asarray(db.rbox)
                geo = float(np.abs(ra[:4] - rb[:4]).max())
                ang = float(abs(ra[4] - rb[4]))
                worst["rbox"] = max(worst.get("rbox", 0.0), geo)
                worst["angle"] = max(worst.get("angle", 0.0), ang)
                if geo > RBOX_TOL or ang > ANGLE_TOL:
                    fail(f"[detector] {name}: rbox err {geo} / angle {ang}")
    return worst


def detector_phase(batches, card: str, tmp: Path) -> dict:
    """(a)-(h) through ``process_batch`` at 1080p x 8 with the default
    chain: one float32 (int8) batch on the card against the CPU path,
    then timed bfloat16 (int8) batches; launches 1 / 1 / 1 per batch on
    each path. (i): the yolov8n asset exported to ONNX and to a .pt
    state dict gives detections equal to the .npz run."""
    import torch
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.tools.bench import stage_ms, windows_fps
    frames, ts = batches[0]
    print(f"[detector] card vs CPU tolerances: boxes {BOX_TOL} px, conf "
          f"{CONF_TOL}; masks {MASK_TOL} inside both crops, at most "
          f"{MASK_EDGE_SHARE:.1%} of pixels inside one crop only; "
          f"keypoints {KPT_TOL} px, visibility {VIS_TOL}; rboxes {RBOX_TOL} "
          f"px, angle {ANGLE_TOL} rad; int8 as float32", flush=True)
    out = {}
    for name, (over, n_cpu) in detector_paths(frames, tmp).items():
        t0 = time.perf_counter()
        int8 = over.get("compute_dtype") == "int8"
        cfg = merge(pipeline_cfg(over["model"]), {"detect": over})
        cfg32 = merge(cfg, {"tpu": {"compute_dtype": "int8" if int8
                                    else "float32"}})
        gpu = PipelineEngine(cfg32, device="cuda")
        cpu = PipelineEngine(cfg32, device="cpu")
        nms = not getattr(gpu.detector, "nms_free", False)
        # RT-DETR: K7 once a decoder layer a forward, and int8's
        # calibration forward on the first batch
        deform = 0 if nms else RTDETR_LAYERS
        calib = deform if int8 and over.get("int8_calibration") else 0
        with PathLaunches(f"[detector] {name}") as pl:
            r_gpu = gpu.process_batch(frames, ts)
            pl.check(1 + warm(gpu.step_mode == "graph"), lambda n: {
                **tracked(nms=nms, deform=deform)(n),
                "deform_sample": n * deform + calib})
        r_cpu = cpu.process_batch(frames[:n_cpu], ts[:n_cpu])
        worst = compare_task_results(r_cpu, r_gpu[:n_cpu], name)
        n_dets = sum(len(r.detections) for r in r_cpu)
        if n_dets == 0:
            fail(f"[detector] {name}: no detections to compare")
        task = gpu.detector.task
        if getattr(gpu.detector, "nms_free", False):
            worst["topk_gap_min"] = same_proposals(gpu, cpu, r_cpu, name)
        # timed: bf16 (int8 stays int8, its scales already calibrated)
        timed_eng = gpu if int8 else PipelineEngine(cfg, device="cuda")
        timed_eng.process_batch(*batches[1], want_proc=False)  # warm-up
        fed = iter(range(2 * BATCH, 10 ** 9, BATCH))   # next frame index

        def window() -> int:
            for _ in range(DET_ITERS):
                k = next(fed)
                timed_eng.process_batch(
                    batches[2 + (k // BATCH - 2) % (len(batches) - 2)][0],
                    1000.0 + (k + np.arange(BATCH)) / 30.0, want_proc=False)
            return DET_ITERS * BATCH

        with PathLaunches(f"[detector] {name} timed") as pl:
            fps = windows_fps(window, DET_WINDOWS, torch.device("cuda"))
            counts = pl.check(DET_ITERS * DET_WINDOWS,
                              tracked(nms=nms, deform=deform))
        runs = [stage_ms(timed_eng, *batches[1]) for _ in range(DET_WINDOWS)]
        stages = {k: {"median": float(np.median([r[k] for r in runs])),
                      "min": min(r[k] for r in runs),
                      "max": max(r[k] for r in runs)} for k in runs[0]}
        dtype = "int8" if int8 else "bfloat16"
        print(f"[detector] {name} ({gpu.detector.arch}/{task}, "
              f"{'int8' if int8 else 'float32'} vs CPU on {n_cpu} frames): "
              f"{n_dets} detections match, worst "
              + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})
              + f"; {dtype} frames/s median {fps['median']:.1f} (min "
              f"{fps['min']:.1f}, max {fps['max']:.1f}) over {DET_WINDOWS} "
              f"windows of {DET_ITERS} batches, stage ms median [min, max] "
              + json.dumps({k: [round(v["median"], 3), round(v["min"], 3),
                                round(v["max"], 3)]
                            for k, v in stages.items()})
              + f"; launches {counts} ({card}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out[name] = {"task": task, "arch": gpu.detector.arch,
                     "detections": n_dets, "cpu_frames": n_cpu,
                     "worst": worst, "fps": fps, "dtype": dtype,
                     "stage_ms": stages, "launches": counts}
        if getattr(gpu.detector, "nms_free", False):
            out[name]["forward_stage_ms"] = rtdetr_stage_ms(
                timed_eng, batches[1][0], name, card)
    out["i export"] = export_phase(batches, tmp, card)
    return out


def same_proposals(gpu, cpu, r_cpu, name: str) -> float:
    """RT-DETR: the encoder's top-nq anchors of the card's and the CPU's
    float pass on the CPU's frames (their processed frames, bit-equal)
    are the same set on every frame. On a difference, print the gap of
    the CPU's scores at rank nq and fail. Returns the smallest gap."""
    import torch
    proc = np.stack([r.proc for r in r_cpu])
    sets, gaps = [], []
    for eng in (cpu, gpu):
        det = eng.detector
        with torch.inference_mode():
            imgs = det.letterbox(torch.from_numpy(proc).to(eng.device))[0]
            _, _, top_val, topk, _, _ = det.model.dec.proposals(
                det.model.features(imgs), det.num_queries)
        sets.append([set(row) for row in topk.cpu().tolist()])
        if eng is cpu:
            s = torch.sort(top_val.float(), dim=1, descending=True).values
            nq = topk.shape[1]
            gaps = (s[:, nq - 1] - s[:, nq]).tolist() \
                if s.shape[1] > nq else [float("inf")] * len(s)
    for fi, (a, b) in enumerate(zip(*sets)):
        if a != b:
            fail(f"[detector] {name}: frame {fi}: the card's encoder top-"
                 f"{len(a)} differs from the CPU's in {len(a ^ b) // 2} "
                 f"anchors; the CPU's score gap at rank {len(a)} is "
                 f"{gaps[fi]:.3e}")
    return float(min(gaps))


def rtdetr_stage_ms(engine, frames: np.ndarray, name: str,
                    card: str) -> dict:
    """RT-DETR's forward by stage on one letterboxed batch (backbone,
    encoder, deformable decoder; host clock, synchronised), median
    [min, max] of 5 runs."""
    import torch
    det = engine.detector
    m = det.model
    x = torch.from_numpy(frames).to(engine.device)
    imgs = det.letterbox(engine.pipeline.apply_batch(x))[0]

    @torch.inference_mode()
    def one() -> dict:
        out = {}

        def timed(stage, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            out[stage] = (time.perf_counter() - t0) * 1e3
            return r

        taps = timed("backbone", lambda: m.backbone(
            imgs.permute(0, 3, 1, 2).to(m.compute_dtype)))
        feats = timed("encoder", lambda: m.enc(*taps))
        timed("decoder", lambda: m.dec(feats, det.num_queries,
                                       det.decoder_layers))
        return out

    one()                                                    # warm-up
    runs = [one() for _ in range(5)]
    out = {k: {"median": float(np.median([r[k] for r in runs])),
               "min": min(r[k] for r in runs),
               "max": max(r[k] for r in runs)} for k in runs[0]}
    print(f"[detector] {name} forward stage ms (batch {len(frames)}, "
          f"{det.imgsz}x{det.imgsz}, {det.num_queries} queries, "
          f"{'int8' if det.int8 else str(det.dtype).split('.')[-1]}) "
          f"median [min, max]: " + json.dumps(
              {k: [round(v["median"], 3), round(v["min"], 3),
                   round(v["max"], 3)] for k, v in out.items()})
          + f" ({card})", flush=True)
    return out


def export_phase(batches, tmp: Path, card: str) -> dict:
    """The yolov8n asset as ONNX (``detect.backend: onnx``) and as a .pt
    state dict: float32 detections ``==`` to the .npz run's."""
    import torch
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.models.yolo import onnx_io
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.runtime import PipelineEngine
    npz = str(Path(__file__).resolve().parent / "assets"
              / "yolov8n_synthetic_256.npz")
    tree = W.import_npz(npz)
    onnx = tmp / "yolov8n.onnx"
    onnx_io.export_onnx(tree, onnx)
    pt = tmp / "yolov8n.pt"
    torch.save({k: torch.from_numpy(v) for k, v in
                onnx_io.params_to_state_dict(tree).items()}, pt)
    runs = {}
    for name, over in (("npz", {"model": npz}),
                       ("onnx", {"model": str(onnx), "backend": "onnx"}),
                       ("pt", {"model": str(pt)})):
        cfg = merge(pipeline_cfg(npz), {"detect": over,
                                        "tpu": {"compute_dtype": "float32"}})
        eng = PipelineEngine(cfg, device="cuda")
        if not eng.detector.loaded:
            fail(f"[detector] i export: {name} did not load")
        with PathLaunches(f"[detector] i {name}") as pl:
            runs[name] = [eng.process_batch(f, t, want_proc=False)
                          for f, t in batches[:2]]
            pl.check(2 + warm(eng.step_mode == "graph"), tracked())
    n = 0
    for name in ("onnx", "pt"):
        for a, b in zip(runs["npz"], runs[name]):
            n = same_detections(a, b, f"[detector] i {name}")
    if n == 0:
        fail("[detector] i export: no detections to compare")
    print(f"[detector] i export: the yolov8n asset as ONNX (backend onnx) "
          f"and as a .pt state dict gives detections == to the .npz run "
          f"over 2 batches ({n} in the last); launches 2 / 2 / 2 each "
          f"({card})", flush=True)
    return {"detections_last_batch": n}


def gated_counts(what: str, batches: int, nms: bool = True,
                 deform: int = 0) -> dict:
    """The kernels' launch counts after ``batches`` steps of a gated path
    with the impulse statistic (a capture's warm-up calls included): K1
    and K2 once per step, K3 twice (the statistic's median on the gray
    subsample, then the chain); NMS once a step (``nms``: not for
    RT-DETR), ``deform`` K7 launches a step (RT-DETR) and SORT's
    association once a frame."""
    from roadvision_tpu_torch import kernels
    counts = dict(kernels.launch_counts)
    want = {"clahe_tile_luts": batches, "clahe_apply": batches,
            "median_k": 2 * batches,
            **tail_want(batches * nms, batches * BATCH,
                        deform=batches * deform)}
    if counts != want or batches < 1:
        launch_mismatch(f"{what}: launches {counts}, expected {want}")
    return add_to_totals(counts)


def weather_phase(card: str) -> dict:
    """``[weather]``: the fogged synthetic road (heavy, 1080p, 6 vehicles,
    synthesized on the card) through ``stream`` with weather_demo.yaml's
    gate and detector, held to the CPU path on the same frames: gate
    decisions equal, processed frames bit-equal, detections within
    BOX_TOL / CONF_TOL; then a batch of 4 clean and 4 fogged frames, where
    the gate must split. One 1080p frame is also synthesized on the CPU
    and held to the card's within the fog tests' bound (≤ 2 levels in
    ≤ 0.1 % of the pixels)."""
    import torch
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.augment.fog import (CLI_OVERRIDES,
                                                  EnhancedFogSynthesizer)
    from roadvision_tpu_torch.config import load_config, merge
    from roadvision_tpu_torch.io_video import SyntheticRoadSource, VideoSource
    from roadvision_tpu_torch.runtime import PipelineEngine
    root = Path(__file__).resolve().parent
    cfg = merge(load_config(str(root / "configs" / "weather_demo.yaml")), {
        "camera": {"width": WIDTH, "height": HEIGHT},
        "detect": {"model": str(root / "assets"
                                / "yolov8n_synthetic_256.npz")},
        "tpu": {"compute_dtype": "float32"}})
    gpu = PipelineEngine(cfg, device="cuda")
    cam = cfg["camera"]
    vs = VideoSource(cam["source"], WIDTH, HEIGHT, num_frames=2 * BATCH,
                     device="cuda")
    t0 = time.perf_counter()
    src = vs._src
    fog_frames = [src.render(i) for i in range(2)]
    torch.cuda.synchronize()
    synth_ms = (time.perf_counter() - t0) * 1e3 / 2
    kernels.reset_launch_counts()
    got = list(gpu.stream(vs, max_frames=2 * BATCH))
    # the gated step is captured at the first batch
    counts = gated_counts("[weather] stream", 2 + warm(1))
    if len(got) != 2 * BATCH:
        fail(f"[weather]: stream gave {len(got)} frames")
    if not all(np.array_equal(got[i].raw, fog_frames[i]) for i in range(2)):
        fail("[weather]: the stream's frames differ from the source's")
    cpu = PipelineEngine(cfg, device="cpu")
    want = []
    for k in range(2):
        rows = got[k * BATCH:(k + 1) * BATCH]
        want += cpu.process_batch(np.stack([r.raw for r in rows]),
                                  np.array([r.ts for r in rows]))
    worst = compare_results(want, got)
    ran = [not np.array_equal(r.proc, r.raw) for r in got]
    if not all(ran):
        fail(f"[weather]: the gate skipped fogged frames: {ran}")
    n_dets = sum(len(r.detections) for r in want)
    # clean and fogged frames in one batch: the gate must split them
    clean = SyntheticRoadSource(WIDTH, HEIGHT, num_vehicles=6, seed=0)
    mixed = np.stack([clean.render(i) for i in range(4)]
                     + [got[i].raw for i in range(4)])
    ts = 2000.0 + np.arange(BATCH) / 30.0
    kernels.reset_launch_counts()
    r_gpu = gpu.process_batch(mixed, ts)
    gated_counts("[weather] mixed batch", 1)
    r_cpu = cpu.process_batch(mixed, ts)
    compare_results(r_cpu, r_gpu)
    split = [not np.array_equal(r.proc, r.raw) for r in r_gpu]
    if split != [False] * 4 + [True] * 4:
        fail(f"[weather]: the gate ran the chain on {split}")
    # the synthesizer itself, card against CPU, on one 1080p frame
    base = SyntheticRoadSource(WIDTH, HEIGHT, num_vehicles=6, seed=0).render(0)
    t_cpu = time.perf_counter()
    outs = [EnhancedFogSynthesizer(level="heavy", seed=0, device=d,
                                   **CLI_OVERRIDES).synthesize(base)[0]
            for d in ("cpu", "cuda")]
    t_cpu = time.perf_counter() - t_cpu
    diff = np.abs(outs[0].astype(np.int32) - outs[1].astype(np.int32))
    share = float((diff > 0).mean())
    if diff.max() > 2 or share > 1e-3 or not np.array_equal(outs[1],
                                                             fog_frames[0]):
        fail(f"[weather]: card fog vs CPU: max {diff.max()} levels, "
             f"{share:.2e} of the pixels")
    print(f"[weather] heavy fog at {WIDTH}x{HEIGHT}: {synth_ms:.1f} ms a "
          f"frame to synthesize on the card (host clock); 2 batches through "
          f"stream match the CPU path ({n_dets} detections, max box err "
          f"{worst:.2e} px, processed frames bit-equal, the chain ran on "
          f"every fogged frame); a 4 clean + 4 fogged batch splits as built; "
          f"card fog vs CPU fog: max {diff.max()} levels in {share:.2e} of "
          f"the pixels (CPU + card synthesis {t_cpu:.1f} s); launches "
          f"{counts} in 2 batches ({card})", flush=True)
    return {"fog_synth_ms_per_frame": synth_ms, "detections": n_dets,
            "launches_2_batches": counts, "fog_max_levels": int(diff.max()),
            "fog_diff_share": share}


def entry_demo(name: str, tmp: Path) -> dict:
    """``[entry] <name>``: the port's preview ``main`` on a shipped config
    with ``--max-frames 16 --no-show --record``; the AVI is checked, the
    launches are those of a gated path (impulse statistic on)."""
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.config import load_config
    from roadvision_tpu_torch.tools import preview
    cfg_path = Path(__file__).resolve().parent / "configs" / f"{name}.yaml"
    cam = load_config(str(cfg_path))["camera"]
    avi = tmp / f"{name}.avi"
    n = 16
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = preview.main(["--config", str(cfg_path), "--max-frames", str(n),
                       "--no-show", "--record", str(avi)])
    elapsed = time.perf_counter() - t0
    rtdetr = "rtdetr" in Path(load_config(str(cfg_path))["detect"]
                              ["model"]).name
    # one graph captured (its warm-up calls count); RT-DETR: no NMS, K7
    # once a decoder layer
    counts = gated_counts(f"[entry] {name}", n // BATCH + warm(1),
                          not rtdetr, RTDETR_LAYERS * rtdetr)
    if rc != 0:
        fail(f"[entry] {name}: main returned {rc}")
    check_avi(avi, n, (2 * cam["width"] + 4, cam["height"]))
    print(f"[entry] {name}: {n} frames of {cam['source']} at "
          f"{cam['width']}x{cam['height']} recorded to a valid MJPEG AVI and "
          f"read back; {n / elapsed:.1f} frames/s with overlay, canvas and "
          f"JPEG encode; launches {counts}", flush=True)
    return {"launches": counts, "batches": n // BATCH,
            "fps_with_record": n / elapsed}


# ----------------------------------------------------------------------
# the camera fleet and traffic analytics

FLEET_WINDOWS, FLEET_ITERS = 3, 2      # timed windows of fleet batches


def multi_cfg(model: str, dtype: str = "bfloat16", **over):
    """configs/multi_stream.yaml as shipped (4 synthetic sources at 720p,
    batch 8, CLAHE + median, the fleet on all visible cards), with the
    repo's checkpoint in place of its yolov8n.pt, which the repo does not
    hold (random weights detect nothing to compare)."""
    from roadvision_tpu_torch.config import load_config, merge
    root = Path(__file__).resolve().parent
    cfg = load_config(str(root / "configs" / "multi_stream.yaml"))
    return merge(cfg, {"detect": {"model": model},
                       "tpu": {"compute_dtype": dtype}, **over})


def fleet_batches(cfg, n: int):
    """``n`` fleet batches, (S, B, H, W, 3) frames and (S, B) stamps, read
    from the config's sources."""
    from roadvision_tpu_torch.runtime import build_sources
    b = cfg["tpu"]["batch_size"]
    srcs = build_sources(cfg["camera"], max_frames=n * b)
    out = []
    for _ in range(n):
        reads = [src.read_batch(b) for src in srcs]
        out.append((np.stack([r[0] for r in reads]),
                    np.stack([r[1] for r in reads])))
    for src in srcs:
        src.release()
    return out


def compare_fleet(cpu, gpu, what: str) -> tuple:
    """Per-stream result lists: ``compare_results`` on each stream (RAW
    frames equal: the fleet returns no processed frame). Returns (max box
    error, detections)."""
    worst, n = 0.0, 0
    if len(cpu) != len(gpu):
        fail(f"{what}: {len(cpu)} streams against {len(gpu)}")
    for a, b in zip(cpu, gpu):
        worst = max(worst, compare_results(a, b))
        n += sum(len(r.detections) for r in a)
    return worst, n


def streams_phase(model: str, card: str) -> dict:
    """``[streams]``: multi_stream.yaml's fleet (4 x 720p x batch 8). One
    float32 fleet batch on the card against the same fleet on the CPU
    path (the folded preprocess output bit-equal, detections within
    BOX_TOL / CONF_TOL, ids equal) and against 4 single-stream engines on
    the card (the detector's batch-fold gap printed); then bfloat16 timed
    through ``process_batch``: aggregate and per-stream frames/s (median,
    min, max of FLEET_WINDOWS windows of FLEET_ITERS batches) against one
    single-stream engine's on stream 0's frames, the fleet step's stage
    ms and the association's host syncs in one fleet batch. K1, K2 and K3
    launch exactly once per fleet batch."""
    import torch
    from roadvision_tpu_torch.runtime import MultiStreamEngine, PipelineEngine
    from roadvision_tpu_torch.tools.bench import fleet_stage_ms, windows_fps
    from roadvision_tpu_torch.track import sort as tsort
    cfg32 = multi_cfg(model, "float32")
    s, b = len(cfg32["camera"]["sources"]), cfg32["tpu"]["batch_size"]
    fb = fleet_batches(cfg32, 3)
    h, w = fb[0][0].shape[2:4]
    gpu = MultiStreamEngine(cfg32, s)
    if [d.type for d in gpu.devices] != ["cuda"] or gpu.padded_streams != s:
        fail(f"[streams]: devices {gpu.devices}, {gpu.padded_streams} "
             f"streams (one card, no padding expected)")
    if gpu.step_mode != "graph":
        fail(f"[streams]: step_mode {gpu.step_mode} ({gpu.engine.eager_reason})")
    with PathLaunches("[streams] float32") as pl:
        r_gpu = gpu.process_batch(*fb[0])
        counts32 = pl.check(1 + warm(1), tracked(b))
    cpu = MultiStreamEngine(cfg32, s, devices=["cpu"])
    t_cpu = time.perf_counter()
    r_cpu = cpu.process_batch(*fb[0])
    t_cpu = time.perf_counter() - t_cpu
    worst, n_dets = compare_fleet(r_cpu, r_gpu, "[streams] card vs CPU")
    fold = torch.from_numpy(fb[0][0].reshape(s * b, h, w, 3))
    if not torch.equal(gpu.engine.pipeline.apply_batch(fold.cuda()).cpu(),
                       cpu.engine.pipeline.apply_batch(fold)):
        fail("[streams]: the folded batch's processed frames differ")
    if n_dets == 0:
        fail("[streams]: no detections to compare")
    # the same fleet as 4 independent single-stream engines on the card
    gap = {"box": 0.0, "conf": 0.0}
    for si in range(s):
        one = PipelineEngine(cfg32, device="cuda")
        one._t0 = gpu._t0                  # the fleet's time origin
        ref = one.process_batch(fb[0][0][si], fb[0][1][si])
        for ra, rb in zip(ref, r_gpu[si]):
            if [(d.cls_id, d.track_id) for d in ra.detections] != \
                    [(d.cls_id, d.track_id) for d in rb.detections]:
                fail(f"[streams]: stream {si} differs from its "
                     f"single-stream run in classes or ids")
            for da, db in zip(ra.detections, rb.detections):
                gap["box"] = max(gap["box"], max(abs(p - q) for p, q in zip(
                    (da.x1, da.y1, da.x2, da.y2),
                    (db.x1, db.y1, db.x2, db.y2))))
                gap["conf"] = max(gap["conf"], abs(da.conf - db.conf))
    if gap["box"] > BOX_TOL or gap["conf"] > CONF_TOL:
        fail(f"[streams]: fleet vs single-stream runs {gap}")
    print(f"[streams] float32 fleet batch ({s} x {w}x{h} x {b}): "
          f"{n_dets} detections match the CPU path (max box err "
          f"{worst:.2e} px, ids equal, the folded preprocess bit-equal; CPU "
          f"fleet {t_cpu:.2f} s); against {s} single-stream engines on the "
          f"card ids equal, gap {gap['box']:.2e} px / conf "
          f"{gap['conf']:.2e}; launches {counts32}", flush=True)

    # bfloat16, timed
    torch.backends.cudnn.benchmark = True
    cfg = multi_cfg(model)
    eng = MultiStreamEngine(cfg, s)
    eng.process_batch(*fb[0])                       # warm-up
    fed = iter(range(1, 10 ** 9))

    def shifted(k):
        frames, ts = fb[k % 3]
        return frames, ts + (k // 3) * 3 * b / 30.0

    def window() -> int:
        for _ in range(FLEET_ITERS):
            eng.process_batch(*shifted(next(fed)))
        return FLEET_ITERS * s * b

    with PathLaunches("[streams] timed") as pl:
        fps = windows_fps(window, FLEET_WINDOWS, torch.device("cuda"))
        tsort.reset_host_syncs()
        eng.process_batch(*shifted(next(fed)))
        syncs = tsort.host_syncs
        n_fleet = FLEET_ITERS * FLEET_WINDOWS + 1
        counts = pl.check(n_fleet, tracked(b))
    # the stages of the next fleet batch, on the fleet's running state
    frames, ts = shifted(next(fed))
    frames_d = torch.from_numpy(frames).cuda()
    ts_d = torch.from_numpy((ts - eng._t0).astype(np.float32)).cuda()
    grp = eng.groups[0]
    stages = [fleet_stage_ms(grp.engine, frames_d, ts_d, grp.states)
              for _ in range(FLEET_WINDOWS)]
    stage = {k: float(np.median([x[k] for x in stages])) for k in stages[0]}
    # one camera alone on the same card, stream 0's frames
    one = PipelineEngine(cfg, device="cuda")
    one.process_batch(fb[0][0][0], fb[0][1][0], want_proc=False)
    alone = iter(range(1, 10 ** 9))

    def single_window() -> int:
        for _ in range(FLEET_ITERS):
            k = next(alone)
            one.process_batch(fb[k % 3][0][0],
                              fb[k % 3][1][0] + (k // 3) * 3 * b / 30.0,
                              want_proc=False)
        return FLEET_ITERS * b

    with PathLaunches("[streams] single stream") as pl:
        fps1 = windows_fps(single_window, FLEET_WINDOWS, torch.device("cuda"))
        pl.check(FLEET_ITERS * FLEET_WINDOWS, tracked(b))
    per = {k: fps[k] / s for k in ("median", "min", "max")}
    print(f"[streams] bfloat16: {s} streams x {w}x{h} x batch {b} through "
          f"process_batch: {fps['median']:.1f} frames/s in all [min "
          f"{fps['min']:.1f}, max {fps['max']:.1f}], {per['median']:.1f} a "
          f"stream; one stream alone {fps1['median']:.1f} [{fps1['min']:.1f}"
          f"-{fps1['max']:.1f}] ({fps['median'] / fps1['median']:.2f} x); "
          f"{syncs} host syncs in one fleet batch; fleet stage ms "
          + json.dumps({k: round(v, 2) for k, v in stage.items()})
          + f"; launches {counts} ({card})", flush=True)
    return {"float32": {"detections": n_dets, "max_box_err": worst,
                        "single_stream_gap": gap, "launches": counts32},
            "fps": fps, "per_stream_fps": per, "single_stream_fps": fps1,
            "host_syncs_per_batch": syncs, "stage_ms": stage,
            "launches": counts}


def streams_gate_phase(model: str, card: str) -> dict:
    """``[streams] gate``: the fleet gate (``detect.temporal_gate`` on
    multi_stream.yaml, float32) on 4 static streams (the first batch runs,
    the next two coast) and on 3 static streams and 1 moving (none
    coasts): the coasted frames and the detections equal on the card and
    on the CPU; launches once per batch that runs the detector, none on a
    coasted one."""
    from roadvision_tpu_torch.runtime import MultiStreamEngine
    cfg = multi_cfg(model, "float32", detect={"model": model,
                                              "temporal_gate": {
                                                  "enable": True}})
    fb = fleet_batches(cfg, 2)
    still = np.repeat(fb[0][0][:, :1], fb[0][0].shape[1], axis=1)
    moving = [still.copy() for _ in fb]
    for k, (frames, _) in enumerate(fb):
        moving[k][-1] = frames[-1]
    s, b = still.shape[:2]
    scenes = {"static": ([still] * 3, 1, 2 * s * b),
              "one moving": (moving, 2, 0)}
    out = {}
    for scene, (clip, full, want) in scenes.items():
        res = {}
        for dev in ("cuda", "cpu"):
            eng = MultiStreamEngine(cfg, s, devices=[dev])
            stamps = [fb[0][1] + k * b / 30.0 for k in range(len(clip))]
            if dev == "cuda":
                with PathLaunches(f"[streams] gate {scene}") as pl:
                    got = [eng.process_batch(f, t)
                           for f, t in zip(clip, stamps)]
                    # a coasted fleet batch runs no detector but tracks
                    # its frames on the reused detections
                    counts = pl.check(full, tail_want(full, len(clip) * b))
            else:
                got = [eng.process_batch(f, t) for f, t in zip(clip, stamps)]
            res[dev] = (got, eng.gate_frames_coasted)
        if res["cuda"][1] != res["cpu"][1] or res["cuda"][1] != want:
            fail(f"[streams] gate {scene}: coasted frames card "
                 f"{res['cuda'][1]}, CPU {res['cpu'][1]}, expected {want}")
        n = sum(compare_fleet(c, g, f"[streams] gate {scene}")[1]
                for c, g in zip(res["cpu"][0], res["cuda"][0]))
        if n == 0:
            fail(f"[streams] gate {scene}: no detections")
        print(f"[streams] gate, {scene}: {len(clip)} fleet batches, "
              f"{want} frames coasted on the card and on the CPU; {n} "
              f"detections match; launches {counts} ({card})", flush=True)
        out[scene] = {"coasted": want, "detections": n, "launches": counts}
    return out


def write_multi_yaml(model: str, tmp: Path, **over) -> Path:
    import yaml
    path = tmp / "multi_stream.yaml"
    path.write_text(yaml.safe_dump(multi_cfg(model, **over)))
    return path


def grid_size(cfg) -> tuple:
    """(w, h) of the fleet's tiled canvas."""
    from roadvision_tpu_torch.vis import tile_streams
    cam = cfg["camera"]
    tiles = [np.zeros((cam["height"], cam["width"], 3), np.uint8)
             for _ in cam["sources"]]
    h, w = tile_streams(tiles, [f"CAM{i}" for i in range(len(tiles))]
                        ).shape[:2]
    return w, h


def entry_multi_preview(model: str, tmp: Path) -> dict:
    """``[entry] multi_preview``: the preview ``main`` on the fleet config
    with ``--max-frames 32 --no-show --record``: a valid AVI of 32 grid
    canvases, one launch of each kernel per fleet batch."""
    from roadvision_tpu_torch.tools import preview
    cfg_path = write_multi_yaml(model, tmp)
    avi = tmp / "fleet.avi"
    n = 32
    b = multi_cfg(model)["tpu"]["batch_size"]
    with PathLaunches("[entry] multi_preview") as pl:
        t0 = time.perf_counter()
        rc = preview.main(["--config", str(cfg_path), "--max-frames", str(n),
                           "--no-show", "--record", str(avi)])
        elapsed = time.perf_counter() - t0
        counts = pl.check(n // b + warm(1), tracked(b))
    if rc != 0:
        fail(f"[entry] multi_preview: main returned {rc}")
    size = grid_size(multi_cfg(model))
    check_avi(avi, n, size)
    print(f"[entry] multi_preview: {n} grid canvases {size[0]}x{size[1]} of "
          f"4 streams recorded to a valid MJPEG AVI and read back; "
          f"{n / elapsed:.1f} canvases/s with overlays, grid and JPEG; "
          f"launches {counts}", flush=True)
    return {"launches": counts, "canvases_per_s": n / elapsed}


def http_json(host, port, path):
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=30.0)
    try:
        conn.request("GET", path, headers={"Connection": "close"})
        resp = conn.getresponse()
        if resp.status != 200:
            fail(f"GET {path} -> {resp.status}")
        body = resp.read()
        return body if path == "/metrics" else json.loads(body)
    finally:
        conn.close()


def serve_until_done(cfg, max_frames: int, parts: int = 0):
    """The server on 127.0.0.1 port 0 with ``cfg``: read ``parts`` stream
    parts, wait for the pipeline to end, read /stats, /events and
    /metrics, shut down with every thread joined."""
    from roadvision_tpu_torch.tools import serve
    before = set(threading.enumerate())
    server, hub, worker = serve.serve_background(cfg, port=0,
                                                 max_frames=max_frames)
    host, port = server.server_address[:2]
    try:
        got = serve.read_stream_parts(host, port, parts, timeout=60.0) \
            if parts else []
        worker.join(timeout=300.0)
        answers = {p: http_json(host, port, p)
                   for p in ("/stats", "/events", "/metrics")}
    finally:
        hub.close()
        server.shutdown()
        server.server_close()
        worker.join(timeout=60.0)
        server.thread.join(timeout=60.0)
    if worker.is_alive() or server.thread.is_alive():
        fail("serve: a thread did not stop")
    if hub.error is not None:
        fail(f"serve: the pipeline failed: {hub.error!r}")
    deadline = time.time() + 20.0
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    left = set(threading.enumerate()) - before
    if left:
        fail(f"serve: threads still alive: {left}")
    return got, answers


def entry_multi_serve(model: str) -> dict:
    """``[entry] multi_serve``: the server on the fleet config: three
    ``/stream`` parts decode to the grid canvas, ``/stats`` counts the
    canvases, clean shutdown."""
    import io

    from PIL import Image
    cfg = multi_cfg(model)
    n = 64
    with PathLaunches("[entry] multi_serve") as pl:
        parts, ans = serve_until_done(cfg, n, parts=3)
        b = cfg["tpu"]["batch_size"]
        counts = pl.check(n // b + warm(1), tracked(b))
    size = grid_size(cfg)
    if len(parts) != 3 or any(Image.open(io.BytesIO(p)).size != size
                              for p in parts):
        fail(f"[entry] multi_serve: {len(parts)} parts, not the grid {size}")
    if ans["/stats"]["frames"] != n or not ans["/stats"]["done"]:
        fail(f"[entry] multi_serve: /stats {ans['/stats']}")
    print(f"[entry] multi_serve: 3 stream parts decode to the {size[0]}x"
          f"{size[1]} grid; /stats {ans['/stats']}; every thread joined; "
          f"launches {counts}", flush=True)
    return {"launches": counts, "stats": ans["/stats"]}


def entry_streams_api(model: str) -> dict:
    """``[entry] streams_api``: ``Pipeline.streams`` over 2.5 batches of
    each stream (the last batch short, uploaded through the pinned ring
    while a full one may still wait to be dispatched), bit-equal to
    ``MultiStreamEngine.process_batch`` on the same frames and stamps."""
    import roadvision_tpu_torch as rvt
    from roadvision_tpu_torch.runtime import MultiStreamEngine
    cfg = multi_cfg(model)
    b = cfg["tpu"]["batch_size"]
    pipe = rvt.Pipeline(cfg)
    n_frames = 2 * b + b // 2
    with PathLaunches("[entry] streams_api") as pl:
        got = list(pipe.streams(max_frames=n_frames))
        # two shapes (b and b // 2 frames), two captures
        runs = 3 + warm(2)
        counts = pl.check(runs, tail_want(
            runs, 2 * b + b // 2 + warm(1) * (b + b // 2)))
    if [len(batch[0]) for batch in got] != [b, b, b // 2]:
        fail(f"[entry] streams_api: batches of "
             f"{[len(batch[0]) for batch in got]} frames")
    ref = MultiStreamEngine(cfg, len(cfg["camera"]["sources"]))
    n = 0
    for batch in got:
        frames = np.stack([[r.raw for r in st] for st in batch])
        ts = np.array([[r.ts for r in st] for st in batch])
        want = ref.process_batch(frames, ts)
        for si, (a, c) in enumerate(zip(want, batch)):
            n += same_detections(a, c, f"[entry] streams_api stream {si}")
    if n == 0:
        fail("[entry] streams_api: no detections to compare")
    print(f"[entry] streams_api: Pipeline.streams over {n_frames} frames "
          f"(batches {b}, {b}, {b // 2}) of "
          f"{len(got[0])} streams equals MultiStreamEngine.process_batch bit "
          f"for bit ({n} detections); launches {counts}", flush=True)
    return {"launches": counts, "detections": n}


def entry_analytics_demo(tmp: Path) -> dict:
    """``[entry] analytics_demo``: configs/analytics_demo.yaml as shipped
    (256², deepsort with the learned re-id, no preprocess chain: no
    kernel launches), which replays a CUDA graph, through the preview (60
    frames: the summary and the event count); ``tools/analyze.py`` on the card
    and on the CPU over the same 60 frames in float32 with TF32 off and the
    wall clock the sources stamp from pinned: the reports equal (counts exact,
    float statistics within 1e-3 relative); the server: /events non-empty,
    ``roadvision_analytics_events_total`` in /metrics."""
    import yaml
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.config import load_config
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.tools import analyze, preview
    root = Path(__file__).resolve().parent
    demo = root / "configs" / "analytics_demo.yaml"
    real = preview.Analytics
    made = []

    class Counting(real):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.n_events = 0
            made.append(self)

        def update(self, detections, timestamp):
            events = super().update(detections, timestamp)
            self.n_events += len(events)
            return events

    eng = PipelineEngine(load_config(str(demo)))
    if eng.step_mode != "graph":
        fail(f"[entry] analytics_demo: runs {eng.step_mode} "
             f"({eng.eager_reason})")
    del eng
    avi = tmp / "analytics.avi"
    kernels.reset_launch_counts()
    preview.Analytics = Counting
    try:
        rc = preview.main(["--config", str(demo), "--max-frames", "60",
                           "--no-show", "--record", str(avi)])
    finally:
        preview.Analytics = real
    if rc != 0 or len(made) != 1:
        fail(f"[entry] analytics_demo: rc {rc}, {len(made)} aggregates")
    # no chain; deepsort replayed: NMS a batch, one association a frame,
    # and the warm-ups of two captures (batches of 8 and the last one of 4)
    exact_launches("[entry] analytics_demo",
                   tail_want(8 + warm(2), 60 + warm(1) * (8 + 4)))
    check_avi(avi, 60, (2 * 256 + 4, 256))
    summary = made[0].summary()
    print(f"[entry] analytics_demo preview: 60 frames, {made[0].n_events} "
          f"events; summary {json.dumps(summary)}", flush=True)

    cfg32 = load_config(str(demo))
    cfg32["tpu"]["compute_dtype"] = "float32"
    path32 = tmp / "analytics32.yaml"
    path32.write_text(yaml.safe_dump(cfg32))
    args = ["--config", str(path32), "--source", "synthetic:4", "--width",
            "256", "--height", "256", "--frames", "60"]
    wall = time.time
    time.time = lambda: 1000.0      # the sources stamp frames from it
    try:
        for dev in ("cuda", "cpu"):
            analyze.main(args + ["--out", str(tmp / f"{dev}.json"),
                                 "--device", dev])
    finally:
        time.time = wall
    reports = [json.loads((tmp / f"{d}.json").read_text())
               for d in ("cuda", "cpu")]

    def close(a, b, where):
        if isinstance(a, dict):
            if set(a) != set(b):
                fail(f"[entry] analyze: keys differ at {where}")
            for k in a:
                close(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list):
            if len(a) != len(b):
                fail(f"[entry] analyze: lengths differ at {where}")
            for i, (x, y) in enumerate(zip(a, b)):
                close(x, y, f"{where}[{i}]")
        elif isinstance(a, float):
            if abs(a - b) > 1e-3 * max(abs(a), abs(b), 1e-9):
                fail(f"[entry] analyze: {where} {a} on the card, {b} on the "
                     f"CPU")
        elif a != b:
            fail(f"[entry] analyze: {where} {a} on the card, {b} on the CPU")

    close(reports[0], reports[1], "report")
    if reports[0]["frames"] != 60 or not reports[0]["detections_total"]:
        fail(f"[entry] analyze: report {str(reports[0])[:300]}")
    print(f"[entry] analyze: the card's report equals the CPU's (60 frames, "
          f"{reports[0]['detections_total']} detections, "
          f"{reports[0]['unique_track_ids']} ids, "
          f"{len(reports[0]['events'])} events)", flush=True)

    _, ans = serve_until_done(load_config(str(demo)), 60)
    metrics = ans["/metrics"].decode()
    events = ans["/events"]["events"]
    if not events or f"roadvision_analytics_events_total {len(events)}" \
            not in metrics or "analytics" not in ans["/stats"]:
        fail(f"[entry] analytics_demo serve: {len(events)} events; "
             f"{metrics[-200:]}")
    print(f"[entry] analytics_demo serve: /events gives {len(events)} "
          f"events, /metrics counts them, /stats carries the analytics",
          flush=True)
    return {"preview_events": made[0].n_events, "summary": summary,
            "report": {k: reports[0][k] for k in
                       ("frames", "detections_total", "unique_track_ids")},
            "served_events": len(events)}


def bench_streams_phase(model: str, card: str) -> dict:
    """``[bench] streams``: the port bench's fleet mode in-process at
    1080p, batch 8, for S = 1, 2, 4 and 8 streams: aggregate frames/s
    against S, one launch of each kernel per fleet batch."""
    import contextlib
    import io
    import os

    from roadvision_tpu_torch.tools import bench
    out = {}
    for s in (1, 2, 4, 8):
        os.environ["RVT_BENCH_STREAMS"] = str(s)
        os.environ["RVT_BENCH_RES"] = str(HEIGHT)
        buf = io.StringIO()
        with PathLaunches(f"[bench] streams {s}") as pl:
            with contextlib.redirect_stdout(buf):
                rc = bench.main(["--mode", "streams", "--iters", "2",
                                 "--windows", "3", "--warmup", "1",
                                 "--model", model])
            pl.check(1, tracked(), at_least=True)
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc != 0 or line["card"] != card \
                or line["metric"] != f"streams{s}_{HEIGHT}p_fps" \
                or not per_batch_ok(line["launches_per_batch"]) \
                or not line["streams_fps"]["median"] > 0:
            fail(f"[bench] streams {s}: rc {rc}, line {line}")
        out[s] = line
        print(f"[bench] streams {s} x {HEIGHT}p x batch {BATCH}: "
              f"{line['streams_fps']['median']:.1f} frames/s in all [min "
              f"{line['streams_fps']['min']:.1f}, max "
              f"{line['streams_fps']['max']:.1f}], "
              f"{line['per_stream_fps']['median']:.1f} a stream, "
              f"{line['host_syncs_per_batch']} host syncs a fleet batch, "
              f"stage ms " + json.dumps({k: round(v, 2) for k, v in
                                          line["stage_ms"].items()})
              + f" ({card})", flush=True)
    for key in ("RVT_BENCH_STREAMS", "RVT_BENCH_RES"):
        os.environ.pop(key)
    return out


def fleet_cards_phase(model: str, card: str) -> dict:
    """``--fleet-cards``: the fleet on every visible card (``tpu.mesh.
    devices: null``; one contiguous group of streams per card) against
    the same fleet on card 0 alone, 2 streams per card: one float32
    fleet batch each (counts, classes and ids equal, boxes within
    BOX_TOL, confidences within CONF_TOL), one launch of each kernel per
    card per fleet batch; the fleet gate on static streams and with one
    moving stream on the last card (coasted frames equal to the one-card
    fleet's); an uneven stream count padded; then bfloat16 frames/s of
    both fleets over FLEET_WINDOWS windows of FLEET_ITERS batches."""
    import torch
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.runtime import MultiStreamEngine
    from roadvision_tpu_torch.tools.bench import windows_fps
    n = torch.cuda.device_count()
    if n < 2:
        fail(f"--fleet-cards: {n} card(s) visible, needs 2 or more")
    s = 2 * n
    cams = {"camera": {"sources": [f"synthetic:{6 + i}" for i in range(s)]}}
    cfg32 = merge(multi_cfg(model, "float32"), cams)
    fb = fleet_batches(cfg32, 2)
    b = cfg32["tpu"]["batch_size"]
    out = {"cards": n, "streams": s}
    many = MultiStreamEngine(cfg32, s)
    one = MultiStreamEngine(cfg32, s, devices=["cuda:0"])
    if len(many.devices) != n or many.padded_streams != s:
        fail(f"--fleet-cards: devices {many.devices}")
    with PathLaunches("[fleet cards] float32") as pl:
        got = many.process_batch(*fb[0])
        # one step a card, each after its group's capture
        counts = pl.check(n * (1 + warm(1)), tracked(b))
    # each card's group replays its own graph, captured on its card
    for grp in many.groups:
        graphs = grp.engine._graphs
        if grp.engine.step_mode != "graph" or len(graphs) != 1 or any(
                g.device != grp.engine.device for g in graphs.values()):
            fail(f"[fleet cards]: {grp.engine.device} runs "
                 f"{grp.engine.step_mode} with graphs "
                 f"{ {k: g.device for k, g in graphs.items()} }")
    want = one.process_batch(*fb[0])
    worst, n_dets = compare_fleet(want, got, "[fleet cards]")
    if n_dets == 0:
        fail("[fleet cards]: no detections")
    print(f"[fleet cards] float32 fleet of {s} x 720p x {b} on {n} cards, "
          f"one CUDA graph a card, equals the one-card fleet ({n_dets} "
          f"detections, max box err {worst:.2e} px, ids equal); launches "
          f"{counts} (each card: its capture's warm-ups, one replay)",
          flush=True)
    out["float32"] = {"detections": n_dets, "max_box_err": worst,
                      "launches": counts}
    # the fleet gate: one decision over every card's streams
    gcfg = merge(cfg32, {"detect": {"temporal_gate": {"enable": True}}})
    still = np.repeat(fb[0][0][:, :1], b, axis=1)
    moving = still.copy()
    moving[-1] = fb[1][0][-1]                 # the last card's last stream
    coasted = {}
    for name, devs in (("cards", None), ("one", ["cuda:0"])):
        eng = MultiStreamEngine(gcfg, s, devices=devs)
        for k, frames in enumerate((still, still, moving, still)):
            eng.process_batch(frames, fb[0][1] + k * b / 30.0)
        coasted[name] = eng.gate_frames_coasted
    # the second batch coasts; the moving stream keeps the last two awake
    if coasted["cards"] != coasted["one"] or coasted["one"] != s * b:
        fail(f"[fleet cards] gate: coasted {coasted}, expected {s * b}")
    print(f"[fleet cards] gate: static, static, one moving stream on the "
          f"last card, static: {coasted['cards']} frames coasted on {n} "
          f"cards and on one", flush=True)
    out["gate_coasted"] = coasted["cards"]
    uneven = MultiStreamEngine(cfg32, s + 1)
    if uneven.padded_streams != 3 * n:
        fail(f"[fleet cards]: {s + 1} streams padded to "
             f"{uneven.padded_streams}")
    extra = np.concatenate([fb[0][0], fb[0][0][:1]])
    stamps = np.concatenate([fb[0][1], fb[0][1][:1]])
    r_uneven = uneven.process_batch(extra, stamps)
    compare_fleet(want, r_uneven[:s], "[fleet cards] uneven")
    # bfloat16, timed: the same fleet on every card and on one
    torch.backends.cudnn.benchmark = True
    cfg = merge(multi_cfg(model), cams)
    fps = {}
    for name, devs in (("cards", None), ("one", ["cuda:0"]),
                       ("cards again", None)):
        eng = MultiStreamEngine(cfg, s, devices=devs)
        eng.process_batch(*fb[0])
        fed = iter(range(1, 10 ** 9))

        def window() -> int:
            for _ in range(FLEET_ITERS):
                k = next(fed)
                eng.process_batch(fb[k % 2][0],
                                  fb[k % 2][1] + (k // 2) * 2 * b / 30.0)
            return FLEET_ITERS * s * b

        fps[name] = windows_fps(window, FLEET_WINDOWS, torch.device("cuda"))
        print(f"[fleet cards] bfloat16, {s} streams x 720p x {b} on "
              f"{len(eng.devices)} card(s): {fps[name]['median']:.1f} "
              f"frames/s [min {fps[name]['min']:.1f}, max "
              f"{fps[name]['max']:.1f}] ({card})", flush=True)
    out["fps"] = fps
    return out


# ----------------------------------------------------------------------
# training (K1-K4 and K6 launch 0; K5 matches RT-DETR's sets, K7 and K8
# sample its decoder forward and backward)

TRAIN_LOSS_RTOL = 1e-3     # loss, its components, the gradient norm
TRAIN_PARAM_ATOL = 1e-5    # parameters after one step, card against CPU
# RT-DETR's first moment per leaf, relative to the leaf's largest value:
# the deformable sampling offsets' gradients go through bilinear corner
# weights summed in another order (3 % between JAX and the port at 64²)
TRAIN_MOMENT_RTOL_RTDETR = 5e-2
TRAIN_STEPS, TRAIN_TIMED, TRAIN_PARTS = 10, 8, 3
# RT-DETR steps on the card in [train]: the parity step, the fixed-batch
# steps, the step whose syncs are counted, the timed ones, the parts'; each
# matches in one launch of K5 (matcher mode) and runs a forward and a
# backward (K7 and K8 once a decoder layer each)
RTDETR_CARD_STEPS = 1 + TRAIN_STEPS + 1 + TRAIN_TIMED + TRAIN_PARTS
TRAIN_DEVICE = "cuda"
TRAIN_ENTRY = ("640", "16")    # [entry] train: imgsz, batch


def train_families(tmp: Path) -> dict:
    """Per family: (JAX-layout tree, batch generator, full-width imgsz
    and batch, the CPU parity batch, loss function or "rtdetr", lr).
    v8n at ultralytics' 640 × 16, RT-DETR-L at 640 × 4, the task heads at
    640 × 8. The learning rates are the tool's defaults (1e-3, RT-DETR
    1e-4) but for the random YOLO11n, whose loss moves by 1e-4 in 10 steps
    at 1e-3 (1e-2 there)."""
    from roadvision_tpu_torch.detect import dataset as ds
    from roadvision_tpu_torch.models.yolo import train as T
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.models.yolo.train_obb import obb_loss
    from roadvision_tpu_torch.models.yolo.train_pose import pose_loss
    from roadvision_tpu_torch.models.yolo.train_seg import segmentation_loss
    from roadvision_tpu_torch.models.yolo.train_v5 import detection_loss_v5
    assets = Path(__file__).resolve().parent / "assets"

    def task(kind, nc):
        return W.import_npz(_trained_task_tree(kind, nc, tmp))

    return {
        "v8n": (W.import_npz(assets / "yolov8n_synthetic_256.npz"),
                ds.synthetic_batches, 640, 16, 2, T.detection_loss, 1e-3),
        "yolo11n": (W.tree_from_model(W.random_model("11", "detect", "n",
                                                     80, seed=0)),
                    ds.synthetic_batches, 640, 16, 2, T.detection_loss,
                    1e-2),
        "v5n": (W.import_npz(assets / "yolov5n_synthetic_256.npz"),
                ds.synthetic_batches, 640, 16, 2, detection_loss_v5, 1e-3),
        "v8n-seg": (task("segment", 80), ds.synthetic_seg_batches, 640, 8,
                    2, segmentation_loss, 1e-3),
        "v8n-pose": (task("pose", 1), ds.synthetic_pose_batches, 640, 8, 2,
                     pose_loss, 1e-3),
        "v8n-obb": (task("obb", 15), ds.synthetic_obb_batches, 640, 8, 2,
                    obb_loss, 1e-3),
        "rtdetr-l": (W.import_npz(assets / "rtdetr_l_synthetic_256.npz"),
                     ds.synthetic_batches, 640, 4, 1, "rtdetr", 1e-4),
    }


def count_syncs(fn) -> int:
    """Device-to-host synchronisations inside ``fn()``, by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def step_times(step) -> list:
    """Host ms of TRAIN_TIMED calls of ``step``, each between two device
    synchronises."""
    import torch
    times = []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _on(batch, device):
    import torch
    imgs, *gts = batch
    return (torch.from_numpy(np.ascontiguousarray(imgs)).to(device).float()
            / 255.0, *(torch.from_numpy(np.asarray(g)).to(device)
                       for g in gts))


def _train_step(loss, lr):
    from roadvision_tpu_torch.models import rtdetr_train as RT
    from roadvision_tpu_torch.models.yolo import train as T
    if loss == "rtdetr":
        return RT.make_train_step_rtdetr(lr=lr), RT.init_opt_rtdetr
    return T.make_train_step(loss, lr), T.init_momentum


def _model(tree, device):
    from roadvision_tpu_torch.models.yolo import weights as W
    return W.model_from_params(tree).set_compute_dtype(
        __import__("torch").float32).to(device).train()


def train_parity(name, tree, gen, imgsz, nb, loss, lr) -> dict:
    """One float32 step (TF32 off) from the same tree and batch on the
    card and on the CPU: loss, components and gradient norm within
    TRAIN_LOSS_RTOL; the optimiser state (SGD momentum, AdamW's first
    moment: the clipped gradient scaled) per leaf within 1e-3 of its
    largest value (RT-DETR: TRAIN_MOMENT_RTOL_RTDETR); the parameters
    after the step within TRAIN_PARAM_ATOL. AdamW's first step moves a
    parameter by ≈ lr · sign(g): where |g| is under that tolerance (float
    noise, e.g. the attention key biases, whose true gradient is 0) only
    ≤ 2 · lr is held."""
    import torch
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.runtime.checkpoint import opt_state_tree
    batch = next(gen(nb, imgsz=imgsz, seed=1))
    out = {}
    for dev in (TRAIN_DEVICE, "cpu"):
        step, init = _train_step(loss, lr)
        model = _model(tree, dev)
        opt = init(model)
        loss_v, aux = step(model, opt, *_on(batch, dev))
        moment = opt_state_tree(opt)
        out[dev] = (float(loss_v), {k: float(v) for k, v in aux.items()},
                    W.flatten_tree(W.tree_from_model(model)),
                    W.flatten_tree(moment["m"] if loss == "rtdetr"
                                   else moment))
    (lg, ag, pg, mg), (lc, ac, pc, mc) = out[TRAIN_DEVICE], out["cpu"]
    worst = {"loss": abs(lg - lc) / max(abs(lc), 1e-12)}
    for k, v in ac.items():
        if k in ("num_fg", "ok"):
            if ag[k] != v:
                fail(f"[train] {name}: {k} {ag[k]} on the card, {v} on "
                     f"the CPU")
            continue
        worst[k] = abs(ag[k] - v) / max(abs(v), 1e-12)
    rel = {k: float(np.abs(mg[k] - mc[k]).max()
                    / (np.abs(mc[k]).max() + 1e-9)) for k in mc}
    worst["moment_rel"] = max(rel.values())
    worst["moment_leaf"] = max(rel, key=rel.get)
    moment_rtol = TRAIN_MOMENT_RTOL_RTDETR if loss == "rtdetr" else 1e-3
    worst["param_abs"] = 0.0
    for k in pc:
        diff = np.abs(pg[k] - pc[k])
        if loss == "rtdetr":
            sure = np.abs(mc[k]) > moment_rtol * np.abs(mc[k]).max() \
                + 1e-9
            if diff.max() > 2 * lr + 1e-6:
                fail(f"[train] {name}: {k} moved {diff.max()} apart")
            diff = diff[sure] if sure.any() else np.zeros(1)
        worst["param_abs"] = max(worst["param_abs"], float(diff.max()))
    if max(v for k, v in worst.items() if k not in (
            "param_abs", "moment_rel", "moment_leaf")) \
            > TRAIN_LOSS_RTOL or worst["moment_rel"] > moment_rtol \
            or worst["param_abs"] > TRAIN_PARAM_ATOL or not np.isfinite(lg):
        fail(f"[train] {name}: card vs CPU {worst} (loss {lg} / {lc})")
    return {"loss_card": lg, "loss_cpu": lc, "rel_err": worst,
            "num_fg": ac["num_fg"]}


def train_timed(name, tree, gen, imgsz, nb, loss, lr) -> dict:
    """At full width on the card, TF32 off: 10 steps on one fixed batch
    (the loss must fall), then TRAIN_TIMED warm steps timed whole (median
    and spread), TRAIN_PARTS steps split into parts (a synchronise around
    each part), peak memory, host syncs in one step."""
    import torch
    from roadvision_tpu_torch.models import rtdetr_train as RT
    from roadvision_tpu_torch.models.yolo import train as T
    dev = torch.device(TRAIN_DEVICE)
    batch = _on(next(gen(nb, imgsz=imgsz, seed=2)), dev)
    step, init = _train_step(loss, lr)
    model = _model(tree, dev)
    opt = init(model)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(model, opt, *batch)[0])
              for _ in range(TRAIN_STEPS)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"[train] {name}: loss over {TRAIN_STEPS} steps on a fixed "
             f"batch {losses}")
    peak = torch.cuda.max_memory_allocated()
    RT.reset_host_syncs()
    syncs = count_syncs(lambda: step(model, opt, *batch))
    auction_reads = RT.host_syncs
    times = step_times(lambda: step(model, opt, *batch))
    T.PART_TIMER = T.PartTimer(dev)
    try:
        for _ in range(TRAIN_PARTS):
            step(model, opt, *batch)
        parts = {k: float(np.median(v)) for k, v in T.PART_TIMER.ms.items()}
    finally:
        T.PART_TIMER = None
    med = float(np.median(times))
    return {"imgsz": imgsz, "batch": nb, "losses": losses,
            "step_ms": med, "step_ms_min": min(times),
            "step_ms_max": max(times), "parts_ms": parts,
            "images_per_s": nb / med * 1e3, "peak_mem_bytes": peak,
            "host_syncs_per_step": syncs,
            "auction_reads_per_step": auction_reads, "tf32": False}


def train_reid_phase() -> dict:
    """Re-id: one Adam step card vs CPU (loss TRAIN_LOSS_RTOL, the first
    moment per leaf 1e-3 of its largest value, the parameters within
    TRAIN_PARAM_ATOL where that moment is above 1e-3 of the largest and
    within 2 · lr elsewhere: Adam's first step is ≈ lr · sign(g)), 10
    steps on one batch lower the triplet loss, then timed steps (8
    identities × 4 views, 64² frames, the tool's default batch)."""
    import torch
    from roadvision_tpu_torch.track import reid as R
    lr = 1e-3
    rng = np.random.default_rng(0)
    frames, boxes, labels = R.synthetic_reid_batch(
        rng, rng.choice(128, size=8, replace=False), 4)
    res = {}
    for dev in (TRAIN_DEVICE, "cpu"):
        p = R.init_reid_params(0, dev)
        st = R.init_adam(p)
        b = [torch.from_numpy(a).to(dev) for a in (frames, boxes, labels)]
        loss = float(R.reid_train_step(p, st, *b, lr=lr))
        res[dev] = (loss, {k: v.cpu().numpy() for k, v in p.items()},
                    {k: v.cpu().numpy() for k, v in st["mu"].items()}, p,
                    st, b)
    card, cpu = res[TRAIN_DEVICE], res["cpu"]
    lerr = abs(card[0] - cpu[0]) / abs(cpu[0])
    merr = perr = 0.0
    for k, mu in cpu[2].items():
        scale = np.abs(mu).max() + 1e-12
        merr = max(merr, float(np.abs(card[2][k] - mu).max() / scale))
        diff = np.abs(card[1][k] - cpu[1][k])
        if diff.max() > 2 * lr + 1e-6:
            fail(f"[train] re-id: {k} moved {diff.max()} apart")
        sure = np.abs(mu) > 1e-3 * scale
        perr = max(perr, float(diff[sure].max()) if sure.any() else 0.0)
    if lerr > TRAIN_LOSS_RTOL or merr > 1e-3 or perr > TRAIN_PARAM_ATOL:
        fail(f"[train] re-id: card vs CPU loss {lerr}, moment {merr}, "
             f"params {perr}")
    _, _, _, p, st, b = card
    losses = [float(R.reid_train_step(p, st, *b, lr=lr)) for _ in range(10)]
    if not losses[-1] < losses[0]:
        fail(f"[train] re-id: triplet loss over 10 steps {losses}")
    syncs = count_syncs(lambda: R.reid_train_step(p, st, *b, lr=lr))
    torch.cuda.reset_peak_memory_stats()
    times = step_times(lambda: R.reid_train_step(p, st, *b, lr=lr))
    med = float(np.median(times))
    return {"parity": {"loss_rel": lerr, "moment_rel": merr,
                       "param_abs": perr},
            "losses": losses, "step_ms": med, "step_ms_min": min(times),
            "step_ms_max": max(times), "batch": len(labels),
            "images_per_s": len(labels) / med * 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "host_syncs_per_step": syncs, "tf32": False}


def train_phase(card: str, tmp: Path) -> dict:
    """``[train] <family>``: parity, a falling loss and timings for every
    family the trainer serves; the kernels' counts stay 0 throughout but
    RT-DETR-L's: K5 once a step (its matcher, which reads nothing back to
    the host), K7 once a decoder layer forward and K8 once a layer
    backward."""
    import torch
    from roadvision_tpu_torch import kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    kernels.reset_launch_counts()
    out = {}
    for name, fam in train_families(tmp).items():
        t0 = time.perf_counter()
        par = train_parity(name, *fam[:2], fam[2], fam[4], *fam[5:])
        res = train_timed(name, *fam[:2], fam[2], fam[3], *fam[5:])
        res["parity"] = par
        out[name] = res
        if res["auction_reads_per_step"] != 0:
            fail(f"[train] {name}: {res['auction_reads_per_step']} auction "
                 f"reads in a step on the card")
        torch.cuda.empty_cache()
        parts = {k: round(v, 2) for k, v in res["parts_ms"].items()}
        print(f"[train] {name}: card = CPU within rel {TRAIN_LOSS_RTOL} / "
              f"params {TRAIN_PARAM_ATOL} (worst {json.dumps(par['rel_err'])}"
              f"); loss {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f} "
              f"over {TRAIN_STEPS} steps at {res['imgsz']}x{res['imgsz']} "
              f"x {res['batch']}; step {res['step_ms']:.2f} ms "
              f"[{res['step_ms_min']:.2f}-{res['step_ms_max']:.2f}], parts "
              f"{json.dumps(parts)}, {res['images_per_s']:.1f} images/s, peak "
              f"{res['peak_mem_bytes'] / 2**30:.2f} GiB, host syncs a step "
              f"{res['host_syncs_per_step']} (auction reads "
              f"{res['auction_reads_per_step']}), TF32 off; "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    res = train_reid_phase()
    out["re-id"] = res
    print(f"[train] re-id: card = CPU ({json.dumps(res['parity'])}"
          f"); triplet {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}; "
          f"step {res['step_ms']:.2f} ms [{res['step_ms_min']:.2f}-"
          f"{res['step_ms_max']:.2f}], {res['images_per_s']:.1f} crops/s, "
          f"host syncs a step {res['host_syncs_per_step']} ({card})",
          flush=True)
    # RT-DETR-L's card steps: one K5 launch each (its matcher), one K7
    # launch a decoder layer forward and one K8 launch a layer backward
    counts = exact_launches("[train]", {
        "assoc_auction": RTDETR_CARD_STEPS,
        "deform_sample": RTDETR_LAYERS * RTDETR_CARD_STEPS,
        "deform_sample_bwd": RTDETR_LAYERS * RTDETR_CARD_STEPS})
    print(f"[train] kernels launched across training: {counts}", flush=True)
    out["launches"] = counts
    return out


def entry_train(tmp: Path, card: str) -> dict:
    """``[entry] train``: ``cli.train`` at 640 × 16 for 20 steps with
    ``--eval-every 10 --save-every 10``, ``--resume`` to step 30, a
    ``--fog 0.5`` run, ``train_reid``; the kernels launch 0 times. Then
    the ``.weights.npz`` serves one 1080p batch in a ``PipelineEngine``
    (one launch of each kernel)."""
    import torch
    from roadvision_tpu_torch import cli, kernels
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.runtime.checkpoint import load_train_state
    from roadvision_tpu_torch.tools import train_reid
    out = tmp / "train" / "run.npz"
    # lr 1e-4: the asset, trained at 256², keeps detecting after 30 steps
    common = ["--data", "synthetic", "--imgsz", TRAIN_ENTRY[0], "--batch",
              TRAIN_ENTRY[1], "--lr", "1e-4",
              "--weights", str(Path(__file__).resolve().parent / "assets"
                               / "yolov8n_synthetic_256.npz")]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if cli.train(common + ["--steps", "20", "--eval-every", "10",
                           "--eval-size", "16", "--save-every", "10",
                           "--out", str(out)]) != 0:
        fail("[entry] train: the 20-step run returned non-zero")
    t_run = time.perf_counter() - t0
    if load_train_state(out)[2] != 20:
        fail("[entry] train: the saved state is not at step 20")
    resumed = tmp / "train" / "resumed.npz"
    if cli.train(common + ["--steps", "10", "--resume", str(out), "--out",
                           str(resumed)]) != 0:
        fail("[entry] train: --resume returned non-zero")
    step = load_train_state(resumed)[2]
    if step != 30:
        fail(f"[entry] train: --resume ended at step {step}, not 30")
    t1 = time.perf_counter()
    if cli.train(common + ["--steps", "3", "--fog", "0.5", "--out",
                           str(tmp / "train" / "fog.npz")]) != 0:
        fail("[entry] train: the --fog 0.5 run returned non-zero")
    t_fog = time.perf_counter() - t1
    if train_reid.main(["--steps", "20", "--out",
                        str(tmp / "train" / "reid.npz")]) != 0:
        fail("[entry] train_reid returned non-zero")
    # the mAP eval at steps 10 and 20: one detector call (one NMS) an
    # image of the 16 held out; no chain, no tracker
    counts = exact_launches("[entry] train", {"nms_keep": 2 * 16})
    weights = str(resumed.with_suffix(".weights.npz"))
    with PathLaunches("[entry] train serve") as pl:
        engine = PipelineEngine(pipeline_cfg(weights), device="cuda")
        frames, ts = render_batches(1, seed=5)[0]
        res = engine.process_batch(frames, ts)
        torch.cuda.synchronize()
        serve_counts = pl.check(1 + warm(1), tracked())
    dets = sum(len(r.detections) for r in res)
    for r in res:
        for d in r.detections:
            if not all(np.isfinite(v) for v in (d.x1, d.y1, d.x2, d.y2,
                                                 d.conf)):
                fail("[entry] train: non-finite detection")
    print(f"[entry] train: cli.train 20 steps at {TRAIN_ENTRY[0]}² x "
          f"{TRAIN_ENTRY[1]} with eval and save every 10 in {t_run:.1f} s, "
          f"--resume to step {step}, --fog 0.5 3 steps in {t_fog:.1f} s, train_reid 20 steps; launches "
          f"{counts}; the .weights.npz served one 1080p batch of {BATCH} in "
          f"a PipelineEngine: {dets} detections, launches {serve_counts} "
          f"({card})", flush=True)
    return {"run_s": t_run, "fog_s": t_fog, "resumed_step": step,
            "launches": counts, "serve_launches": serve_counts,
            "serve_detections": dets}


# ----------------------------------------------------------------------
# multi-card parallelism (roadvision_tpu_torch/parallel): no hand-written
# kernel on these paths (the dry run's fleet runs the config defaults,
# whose preprocess is off, as JAX's dry run does)

PAR_LOSS_RTOL = 1e-5               # dp x tp step against one replica, as
PAR_RTOL, PAR_ATOL = 2e-4, 2e-6    # the tests: parameters
# the optimiser state (after one step the clipped gradient) per leaf, of
# its largest value, as [train]'s card-against-CPU momentum: at 640² x 64
# one card's batch sum and four replicas' partial sums leave cancelling
# elements 2.7e-4 of their leaf's largest apart
PAR_STATE_RTOL = 1e-3
# pipelines and row bands against the plain forward on the same card in
# float32, TF32 off: cuDNN may pick another algorithm for a microbatch's
# or a band's shape, so the card holds them looser than the CPU tests
# (1e-3 px, 1e-6): YOLOv8n boxes in px, scores; RT-DETR-L boxes in
# normalised units (1e-4 is 0.064 px at 640: the same queries), and its
# scores 1e-3 (six decoder layers of attention amplify the reassociation;
# the card-against-CPU phases hold them to 2e-3)
PAR_BOX_ATOL, PAR_SCORE_ATOL = 1e-2, 1e-4
PAR_RT_BOX_ATOL, PAR_RT_SCORE_ATOL = 1e-4, 1e-3
PAR_TIMED = 8
PAR_CARD = 16                      # v8n training images per replica (640²)
SP_FRAME = (2160, 3840)            # one 4K frame, letterboxed to 2176 rows
PAR_DEVICE = "cuda:0"


def sync_all() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def call_ms(fn, n: int = PAR_TIMED) -> dict:
    """Host ms of ``n`` calls of ``fn`` after one warm call, every card
    synchronised around each: median, min, max."""
    fn()
    times = []
    for _ in range(n):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(times)), "min": min(times),
            "max": max(times)}


def _fmt_ms(t: dict) -> str:
    return f"{t['median']:.2f} ms [{t['min']:.2f}-{t['max']:.2f}]"


def _flat_named(named) -> dict:
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.parallel import merge_shards
    return W.flatten_tree(W.tree_from_state_dict(merge_shards(named)))


def _excess(got: np.ndarray, want: np.ndarray) -> float:
    """max |got − want| / (PAR_ATOL + PAR_RTOL · |want|): ≤ 1 passes."""
    return float((np.abs(got - want)
                  / (PAR_ATOL + PAR_RTOL * np.abs(want))).max())


def _leaf_excess(got: np.ndarray, want: np.ndarray) -> float:
    """max |got − want| / (PAR_ATOL + PAR_STATE_RTOL · max |want|): the
    leaf's largest value sets the scale, as for a sum whose terms
    cancel."""
    return float(np.abs(got - want).max()
                 / (PAR_ATOL + PAR_STATE_RTOL * np.abs(want).max()))


def dp_parity(name, tree, make_step, batch, mesh, adamw_lr=None) -> dict:
    """One step of ``DataParallelStep`` over ``mesh`` against the family's
    single-device step from the same tree and batch on the mesh's first
    device: loss and components within PAR_LOSS_RTOL, ``num_fg`` equal,
    the gradient norm within PAR_RTOL (as the gradients: RT-DETR's
    deformable sampling adds its gradients by atomics, in no fixed
    order), every parameter within PAR_RTOL / PAR_ATOL, every
    optimiser-state element within PAR_ATOL + PAR_STATE_RTOL × its
    leaf's largest value.
    AdamW's first step is ≈ lr · sign g: a parameter whose first moment
    is under 1e-3 of its leaf's largest + 1e-6 (float noise, or near
    AdamW's ε) is held to 2 · lr, as tests/test_torch_rtdetr_train.py
    holds it.
    The replicas must be identical after the step."""
    import torch
    from roadvision_tpu_torch.parallel import DataParallelStep
    dev = mesh.grid[0][0]
    step = make_step()
    single = _model(tree, dev)
    state = step.init(single)
    loss, aux = step(single, state, *batch)
    dp = DataParallelStep(step, _model(tree, dev), mesh)
    dloss, daux = dp(*batch)
    worst = {"loss": abs(float(dloss) - float(loss)) / abs(float(loss))}
    for k, v in aux.items():
        if k in ("num_fg", "ok"):
            if float(daux[k]) != float(v):
                fail(f"[parallel] {name}: {k} {float(daux[k])} against "
                     f"{float(v)} on one replica")
        else:
            worst[k] = abs(float(daux[k]) - float(v)) / max(abs(float(v)),
                                                            1e-12)
    moment = (lambda st: st["m"]) if adamw_lr else (lambda st: st)
    want_m, got_m = _flat_named(moment(state)), _flat_named(moment(dp.state))
    want_p = _flat_named(single.state_dict())
    got_p = _flat_named(dp.model.state_dict())
    state = {k: _leaf_excess(got_m[k], want_m[k]) for k in want_m}
    worst["state_leaf"] = max(state, key=state.get)
    worst["state_excess"] = state[worst["state_leaf"]]
    worst["param_excess"] = 0.0
    for k in want_p:
        diff_ok = np.ones(want_p[k].shape, bool)
        if adamw_lr:
            m = np.abs(want_m[k])
            diff_ok = m > 1e-3 * m.max() + 1e-6
            if np.abs(got_p[k] - want_p[k]).max() > 2 * adamw_lr + 1e-6:
                fail(f"[parallel] {name}: {k} moved apart")
        if diff_ok.any():
            worst["param_excess"] = max(worst["param_excess"], _excess(
                got_p[k][diff_ok], want_p[k][diff_ok]))
    same = all(torch.equal(a, b.to(a.device)) for others in dp.params[1:]
               for a, b in zip(dp.params[0], others))
    rel = max(v for k, v in worst.items() if k not in (
        "grad_norm", "state_leaf", "state_excess", "param_excess"))
    if rel > PAR_LOSS_RTOL or worst["grad_norm"] > PAR_RTOL \
            or worst["state_excess"] > 1 \
            or worst["param_excess"] > 1 or not same \
            or not np.isfinite(float(dloss)):
        fail(f"[parallel] {name}: dp {mesh.shape} against one replica "
             f"{worst}, replicas identical {same}")
    return {"mesh": dict(mesh.shape), "loss": float(dloss),
            "num_fg": float(daux["num_fg"]), "worst": worst}


def dp_timed(tree, devices, per_card: int = PAR_CARD) -> dict:
    """v8n at 640² × ``per_card`` images per replica, one replica per
    entry of ``devices``, float32 TF32 off: PAR_TIMED warm steps on one
    device-resident batch (median, min, max), images/s, peak memory per
    card, host syncs a step."""
    import torch
    from roadvision_tpu_torch.detect import dataset as ds
    from roadvision_tpu_torch.models.yolo import train as T
    from roadvision_tpu_torch.parallel import DataParallelStep, make_mesh
    n = len(devices)
    batch = _on(next(ds.synthetic_batches(per_card * n, imgsz=640,
                                          seed=2)), devices[0])
    dp = DataParallelStep(T.make_train_step(lr=1e-3),
                          _model(tree, devices[0]),
                          make_mesh(devices=devices))
    dp(*batch)
    cards = sorted({d.index for d in devices})
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    syncs = count_syncs(lambda: dp(*batch))
    ms = call_ms(lambda: dp(*batch))
    return {"replicas": n, "cards": len(cards), "batch": per_card * n,
            "step_ms": ms, "images_per_s": per_card * n / ms["median"] * 1e3,
            "peak_mem_gib": {str(i): torch.cuda.max_memory_allocated(i)
                             / 2 ** 30 for i in cards},
            "host_syncs_per_step": syncs}


def _out_err(got, want) -> tuple:
    return tuple(float((a.float() - b.float().to(a.device)).abs().max())
                 for a, b in zip(got, want))


def pipeline_inputs() -> tuple:
    """1080p synthetic road frames: letterboxed to 384 × 640 × 8 for
    YOLOv8n, stretched to 640² × 8 for RT-DETR-L (float [0, 1] on card
    0); one 4K frame letterboxed to 2176 × 3840 for the row bands."""
    import torch
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    from roadvision_tpu_torch.ops.letterbox import (letterbox_rect_u8,
                                                    resize_stretch_u8)
    frames = torch.from_numpy(render_batches(1, seed=4)[0][0]).to(PAR_DEVICE)
    src = SyntheticRoadSource(SP_FRAME[1], SP_FRAME[0], num_vehicles=12,
                              seed=4)
    big = torch.from_numpy(src.render(0)[None]).to(PAR_DEVICE)
    return (letterbox_rect_u8(frames, 640)[0].contiguous(),
            resize_stretch_u8(frames, 640).contiguous(),
            letterbox_rect_u8(big, max(SP_FRAME))[0].contiguous())


def forward_paths(devices, label: str) -> dict:
    """PipelinedYOLO and PipelinedRTDETR at 2 and len(devices) ≤ 4 stages
    and the row-sharded v8n forward over ``devices`` (one card repeated,
    or distinct cards): float32 (TF32 off) against the plain forward on
    the first card within PAR_BOX_ATOL / PAR_SCORE_ATOL, then bfloat16
    timed against the plain bfloat16 forward (median [min–max] of
    PAR_TIMED calls), host syncs a call. The 224- and 256-row edge cases
    of the bands run over 8 entries of ``devices`` repeated."""
    import torch
    from roadvision_tpu_torch.models import rtdetr
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.parallel import (PipelinedRTDETR,
                                               PipelinedYOLO, make_mesh,
                                               make_spatial_forward,
                                               spatial_sharding)
    from roadvision_tpu_torch.parallel.pipeline import v8_detect_model
    assets = Path(__file__).resolve().parent / "assets"
    v8 = W.import_npz(assets / "yolov8n_synthetic_256.npz")
    rt = W.import_npz(assets / "rtdetr_l_synthetic_256.npz")
    nc_rt = rtdetr.nc_of(rt)
    home = devices[0]
    x_pp, x_rt, x_sp = (t.to(home) for t in pipeline_inputs())
    out = {}
    bf = torch.bfloat16

    def plain_rt(dtype):
        m = rtdetr.model_from_params(rt).set_compute_dtype(dtype)
        m = m.to(home).eval()
        return lambda x: m(x, num_queries=rtdetr.NQ)

    kinds = {
        "yolo": (lambda n, dt: PipelinedYOLO(v8, "n", 80, n, devices,
                                             dtype=dt),
                 lambda dt: v8_detect_model(v8, "n", 80, dt).to(home), x_pp,
                 (PAR_BOX_ATOL, PAR_SCORE_ATOL)),
        "rtdetr": (lambda n, dt: PipelinedRTDETR(rt, nc_rt, n, devices,
                                                 dtype=dt),
                   plain_rt, x_rt, (PAR_RT_BOX_ATOL, PAR_RT_SCORE_ATOL)),
    }
    stages = sorted({2, min(4, len(devices))})
    deform = 0                      # K7 launches of the RT-DETR forwards
    with torch.inference_mode():
        for kind, (make, plain, x, tol) in kinds.items():
            is_rt = kind == "rtdetr"
            want = plain(torch.float32)(x)
            plain16 = plain(bf)
            row = {"plain_bf16_ms": call_ms(lambda: plain16(x))}
            # the float32 forward, then call_ms's warm and timed calls
            deform += is_rt * RTDETR_LAYERS * (2 + PAR_TIMED)
            for n in stages:
                err = _out_err(make(n, torch.float32)(x), want)
                if err[0] > tol[0] or err[1] > tol[1] \
                        or not np.isfinite(err).all():
                    fail(f"[parallel] {label} {kind} pipeline, {n} stages: "
                         f"max |Δ| boxes {err[0]}, scores {err[1]}")
                pipe = make(n, bf)
                # a decoder a microbatch: the float32 call, call_ms's and
                # count_syncs' calls
                micro = x.shape[0] // pipe._pick_microbatch(x.shape[0])
                deform += is_rt * RTDETR_LAYERS * micro * (3 + PAR_TIMED)
                row[n] = {"max_err": err, "groups": [list(g) for g in
                                                     pipe.groups],
                          "bf16_ms": call_ms(lambda: pipe(x)),
                          "host_syncs": count_syncs(lambda: pipe(x))}
                print(f"[parallel] {label} {kind} pipeline, {n} stages "
                      f"{row[n]['groups']} at {tuple(x.shape)}: float32 "
                      f"= plain (max |Δ| boxes {err[0]:.2e}, scores "
                      f"{err[1]:.2e}); bfloat16 "
                      f"{_fmt_ms(row[n]['bf16_ms'])} against plain "
                      f"{_fmt_ms(row['plain_bf16_ms'])}, "
                      f"{x.shape[0] / row[n]['bf16_ms']['median'] * 1e3:.1f}"
                      f" frames/s, host syncs a call "
                      f"{row[n]['host_syncs']}", flush=True)
            out[kind] = row
        # the row bands: one 4K frame over min(4, n) devices
        k = min(4, len(devices))
        mesh = make_mesh(devices=devices[:k])
        plain32 = v8_detect_model(v8, "n", 80, torch.float32).to(home)
        err = _out_err(make_spatial_forward("n", 80, mesh)(v8, x_sp),
                       plain32(x_sp))
        if err[0] > PAR_BOX_ATOL or err[1] > PAR_SCORE_ATOL:
            fail(f"[parallel] {label} row bands: max |Δ| {err}")
        edges = {}
        for h, w in ((224, 160), (256, 192)):
            xe = x_sp[:, :h, :w].contiguous()
            emesh = make_mesh(devices=(devices * 8)[:8])
            eerr = _out_err(make_spatial_forward("n", 80, emesh)(v8, xe),
                            plain32(xe))
            bands = spatial_sharding(emesh, xe)
            if eerr[0] > PAR_BOX_ATOL or eerr[1] > PAR_SCORE_ATOL \
                    or len(bands.parts) != h // 32:
                fail(f"[parallel] {label} bands {h}x{w}: {eerr}, "
                     f"{len(bands.parts)} bands")
            edges[f"{h}x{w}"] = {"bands": len(bands.parts),
                                 "max_err": eerr}
        out["deform_launches"] = deform
        run16 = make_spatial_forward("n", 80, mesh, dtype=bf)
        plain16 = v8_detect_model(v8, "n", 80, bf).to(home)
        out["spatial"] = {
            "bands": k, "frame": list(x_sp.shape[1:3]), "max_err": err,
            "edges": edges, "bf16_ms": call_ms(lambda: run16(v8, x_sp)),
            "plain_bf16_ms": call_ms(lambda: plain16(x_sp)),
            "host_syncs": count_syncs(lambda: run16(v8, x_sp))}
    sp = out["spatial"]
    print(f"[parallel] {label} row bands: one {sp['frame'][0]}x"
          f"{sp['frame'][1]} frame over {k} bands: float32 = plain (max "
          f"|Δ| boxes {err[0]:.2e}, scores {err[1]:.2e}); 224x160 over 7 "
          f"bands and 256x192 over 8 = plain ({edges}); bfloat16 "
          f"{_fmt_ms(sp['bf16_ms'])} against plain "
          f"{_fmt_ms(sp['plain_bf16_ms'])}, host syncs a call "
          f"{sp['host_syncs']}", flush=True)
    return out


def busy_overlap(fn, trace: Optional[Path] = None) -> dict:
    """torch.profiler over ``fn()``: each card's busy ms (the union of its
    kernels' and copies' intervals), the ms during which two cards or
    more were busy at once, and the wall ms; the timeline to ``trace``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync_all()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync_all()
    wall = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end, e.device_index)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    if not spans:
        return {"device_events": 0, "wall_ms": wall}
    edges = sorted([(a, 1, d) for a, _, d in spans]
                   + [(b, -1, d) for _, b, d in spans])
    open_by: dict = {}
    busy: dict = {}
    both = 0.0
    last = edges[0][0]
    for t, step, d in edges:
        live = [k for k, v in open_by.items() if v > 0]
        for k in live:
            busy[k] = busy.get(k, 0.0) + (t - last)
        if len(live) >= 2:
            both += t - last
        open_by[d] = open_by.get(d, 0) + step
        last = t
    return {"device_events": len(spans), "wall_ms": wall,
            "busy_ms": {str(k): v / 1e3 for k, v in sorted(busy.items())},
            "two_or_more_busy_ms": both / 1e3}


def parallel_phase(card: str) -> dict:
    """``[parallel]`` on one card, over lists that repeat cuda:0: the dp ×
    tp step ({data: 4, model: 2}) for v8n and RT-DETR-L at the dry run's
    shapes (64² × 8) against one replica; v8n, YOLO11n and v5n at 640² ×
    16 a replica, dp 2 against dp 1 (v8n's timed); the pipelines, the row bands and their edge
    cases (``forward_paths``); then ``dryrun_multicard([cuda:0] * 8)``.
    The kernels' counts are the dry run's fleet's (the config defaults,
    whose preprocess is off, as the JAX dry run's), K7's of the serving
    forwards and, for each RT-DETR objective (the single step, then a
    data replica each of the dp × tp step and of the dry run's), K5 once
    and K7 and K8 once a decoder layer."""
    import torch
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.detect import dataset as ds
    from roadvision_tpu_torch.models import rtdetr
    from roadvision_tpu_torch.models import rtdetr_train as RT
    from roadvision_tpu_torch.models.yolo import train as T
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.parallel import dryrun_multicard, make_mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    assets = Path(__file__).resolve().parent / "assets"
    v8 = W.import_npz(assets / "yolov8n_synthetic_256.npz")
    rt = W.import_npz(assets / "rtdetr_l_synthetic_256.npz")
    one = [torch.device(PAR_DEVICE)]
    kernels.reset_launch_counts()
    out = {}
    t0 = time.perf_counter()
    mesh = make_mesh(model_parallel=2, devices=one * 8)
    imgs, *gts = _on(next(ds.synthetic_batches(8, imgsz=64, seed=1)), one[0])
    out["dp_tp v8n"] = dp_parity(
        "v8n", v8, lambda: T.make_train_step(lr=1e-3), (imgs, *gts), mesh)
    gts[1] = gts[1].clamp(max=rtdetr.nc_of(rt) - 1)
    out["dp_tp rtdetr-l"] = dp_parity(
        "rtdetr-l", rt, lambda: RT.make_train_step_rtdetr(lr=1e-4),
        (imgs, *gts), mesh, adamw_lr=1e-4)
    for name in ("dp_tp v8n", "dp_tp rtdetr-l"):
        r = out[name]
        print(f"[parallel] {name} {r['mesh']} over cuda:0 x 8, 64² x 8: "
              f"one step = one replica's (loss {r['loss']:.4f}, num_fg "
              f"{r['num_fg']:.0f}; worst {json.dumps(r['worst'])}; "
              f"replicas identical) ({card})", flush=True)
    batch = _on(next(ds.synthetic_batches(2 * PAR_CARD, imgsz=640,
                                          seed=3)), one[0])
    out["dp2 v8n 640"] = dp_parity(
        "v8n 640", v8, lambda: T.make_train_step(lr=1e-3), batch,
        make_mesh(devices=one * 2))
    # YOLO11n and v5n through the same step: their normalisers differ
    from roadvision_tpu_torch.models.yolo.train_v5 import detection_loss_v5
    for name, tree, loss in (
            ("yolo11n", W.tree_from_model(W.random_model(
                "11", "detect", "n", 80, seed=0)), T.detection_loss),
            ("v5n", W.import_npz(assets / "yolov5n_synthetic_256.npz"),
             detection_loss_v5)):
        r = out[f"dp2 {name} 640"] = dp_parity(
            f"{name} 640", tree,
            lambda loss=loss: T.make_train_step(loss, lr=1e-3), batch,
            make_mesh(devices=one * 2))
        print(f"[parallel] {name} 640² x {PAR_CARD} a replica, dp 2 over "
              f"cuda:0 x 2 = dp 1 on the same {2 * PAR_CARD} images (worst "
              f"{json.dumps(r['worst'])}) ({card})", flush=True)
    timed = {n: dp_timed(v8, one * n) for n in (1, 2)}
    out["dp timed"] = timed
    print(f"[parallel] v8n 640² x {PAR_CARD} a replica, dp 2 over cuda:0 "
          f"x 2 = dp 1 on the same {2 * PAR_CARD} images (worst "
          f"{json.dumps(out['dp2 v8n 640']['worst'])}); step "
          f"{_fmt_ms(timed[1]['step_ms'])} for dp 1, "
          f"{_fmt_ms(timed[2]['step_ms'])} for dp 2 on one card "
          f"({timed[1]['images_per_s']:.1f} / "
          f"{timed[2]['images_per_s']:.1f} images/s), peak "
          f"{timed[2]['peak_mem_gib']} GiB, host syncs a step "
          f"{timed[2]['host_syncs_per_step']} ({card})", flush=True)
    out.update(forward_paths(one * 4, "cuda:0 x 4"))
    dryrun_multicard(one * 8)
    torch.cuda.synchronize()
    # the dry run's two fleets, 8 groups of one 2-frame stream each on
    # cuda:0 (preprocess off): the plain one captures a graph a group
    # and steps once, the gated one steps three batches, the second
    # coasted (no NMS); training and the forwards run no NMS
    groups, frames = 8, 2
    want = tail_want(groups * (1 + warm(1) + 2),
                     groups * frames * (1 + warm(1) + 3))
    rt_objectives = 1 + 2 * mesh.shape["data"]
    want["assoc_auction"] = rt_objectives
    # K7: the serving forwards (forward_paths', then the dry run's 4-stage
    # RT-DETR pipeline over a batch of 2 (two microbatches) and its plain
    # forward) and every RT-DETR objective's training forward; K8 the
    # objectives' backward, once a decoder layer each
    want["deform_sample"] = out["deform_launches"] \
        + RTDETR_LAYERS * (2 + 1 + rt_objectives)
    want["deform_sample_bwd"] = RTDETR_LAYERS * rt_objectives
    counts = exact_launches("[parallel]", want)
    out["launches"] = counts
    print(f"[parallel] dryrun_multicard([cuda:0] x 8) passed; kernels "
          f"launched across the phase {counts}; phase "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return out


def multi_cards_phase(card: str, tmp: Path) -> dict:
    """``--multi-cards``: over 2 and (when visible) 4 distinct cards, the
    v8n step dp n against dp 1 on the same images (one step, as
    ``dp_parity``) and the dp × tp step at the dry run's shapes; the v8n
    dp step timed against one card (images/s, step ms, peak memory a
    card, host syncs); ``cli.train --dp n`` at 640² × 16 a card for 20
    steps with a save at 10, then ``--resume`` for 10 more; the
    pipelines and the row bands (``forward_paths``); then torch.profiler
    timelines of the dp step, the pipelines and the bands: how long two
    cards or more were busy at once (the 2-card pipeline's timeline to
    chiprun_out/pipeline_2cards_trace.json)."""
    import torch
    from roadvision_tpu_torch import cli
    from roadvision_tpu_torch.detect import dataset as ds
    from roadvision_tpu_torch.models.yolo import train as T
    from roadvision_tpu_torch.models.yolo import weights as W
    from roadvision_tpu_torch.parallel import (DataParallelStep,
                                               PipelinedYOLO, make_mesh,
                                               make_spatial_forward)
    from roadvision_tpu_torch.runtime.checkpoint import load_train_state
    visible = torch.cuda.device_count()
    if visible < 2:
        fail(f"--multi-cards: {visible} card(s) visible, needs 2 or more")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assets = Path(__file__).resolve().parent / "assets"
    v8 = W.import_npz(assets / "yolov8n_synthetic_256.npz")
    counts = [n for n in (2, 4) if n <= visible]
    cards = {n: [torch.device("cuda", i) for i in range(n)]
             for n in (1, *counts)}
    out = {"visible": visible, "dp": {1: dp_timed(v8, cards[1])}}
    for n in counts:
        devs = cards[n]
        batch = _on(next(ds.synthetic_batches(PAR_CARD * n, imgsz=640,
                                              seed=3)), devs[0])
        par = dp_parity(f"v8n 640 on {n} cards", v8,
                        lambda: T.make_train_step(lr=1e-3), batch,
                        make_mesh(devices=devs))
        small = _on(next(ds.synthetic_batches(8, imgsz=64, seed=1)), devs[0])
        par_tp = dp_parity(f"v8n dp x tp on {n} cards", v8,
                           lambda: T.make_train_step(lr=1e-3), small,
                           make_mesh(model_parallel=2, devices=devs * 2))
        print(f"[multi-cards] v8n dp {n} on {n} cards = dp 1 on the same "
              f"{PAR_CARD * n} images (worst {json.dumps(par['worst'])}); "
              f"dp x tp {par_tp['mesh']} over {n} cards x 2 = one replica "
              f"(worst {json.dumps(par_tp['worst'])}) ({card})", flush=True)
        out["dp"][n] = dp_timed(v8, devs)
        out["dp"][n]["parity"] = par
        out["dp"][n]["parity_tp"] = par_tp
        run = tmp / f"dp{n}.npz"
        common = ["--dp", str(n), "--data", "synthetic", "--imgsz", "640",
                  "--batch", str(PAR_CARD * n), "--lr", "1e-4", "--weights",
                  str(assets / "yolov8n_synthetic_256.npz")]
        t0 = time.perf_counter()
        if cli.train(common + ["--steps", "20", "--save-every", "10",
                               "--out", str(run)]) != 0:
            fail(f"--multi-cards: cli.train --dp {n} returned non-zero")
        t_run = time.perf_counter() - t0
        resumed = tmp / f"dp{n}_resumed.npz"
        if cli.train(common + ["--steps", "10", "--resume", str(run),
                               "--out", str(resumed)]) != 0 \
                or load_train_state(resumed)[2] != 30:
            fail(f"--multi-cards: --dp {n} --resume did not reach step 30")
        out["dp"][n]["cli_train_20_steps_s"] = t_run
        out[f"forward {n} cards"] = forward_paths(devs, f"{n} cards")
    for n in (1, *counts):
        r = out["dp"][n]
        print(f"[multi-cards] v8n dp {n} on {r['cards']} card(s), 640² x "
              f"{r['batch']}: step {_fmt_ms(r['step_ms'])}, "
              f"{r['images_per_s']:.1f} images/s "
              f"({r['images_per_s'] / out['dp'][1]['images_per_s']:.2f} x "
              f"one card), peak GiB a card {r['peak_mem_gib']}, host syncs "
              f"a step {r['host_syncs_per_step']}"
              + (f"; cli.train --dp {n} 20 steps with a save, then "
                 f"--resume to 30 (20 steps in "
                 f"{r['cli_train_20_steps_s']:.1f} s)" if n > 1 else "")
              + f" ({card})", flush=True)
    # timelines: do the cards work at the same time?
    x_pp, _, x_sp = pipeline_inputs()
    overlap = {}
    with torch.inference_mode():
        for n in counts:
            pipe = PipelinedYOLO(v8, "n", 80, n, cards[n],
                                 dtype=torch.bfloat16)
            pipe(x_pp)
            overlap[f"pipeline {n} cards"] = busy_overlap(
                lambda: pipe(x_pp), Path("chiprun_out")
                / "pipeline_2cards_trace.json" if n == 2 else None)
            bands = make_spatial_forward("n", 80, make_mesh(devices=cards[n]),
                                         dtype=torch.bfloat16)
            bands(v8, x_sp)
            overlap[f"bands {n} cards"] = busy_overlap(
                lambda: bands(v8, x_sp))
    for n in counts:
        batch = _on(next(ds.synthetic_batches(PAR_CARD * n, imgsz=640,
                                              seed=2)), cards[n][0])
        dp = DataParallelStep(T.make_train_step(lr=1e-3),
                              _model(v8, cards[n][0]),
                              make_mesh(devices=cards[n]))
        dp(*batch)
        overlap[f"dp step {n} cards"] = busy_overlap(lambda: dp(*batch))
    out["overlap"] = overlap
    for name, ov in overlap.items():
        print(f"[multi-cards] {name}, profiler timeline: two cards or more "
              f"busy at once {ov.get('two_or_more_busy_ms', 0.0):.2f} ms of "
              f"{ov['wall_ms']:.2f} ms wall; busy ms a card "
              f"{json.dumps(ov.get('busy_ms'))} ({card})", flush=True)
    return out


# ---------------------------------------------------------------------------
# the offline and auxiliary modules: native host ops, profiler, warm-up,
# calibration, quality tools, profilers, autotune
# ---------------------------------------------------------------------------

EVAL_FRAMES, EVAL_RES = 96, 256     # the eval tools' defaults
EVAL_CHECK = 32                     # frames of the by-stage CPU checks
FOG_LEVELS_MAX, FOG_SHARE_MAX = 2, 1e-3   # the fog bound (ROADMAP C)


def exact_launches(what: str, want: dict) -> dict:
    """The kernels' counts since the last reset must be ``want``
    exactly, every kernel (K1-K6; not named: 0)."""
    from roadvision_tpu_torch import kernels
    counts = dict(kernels.launch_counts)
    full = {k: int(want.get(k, 0)) for k in counts}
    if counts != full:
        launch_mismatch(f"{what}: launches {counts}, expected {full}")
    return add_to_totals(counts)


class numpy_pil_paths:
    """Inside: the overlay and canvas through numpy, JPEG through PIL
    (the callers' fallbacks), as where the native ops are unavailable."""

    def __enter__(self):
        from roadvision_tpu_torch.runtime import native
        from roadvision_tpu_torch.vis import draw
        self.saved = (draw._NATIVE, dict(native._libs))
        draw._NATIVE = False
        native._libs["jpegenc"] = False
        native._libs["jpegdec"] = False
        return self

    def __exit__(self, *exc):
        from roadvision_tpu_torch.runtime import native
        from roadvision_tpu_torch.vis import draw
        draw._NATIVE = self.saved[0]
        native._libs.clear()
        native._libs.update(self.saved[1])
        return False


def overlay_dets(n: int = 18, seed: int = 0):
    """Deterministic boxes with ids, distances and speeds on a 1080p frame."""
    from roadvision_tpu_torch.detect.types import Detection
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x, y = rng.uniform(-40, WIDTH - 60), rng.uniform(-40, HEIGHT - 60)
        w, h = rng.uniform(40, 400), rng.uniform(30, 260)
        out.append(Detection(x, y, x + w, y + h, float(rng.uniform(.3, 1)),
                             2, "car", track_id=i + 1,
                             distance_m=float(rng.uniform(5, 90)),
                             speed_kmh=float(rng.uniform(0, 120))))
    return out


def native_phase(frames: np.ndarray, card: str) -> dict:
    """``[native]``: build the C++ host ops and the libjpeg helpers from
    the sources, hold the overlay and the canvas to the numpy paths on a
    1080p frame, encode and decode a compare canvas, and time the host
    tail (overlay + canvas + JPEG) against numpy + PIL."""
    import io

    from PIL import Image
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.io_video.mjpeg_avi import decode_jpeg_bgr
    from roadvision_tpu_torch.io_video.writer import encode_jpeg_bgr
    from roadvision_tpu_torch.runtime import native
    from roadvision_tpu_torch.vis import draw
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if not native.available():
        fail(f"[native] host_ops did not build: "
             f"{native.build_errors.get('hostops')}")
    jpeg = bool(native.get_jpeg_lib()) and bool(native.get_jdec_lib())
    build_s = time.perf_counter() - t0
    print(f"[native] built in {build_s:.2f} s under {native.build_dir()}: "
          f"hostops {native.lib_path('hostops').name}", flush=True)
    if not jpeg:
        reason = "; ".join(f"{k}: {v}" for k, v in native.build_errors.items())
        print(f"[native] jpeg: unavailable ({reason})", flush=True)
    out = {"build_s": build_s, "jpeg": jpeg}

    raw = np.ascontiguousarray(frames[0])
    dets = overlay_dets()
    got, want = raw.copy(), raw.copy()
    draw.draw_detections(got, dets)
    with numpy_pil_paths():
        draw.draw_detections(want, dets)
    if not np.array_equal(got, want):
        fail("[native] the overlay differs from the numpy path")
    for layout in ("h", "v"):
        a = draw.make_canvas(raw, got, layout=layout, fps=30.0)
        with numpy_pil_paths():
            b = draw.make_canvas(raw, got, layout=layout, fps=30.0)
        if not np.array_equal(a, b):
            fail(f"[native] the {layout} canvas differs from the numpy path")
    canvas = draw.make_canvas(raw, got, fps=30.0)
    # the recorder's encode and the reader's decode: native libjpeg where
    # it built, else PIL (named in the line)
    enc = "native libjpeg" if jpeg else "PIL (jpeg unavailable)"
    data = encode_jpeg_bgr(canvas, 85)
    dec = decode_jpeg_bgr(data)
    if dec.shape != canvas.shape:
        fail(f"[native] the canvas decodes to {dec.shape}")
    if Image.open(io.BytesIO(data)).size != (canvas.shape[1],
                                             canvas.shape[0]):
        fail("[native] PIL cannot read the JPEG")
    mse = float(np.mean((dec.astype(np.float64) - canvas) ** 2))
    psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
    if psnr < 25.0:
        fail(f"[native] JPEG round trip at {psnr:.1f} dB")
    out.update(jpeg_bytes=len(data), psnr_db=psnr, jpeg_codec=enc)
    line = (f"[native] {canvas.shape[1]}x{canvas.shape[0]} canvas through "
            f"{enc}: JPEG {len(data) >> 10} KiB, round trip {psnr:.2f} dB")
    if jpeg:
        with numpy_pil_paths():
            data_pil = encode_jpeg_bgr(canvas, 85)
            dec_pil = decode_jpeg_bgr(data)
        dec_diff = int(np.abs(dec.astype(np.int16) - dec_pil).max())
        out.update(bytes_equal_pil=data == data_pil,
                   decode_max_diff_pil=dec_diff)
        line += (f"; bytes {'equal to' if data == data_pil else 'differ from'}"
                 f" PIL's; native decode against PIL's max diff {dec_diff}")
    print(line, flush=True)

    def tail(n: int) -> float:
        t = time.perf_counter()
        for i in range(n):
            proc = raw.copy()
            draw.draw_detections(proc, dets)
            encode_jpeg_bgr(draw.make_canvas(raw, proc, fps=30.0), 85)
        return n / (time.perf_counter() - t)

    n = 16
    fps_native, fps_pil = [], []
    tail(2)                                            # warm-up
    for _ in range(3):
        fps_native.append(tail(n))
        with numpy_pil_paths():
            fps_pil.append(tail(n))
    out.update(tail_fps_native=fps_native, tail_fps_numpy_pil=fps_pil,
               launches=exact_launches("[native]", {}))
    print(f"[native] host tail (overlay + 2x1080p canvas + JPEG q85), "
          f"{n} frames a run: native overlay and canvas + {enc} JPEG "
          f"{', '.join(f'{v:.1f}' for v in fps_native)} frames/s against "
          f"numpy + PIL {', '.join(f'{v:.1f}' for v in fps_pil)} ({card})",
          flush=True)
    return out


def entry_preview_profile(model: str, tmp: Path) -> dict:
    """``[entry] preview --profile``: 16 frames through the preview with a
    torch.profiler trace; the trace file must hold the card's kernels."""
    import yaml
    from roadvision_tpu_torch.tools import preview
    cfg_path = tmp / "preview_profile.yaml"
    cfg_path.write_text(yaml.safe_dump(serving_cfg(model)))
    trace_dir = tmp / "trace"
    n = 2 * BATCH
    with PathLaunches("[entry] preview --profile") as pl:
        rc = preview.main(["--config", str(cfg_path), "--max-frames", str(n),
                           "--no-show", "--profile", str(trace_dir)])
        counts = pl.check(n // BATCH + warm(1), tracked())
    files = sorted(trace_dir.glob("*.json"))
    if rc != 0 or len(files) != 1:
        fail(f"[entry] preview --profile: rc {rc}, trace files {files}")
    events = json.loads(files[0].read_text()).get("traceEvents", [])
    kern = [e for e in events if e.get("cat") == "kernel"]
    ours = sum(1 for e in kern if any(
        k in e.get("name", "") for k in ("clahe_tile_luts_kernel",
                                         "clahe_apply_kernel",
                                         "median3_kernel")))
    if not kern or ours < 3 * (n // BATCH):
        fail(f"[entry] preview --profile: the trace holds {len(kern)} "
             f"kernels, {ours} of them the port's")
    print(f"[entry] preview --profile: {n} frames, trace "
          f"{files[0].name} ({files[0].stat().st_size >> 10} KiB, "
          f"{len(events)} events, {len(kern)} kernels, {ours} of them "
          f"K1 / K2 / K3); launches {counts}", flush=True)
    return {"launches": counts, "trace_events": len(events),
            "trace_kernels": len(kern)}


def entry_warmup(model: str, tmp: Path) -> dict:
    """``[entry] warmup``: tools/warmup.py on the main config with the
    temporal gate on, at 1080p: per want_proc a full batch and a coasted
    one (the coast step runs the chain too), so 4 launches of each."""
    import yaml
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.tools import warmup
    cfg_path = tmp / "warmup.yaml"
    cfg_path.write_text(yaml.safe_dump(merge(serving_cfg(model), {
        "detect": {"temporal_gate": {"enable": True}}})))
    with PathLaunches("[entry] warmup") as pl:
        t0 = time.perf_counter()
        rc = warmup.main(["--config", str(cfg_path), "--res", str(HEIGHT),
                          "--batch", str(BATCH)])
        elapsed = time.perf_counter() - t0
        counts = pl.check(4, tail_want(2, 4 * BATCH))
    if rc != 0:
        fail(f"[entry] warmup: rc {rc}")
    print(f"[entry] warmup: 1 shape ({BATCH}, {HEIGHT}, {WIDTH}), want_proc "
          f"True and False, gate on, in {elapsed:.2f} s; launches {counts}",
          flush=True)
    return {"launches": counts, "seconds": elapsed}


def run_main(fn, argv) -> tuple:
    """(rc, stdout) of a tool's ``main(argv)``."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def entry_calibrate(tmp: Path) -> dict:
    """``[entry] calibrate`` and ``[entry] calibrate_gate``: on the card
    and on the CPU, the same report; no kernel."""
    import yaml
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.geometry import find_homography_dlt
    from roadvision_tpu_torch.tools import calibrate, calibrate_gate
    img4 = np.array([[0, HEIGHT], [WIDTH, HEIGHT], [0, 0.4 * HEIGHT],
                     [WIDTH, 0.4 * HEIGHT]], np.float64)
    H = find_homography_dlt(img4, np.array([[0, 0], [20, 0], [0, 120],
                                            [20, 120]], np.float64))
    rng = np.random.RandomState(0)
    pts = np.concatenate([img4, rng.uniform([0, 0.45 * HEIGHT],
                                            [WIDTH, HEIGHT], (4, 2))])

    def world(p):
        m = np.hstack([p, np.ones((len(p), 1))]) @ H.T
        return m[:, :2] / m[:, 2:]

    main_pts, check_pts = pts[:6], pts[6:]
    for name, p in (("points", main_pts), ("check", check_pts)):
        (tmp / f"{name}.yaml").write_text(yaml.safe_dump(
            {"image_points": p.tolist(), "world_points": world(p).tolist()}))
    argv = ["--points", str(tmp / "points.yaml"), "--check",
            str(tmp / "check.yaml"), "--max-error", "0.01"]
    kernels.reset_launch_counts()
    rc_g, out_g = run_main(calibrate.main, argv)
    rc_c, out_c = run_main(calibrate.main, argv + ["--device", "cpu"])
    if rc_g != 0 or rc_c != 0 or out_g != out_c:
        fail(f"[entry] calibrate: rc {rc_g} / {rc_c}, reports "
             f"{'equal' if out_g == out_c else 'differ'}:\n{out_g}")
    counts = exact_launches("[entry] calibrate", {})
    print(f"[entry] calibrate: 6 pairs + 2 held out, rc 0, card report "
          f"equals the CPU's; "
          + " ".join(line for line in out_g.splitlines()
                     if "error:" in line) + f"; launches {counts}",
          flush=True)
    argv = ["--json", "--frames", str(EVAL_FRAMES)]
    rc_g, out_g = run_main(calibrate_gate.main, argv)
    rc_c, out_c = run_main(calibrate_gate.main, argv + ["--device", "cpu"])
    if rc_g != 0 or rc_c != 0 or json.loads(out_g) != json.loads(out_c):
        fail(f"[entry] calibrate_gate: rc {rc_g} / {rc_c}:\n{out_g}\n{out_c}")
    counts_gate = exact_launches("[entry] calibrate_gate", {})
    rec = json.loads(out_g)["recommended"]
    print(f"[entry] calibrate_gate: {EVAL_FRAMES} clean frames, card JSON "
          f"equals the CPU's: {json.dumps(rec)}; launches {counts_gate}",
          flush=True)
    return {"calibrate": {"launches": counts},
            "calibrate_gate": {"launches": counts_gate, "recommended": rec}}


def compare_det_lists(cpu, gpu, what: str) -> float:
    """Per-frame Detection lists: counts, classes and ids equal, boxes
    within BOX_TOL, confidences within CONF_TOL. Returns the worst box
    error."""
    worst = 0.0
    if len(cpu) != len(gpu):
        fail(f"{what}: {len(gpu)} frames against {len(cpu)}")
    for fi, (a, b) in enumerate(zip(cpu, gpu)):
        if len(a) != len(b):
            fail(f"{what}: frame {fi}: {len(b)} detections against {len(a)}")
        for da, db in zip(a, b):
            box = max(abs(p - q) for p, q in zip(
                (da.x1, da.y1, da.x2, da.y2), (db.x1, db.y1, db.x2, db.y2)))
            worst = max(worst, box)
            if da.cls_id != db.cls_id or da.track_id != db.track_id \
                    or box > BOX_TOL or abs(da.conf - db.conf) > CONF_TOL:
                fail(f"{what}: frame {fi}: {db} against {da}")
    return worst


def eval_f32(cfg) -> dict:
    from roadvision_tpu_torch.config import merge
    return merge(cfg, {"tpu": {"compute_dtype": "float32"}})


def eval_weather_phase(out_dir: Path, card: str) -> dict:
    """``[eval] weather``: tools/eval_weather.py at its defaults on the card
    (JSON to chiprun_out/); then by stage against the CPU on the same
    inputs: heavy fog within the fog bound, and the detector + SORT in
    float32 within BOX_TOL / CONF_TOL with ids equal, chain off on the
    clean scene and on on the fogged one; the off row's scores equal."""
    from roadvision_tpu_torch.tools import eval_weather as ew
    n_batches = EVAL_FRAMES // 8
    levels, gated_modes = 6, 2          # the default levels; on + auto
    with PathLaunches("[eval] weather"):
        t0 = time.perf_counter()
        rc, text = run_main(ew.main, ["--out",
                                      str(out_dir / "eval_weather.json")])
        elapsed = time.perf_counter() - t0
        # a fresh engine a (level, mode): off, on and auto (the gate)
        # each capture their graph
        k = levels * (gated_modes * n_batches + warm(gated_modes))
        steps = levels * (3 * n_batches + warm(3))
        counts = exact_launches("[eval] weather", {
            "clahe_tile_luts": k, "clahe_apply": k,
            # auto: the impulse statistic's median too
            "median_k": k + levels * (n_batches + warm(1)),
            **tail_want(steps, steps * 8)})
    report = json.loads(text)
    if rc != 0 or len(report["levels"]) != levels:
        fail(f"[eval] weather: rc {rc}, levels {list(report['levels'])}")
    for level, entry in report["levels"].items():
        for mode, row in entry["modes"].items():
            if not all(math.isfinite(v) for v in row.values()):
                fail(f"[eval] weather: {level} / {mode}: {row}")
    frames, gt = ew.build_scene(EVAL_FRAMES, EVAL_RES, 6, 0)
    n_fog = 16
    t1 = time.perf_counter()
    fog_g = ew.fog_level(frames[:n_fog], "heavy", 0, "cuda")
    fog_c = ew.fog_level(frames[:n_fog], "heavy", 0, "cpu")
    diff = np.abs(fog_g.astype(np.int16) - fog_c)
    share = float((diff > 0).mean())
    if diff.max() > FOG_LEVELS_MAX or share > FOG_SHARE_MAX:
        fail(f"[eval] weather: fog card vs CPU max {diff.max()} levels in "
             f"{share:.2e} of the pixels")
    frames, gt = frames[:EVAL_CHECK], gt[:EVAL_CHECK]
    fog_check = ew.fog_level(frames, "heavy", 0, "cuda")
    rows = {}
    for mode, imgs in (("off", frames), ("on", fog_check)):
        cfg = eval_f32(ew.make_cfg(ew.DEMO_WEIGHTS, EVAL_RES, mode, 0.25,
                                   150.0, 8))
        with PathLaunches(f"[eval] weather {mode} f32"):
            d_g = ew.run_mode(cfg, imgs, "cuda")
            runs = EVAL_CHECK // 8 + warm(1)
            c = exact_launches(f"[eval] weather {mode} f32", {
                **{k: runs * (mode == "on") for k in PRE_KERNELS},
                **tail_want(runs, runs * 8)})
        d_c = ew.run_mode(cfg, imgs, "cpu")
        worst = compare_det_lists(d_c, d_g, f"[eval] weather {mode}")
        s_g, s_c = ew.score(d_g, gt), ew.score(d_c, gt)
        if s_g["false_positives"] != s_c["false_positives"] or (
                mode == "off" and s_g != s_c):
            fail(f"[eval] weather {mode}: scores {s_g} against {s_c}")
        rows[mode] = {"box_err": worst, "card": s_g, "cpu": s_c,
                      "launches": c}
    print(f"[eval] weather: {EVAL_FRAMES} frames at {EVAL_RES}, "
          f"{levels} levels x off / on / auto in {elapsed:.1f} s on the card "
          f"(chiprun_out/eval_weather.json); heavy fog card vs CPU max "
          f"{diff.max()} levels in {share:.2e} of the pixels ({n_fog} "
          f"frames); float32 off / on (heavy), {EVAL_CHECK} frames, within "
          f"{rows['off']['box_err']:.1e} / {rows['on']['box_err']:.1e} px, "
          f"ids equal, off-row scores equal: {json.dumps(rows['off']['card'])}; "
          f"CPU checks {time.perf_counter() - t1:.1f} s; launches {counts} "
          f"({card})", flush=True)
    return {"launches": counts, "seconds": elapsed, "fog_max_levels":
            int(diff.max()), "fog_share": share, "f32": rows,
            "report": report}


def eval_trackers_phase(out_dir: Path, card: str) -> dict:
    """``[eval] trackers``: tools/eval_trackers.py at its defaults on the
    card (six backends, clean and heavy fog); then sort on the clean
    scene and ocsort on the fogged one in float32 against the CPU."""
    from roadvision_tpu_torch.tools import eval_trackers as et
    from roadvision_tpu_torch.tools import eval_weather as ew
    n_batches = EVAL_FRAMES // 8
    with PathLaunches("[eval] trackers"):
        t0 = time.perf_counter()
        rc, text = run_main(et.main, ["--out",
                                      str(out_dir / "eval_trackers.json")])
        elapsed = time.perf_counter() - t0
        # six backends a scene, each backend's graph captured in each;
        # the chain runs on heavy_fog only
        per_frame = sum(ASSOC_PER_FRAME[b][0] for b in (
            "sort", "bytetrack", "ocsort", "deepsort", "botsort",
            "strongsort"))
        runs = 6 * (n_batches + warm(1))
        counts = exact_launches("[eval] trackers", {
            **{k: runs for k in PRE_KERNELS},
            **tail_want(2 * runs, 2 * 8 * per_frame * (n_batches
                                                       + warm(1)))})
    report = json.loads(text)
    if rc != 0 or any(len(r) != 6 for r in report["scenes"].values()):
        fail(f"[eval] trackers: rc {rc}")
    frames, gt = ew.build_scene(EVAL_CHECK, EVAL_RES, 6, 0)
    fog = ew.fog_level(frames, "heavy", 0, "cuda")
    checked = {}
    for backend, imgs, pre in (("sort", frames, False),
                               ("ocsort", fog, True)):
        cfg = eval_f32(et.make_cfg(ew.DEMO_WEIGHTS, EVAL_RES, backend,
                                   0.25, 8, pre))
        with PathLaunches(f"[eval] trackers {backend}"):
            d_g = ew.run_mode(cfg, imgs, "cuda")
            runs = EVAL_CHECK // 8 + warm(1)
            exact_launches(f"[eval] trackers {backend}", {
                **{k: runs * pre for k in PRE_KERNELS},
                **tail_want(runs, runs * 8, *ASSOC_PER_FRAME[backend])})
        d_c = ew.run_mode(cfg, imgs, "cpu")
        worst = compare_det_lists(d_c, d_g, f"[eval] trackers {backend}")
        s_g, s_c = ew.score(d_g, gt), ew.score(d_c, gt)
        if s_g["false_positives"] != s_c["false_positives"] or (
                not pre and s_g != s_c):
            fail(f"[eval] trackers {backend}: {s_g} against {s_c}")
        checked[backend] = {"box_err": worst, "card": s_g, "cpu": s_c}
    summary = {s: {b: [r["mota"], r["idf1"], r["id_switches"]]
                   for b, r in rows.items()}
               for s, rows in report["scenes"].items()}
    print(f"[eval] trackers: 6 backends x clean / heavy fog in "
          f"{elapsed:.1f} s on the card (chiprun_out/eval_trackers.json; "
          f"[MOTA, IDF1, IDsw]: {json.dumps(summary)}); float32 sort "
          f"(clean) and ocsort (heavy fog), {EVAL_CHECK} frames, equal the "
          f"CPU's ids within "
          f"{checked['sort']['box_err']:.1e} / "
          f"{checked['ocsort']['box_err']:.1e} px; launches {counts} "
          f"({card})", flush=True)
    return {"launches": counts, "seconds": elapsed, "f32": checked,
            "report": report}


def benchmark_trackers_phase(out_dir: Path, card: str) -> dict:
    """``[eval] benchmark_trackers``: the host scenario suite through every
    backend's step on the card and on the CPU: the same metrics."""
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.tools import benchmark_trackers as bt
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc, table = run_main(bt.main, ["--out", str(out_dir /
                                                "benchmark_trackers.json")])
    elapsed = time.perf_counter() - t0
    # every scenario frame through every backend's step, each calling
    # the association as often as it does a frame
    frames = sum(len(fn(np.random.default_rng(0)))
                 for fn in bt.SCENARIOS.values())
    counts = exact_launches("[eval] benchmark_trackers", {
        "assoc_greedy": frames * sum(ASSOC_PER_FRAME[b][0]
                                     for b in bt.BACKENDS)})
    cpu_out = out_dir / "benchmark_trackers_cpu.json"
    rc_c, table_c = run_main(bt.main, ["--device", "cpu", "--out",
                                       str(cpu_out)])
    got = json.loads((out_dir / "benchmark_trackers.json").read_text())
    want = json.loads(cpu_out.read_text())
    cpu_out.unlink()
    worst = 0.0
    for b, scen in want.items():
        for s, m in scen.items():
            for key, v in m.items():
                worst = max(worst, abs(float(got[b][s][key]) - float(v)))
    if rc != 0 or rc_c != 0 or table != table_c or worst > 1e-6:
        fail(f"[eval] benchmark_trackers: rc {rc} / {rc_c}, worst metric "
             f"gap {worst}:\n{table}\n{table_c}")
    print(f"[eval] benchmark_trackers: 6 backends x 6 scenarios on the card "
          f"in {elapsed:.1f} s, the CPU's table exactly (worst metric gap "
          f"{worst:.1e}):{table.rstrip()}\nlaunches {counts} ({card})",
          flush=True)
    return {"launches": counts, "seconds": elapsed, "results": got}


def dtype_ladder_phase(out_dir: Path, card: str) -> dict:
    """``[eval] dtype_ladder``: every dtype's accuracy on the card and its
    device-resident frames/s (``--fps``); the float32 and int8 rows
    against the CPU's (the pipeline's tolerances: mAP and recall 1e-3,
    matched confidence CONF_TOL)."""
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.tools import dtype_ladder as dl
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text = run_main(dl.main, ["--fps", "--fps-iters", "16", "--out",
                                  str(out_dir / "dtype_ladder.json")])
    elapsed = time.perf_counter() - t0
    # no chain; per dtype 64 frames in batches of 8, then --fps: 2
    # warm-up and 16 timed device-resident batches; float32 and
    # bfloat16 capture their graphs, int8 and int8-static run eagerly
    steps = 4 * (64 // 8 + 2 + 16) + warm(2)
    counts = exact_launches("[eval] dtype_ladder", tail_want(steps,
                                                             steps * 8))
    rc_c, text_c = run_main(dl.main, ["--device", "cpu", "--dtypes",
                                      "float32,int8,int8-static"])
    got, want = json.loads(text)["dtypes"], json.loads(text_c)["dtypes"]
    if rc != 0 or rc_c != 0:
        fail(f"[eval] dtype_ladder: rc {rc} / {rc_c}")
    for dt, row in want.items():
        g = got[dt]
        if abs(g["map50"] - row["map50"]) > 1e-3 \
                or abs(g["recall50"] - row["recall50"]) > 1e-3 \
                or abs(g["conf_matched_mean"] - row["conf_matched_mean"]) \
                > CONF_TOL:
            fail(f"[eval] dtype_ladder {dt}: card {g} against CPU {row}")
    print(f"[eval] dtype_ladder: {json.dumps(got)} in {elapsed:.1f} s "
          f"(chiprun_out/dtype_ladder.json); float32 / int8 / int8-static "
          f"rows equal the CPU's within the tolerances; launches {counts} "
          f"({card})", flush=True)
    return {"launches": counts, "seconds": elapsed, "dtypes": got}


def profile_phases(out_dir: Path, card: str) -> dict:
    """``[profile] rtdetr / detect / preprocess`` at 1080p x 8 (RT-DETR at
    its 720p default): each tool's ``run`` on the card, results to
    chiprun_out/; the preprocess tool's candidates equal to their plain
    versions, and its kernel lines launch K1 / K2 / K3 exactly as often
    as they were called."""
    from argparse import Namespace

    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.tools import (profile_detect, profile_preprocess,
                                            profile_rtdetr)
    out = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    inner, iters = 8, 2
    out["rtdetr"] = profile_rtdetr.run(Namespace(
        res=720, batch=BATCH, imgsz=640, dtype="bfloat16", inner=inner,
        iters=iters, weights="rtdetr-l.pt", device="cuda"))
    # K7: each timing runs iters x (inner warm + inner timed) calls, each
    # stage one more for its FLOPs: one layer's attention (1 launch a
    # call), the decoder and the full forward (RTDETR_LAYERS); then the
    # decoder on the K7 route (timed, and one profiled call) and one
    # layer's sampling alone on it; the plain routes launch none
    timed = iters * 2 * inner
    out["rtdetr"]["launches"] = exact_launches("[profile] rtdetr", {
        "deform_sample": (timed + 1) * (1 + 2 * RTDETR_LAYERS)
        + (timed + 1) * RTDETR_LAYERS + timed})
    out["rtdetr"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    out["detect"] = {"stages": profile_detect.run(Namespace(
        res=HEIGHT, batch=BATCH, iters=8, warmup=2, size="n",
        dtype="bfloat16", only="", device="cuda"))}
    # the nms and full stages: 2 warm-up, 8 timed calls and a probe each
    out["detect"]["launches"] = exact_launches("[profile] detect", {
        "nms_keep": 2 * (2 + 8 + 1)})
    out["detect"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    rows = profile_preprocess.run(Namespace(
        res=HEIGHT, batch=BATCH, iters=8, warmup=2, only="", device="cuda"))
    calls = {n: r["calls"] for n, r in rows.items()}
    want = {"clahe_tile_luts": calls["clahe: full (K1 + K2)"]
            + calls["clahe: hist+lut (K1)"],
            "clahe_apply": calls["clahe: full (K1 + K2)"]
            + calls["apply: K2 clahe_apply"],
            "median_k": calls["median3: K3 median_k"]}
    out["preprocess"] = {"rows": rows, "launches": exact_launches(
        "[profile] preprocess", want),
        "seconds": time.perf_counter() - t0}
    for name, res in out.items():
        (out_dir / f"profile_{name}.json").write_text(
            json.dumps(res, indent=1))
    print(f"[profile] rtdetr {out['rtdetr']['seconds']:.1f} s, detect "
          f"{out['detect']['seconds']:.1f} s, preprocess "
          f"{out['preprocess']['seconds']:.1f} s; every preprocess candidate "
          f"equals its plain version; launches rtdetr / detect / preprocess "
          f"{out['rtdetr']['launches']} / {out['detect']['launches']} / "
          f"{out['preprocess']['launches']} ({card})", flush=True)
    return out


def autotune_phase(out_dir: Path, card: str) -> dict:
    """``[autotune] --quick --sweeps clahe_chunk``: five bench processes on
    the card; each trial's preprocess batches launch K1 / K2 / K3 once,
    and the trials' launches join the totals."""
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.tools import autotune
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text = run_main(autotune.main, [
        "--quick", "--sweeps", "clahe_chunk", "--timeout", "300",
        "--out", str(out_dir / "autotune_quick.json")])
    elapsed = time.perf_counter() - t0
    exact_launches("[autotune] in-process", {})
    report = json.loads(text)
    sweep = report["sweeps"]["clahe_chunk"]
    trials = sweep["trials"]
    total = {k: 0 for k in PATH_TOTALS}
    for value, t in trials.items():
        # the preprocess mode: K1-K3 once a batch, no NMS, no tracker
        if t.get("fps") is None or t["launches_per_batch"] != {
                **{k: 1.0 for k in PRE_KERNELS},
                **{k: 0.0 for k in TAIL_KERNELS}}:
            fail(f"[autotune] clahe_chunk={value}: {t}")
        for k, v in t["launches_per_batch"].items():
            total[k] += int(round(v * t["batches"]))
    if rc != 0 or sweep["winner"] is None:
        fail(f"[autotune] rc {rc}, winner {sweep['winner']}")
    add_to_totals(total)
    print(f"[autotune] --quick --sweeps clahe_chunk in {elapsed:.1f} s: "
          + ", ".join(f"{v}: {t['fps']:.1f}" for v, t in trials.items())
          + f" frames/s (480p); winner {sweep['winner']} (pinned "
          f"{sweep['pinned']}; quick winners do not transfer); launches in "
          f"the trials {total} ({card})", flush=True)
    return {"launches": total, "seconds": elapsed, "sweep": sweep}


def tools_phases(model: str, frames: np.ndarray, card: str) -> dict:
    """Every phase of the offline and auxiliary modules, in order; results
    in chiprun_out/tools.json and the tools' own files beside it."""
    import torch
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    # float32 comparisons against the CPU: TF32 off, as on the main path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    res = {"native": native_phase(frames, card)}
    with tempfile.TemporaryDirectory() as tmp:
        res["preview --profile"] = entry_preview_profile(model, Path(tmp))
        res["warmup"] = entry_warmup(model, Path(tmp))
        res.update(entry_calibrate(Path(tmp)))
    res["eval weather"] = eval_weather_phase(out_dir, card)
    res["eval trackers"] = eval_trackers_phase(out_dir, card)
    res["eval benchmark_trackers"] = benchmark_trackers_phase(out_dir, card)
    res["eval dtype_ladder"] = dtype_ladder_phase(out_dir, card)
    res["profile"] = profile_phases(out_dir, card)
    res["autotune"] = autotune_phase(out_dir, card)
    res["seconds"] = time.perf_counter() - t0
    (out_dir / "tools.json").write_text(json.dumps(res, indent=1,
                                                   default=str))
    print(f"[tools] the offline and auxiliary phases ran "
          f"{res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# the host-free device step: the loops as kernels (K4-K6) and the step
# replayed from a CUDA graph

# scalar operations a round, per cell of the problem: K4 compares every
# cell in its row scan, its column scan and its clearing sweep; K5 every
# cell of the (D, T + D) values (the matcher's (M, NQ)) in the plain
# round: the price's subtraction, the best and the second best. The
# redesign skips most of that work (only bidders scan, only the live
# columns per bidder); the count stays the plain round's, so that × bound
# compares before and after
K4_OPS_PER_CELL = 3
K5_OPS_PER_CELL = 3
# the boxes modes (csrc/box_iou.cuh): an IoU is 4 min / max, 2 subtracts,
# 2 clamps, a multiply, an add, a subtract, a compare and a divide, and
# the threshold's compare; a box's area 5, x_to_bbox 11 more (K4), the
# class offset 5 more (K6); K6's walk 2 a kept candidate and word
IOU_OPS_PER_PAIR = 14
K4_OPS_PER_BOX = 16
K6_OPS_PER_BOX = 10
GRAPH_LAUNCHES = 50                # launches captured in one timing graph
GRAPH_BATCHES = 32                 # replayed batches held to eager ones
GRAPH_DEVICE = "cuda"
GRAPH_FPS_BATCHES = 16             # batches a timed window
FLEET_SIZES = (1, 2, 4, 8)


def road_scores(rng, p: int, t: int = 100, d: int = 100,
                tracks: int = 20, dets: int = 18):
    """IoU matrices as the main path makes them: ``tracks`` live slots of
    ``t`` predicted near ``dets`` valid detections of ``d`` (a road
    scene's 13-20 boxes a frame), the rest empty. → (iou (p, t, d),
    alive (p, t), dvalid (p, d)) on the CPU."""
    import torch
    from roadvision_tpu_torch.track.sort import iou_matrix
    xy = rng.uniform(0, 1800, (p, max(tracks, dets), 2))
    wh = rng.uniform(40, 200, (p, max(tracks, dets), 2))
    tb = np.zeros((p, t, 4), np.float32)
    db = np.zeros((p, d, 4), np.float32)
    tb[:, :tracks] = np.concatenate([xy, xy + wh], -1)[:, :tracks]
    dxy = xy[:, :dets] + rng.normal(0, 6, (p, dets, 2))
    db[:, :dets] = np.concatenate([dxy, dxy + wh[:, :dets]], -1)
    alive = np.zeros((p, t), bool)
    alive[:, :tracks] = True
    dvalid = np.zeros((p, d), bool)
    dvalid[:, :dets] = True
    iou = iou_matrix(torch.from_numpy(tb), torch.from_numpy(db)).numpy()
    return iou, alive, dvalid


def assoc_cases(rng):
    """K4 (matrix mode) / K5 cases: the (1 x 100 x 100) and the fleet's
    (8 x 100 x 100) road scores, then ties, every track and detection
    invalid, a long chain (one pair a round, 100 rounds), NaN scores,
    ragged sizes, and max_det = 300 (random, and a 300-round chain)."""
    cases = {"main 1x100x100": road_scores(rng, 1),
             "fleet 8x100x100": road_scores(rng, 8)}
    q = (rng.randint(0, 4, (4, 100, 100)) / 4.0).astype(np.float32)
    cases["ties 4x100x100"] = (q, rng.rand(4, 100) < 0.7,
                               rng.rand(4, 100) < 0.7)
    cases["invalid 2x100x100"] = (q[:2], np.zeros((2, 100), bool),
                                  np.zeros((2, 100), bool))
    i, j = np.indices((100, 100))
    chain = np.where(np.abs(i - j) <= 1,
                     0.99 - 0.009 * np.minimum(i, j) - 0.004 * (i != j),
                     0.0).astype(np.float32)
    cases["chain 1x100x100"] = (chain[None], np.ones((1, 100), bool),
                                np.ones((1, 100), bool))
    nan = road_scores(rng, 4)[0].copy()
    nan[rng.rand(*nan.shape) < 0.02] = np.nan
    cases["nan 4x100x100"] = (nan, np.ones((4, 100), bool),
                              np.ones((4, 100), bool))
    cases["ragged 3x7x130"] = (rng.rand(3, 7, 130).astype(np.float32),
                               rng.rand(3, 7) < 0.9, rng.rand(3, 130) < 0.9)
    # detect.max_det = 300 (T = D = 300): the scores outgrow shared
    # memory and K4's matrix mode reads them in place
    cases["max_det 2x300x300"] = (rng.rand(2, 300, 300).astype(np.float32),
                                  rng.rand(2, 300) < 0.8,
                                  rng.rand(2, 300) < 0.8)
    i, j = np.indices((300, 300))
    chain = np.where(np.abs(i - j) <= 1,
                     0.99 - 0.002 * np.minimum(i, j) - 0.0005 * (i != j),
                     0.0).astype(np.float32)
    cases["chain 1x300x300"] = (chain[None], np.ones((1, 300), bool),
                                np.ones((1, 300), bool))
    return cases


def nms_cases(rng):
    """K6 matrix-mode cases: the (8 x 300 x 300) overlaps of NMS's
    candidates at IoU 0.7, every candidate overlapping every other, none
    valid, a chain of neighbours, 600 candidates (TTA and tiling), 1024,
    33 (a ragged word), and the rotated NMS of obb (ProbIoU > 0.7 of
    class-offset rboxes, its only caller)."""
    import torch
    from roadvision_tpu_torch.ops.nms import iou_matrix_xyxy
    from roadvision_tpu_torch.ops.obb import probiou_matrix
    xy = rng.uniform(0, 600, (8, 300, 2))
    wh = rng.uniform(10, 80, (8, 300, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                             .astype(np.float32))
    over = (iou_matrix_xyxy(boxes) > 0.7).numpy()
    valid = rng.rand(8, 300) < 0.9
    i, j = np.indices((300, 300))
    rb = np.concatenate([rng.uniform(0, 400, (8, 300, 2)),
                         rng.uniform(8, 60, (8, 300, 2)),
                         rng.uniform(-1.5, 1.5, (8, 300, 1))], -1)
    rb[:, 150:] = rb[:, :150] + rng.normal(0, 1.5, (8, 150, 5)) \
        * [1, 1, 1, 1, 0.02]
    rb[..., :2] += rng.randint(0, 3, (8, 300, 1)) * 7680.0
    obb = (probiou_matrix(torch.from_numpy(rb.astype(np.float32))) > 0.7) \
        .numpy()
    return {"main 8x300x300": (over, valid),
            "all overlap 2x300x300": (np.ones((2, 300, 300), bool),
                                      np.ones((2, 300), bool)),
            "none valid 2x300x300": (over[:2], np.zeros((2, 300), bool)),
            "chain 2x300x300": (np.broadcast_to(np.abs(i - j) == 1,
                                                (2, 300, 300)).copy(),
                                np.ones((2, 300), bool)),
            "tta 2x600x600": (rng.rand(2, 600, 600) < 0.01,
                              rng.rand(2, 600) < 0.9),
            "1024 1x1024x1024": (rng.rand(1, 1024, 1024) < 0.003,
                                 rng.rand(1, 1024) < 0.9),
            "ragged 3x33x33": (rng.rand(3, 33, 33) < 0.1,
                               rng.rand(3, 33) < 0.9),
            "obb 8x300x300": (obb, valid)}


def road_tracks(rng, p: int, t: int = 100, d: int = 100, tracks: int = 20,
                dets: int = 18):
    """K4 boxes-mode inputs as the main path makes them: ``tracks`` live
    slots, spread over ``t``, whose Kalman means predict boxes near the
    ``dets`` valid detections of ``d`` (a compacted prefix, as NMS gives
    them) → (mean (p, t, 7), boxes (p, d, 4), alive (p, t), dvalid (p, d))
    float32 / bool on the CPU."""
    n = max(tracks, dets)
    xy = rng.uniform(0, 1800, (p, n, 2))
    wh = rng.uniform(40, 200, (p, n, 2))
    mean = np.zeros((p, t, 7), np.float32)
    alive = np.zeros((p, t), bool)
    for i in range(p):
        slots = rng.choice(t, tracks, replace=False)
        c = xy[i, :tracks] + wh[i, :tracks] / 2 + rng.normal(0, 4,
                                                              (tracks, 2))
        w, h = wh[i, :tracks, 0], wh[i, :tracks, 1]
        mean[i, slots, :2] = c
        mean[i, slots, 2] = w * h
        mean[i, slots, 3] = w / h
        mean[i, slots, 4:] = rng.normal(0, 2, (tracks, 3))
        alive[i, slots] = True
    mean[~alive] = rng.normal(0, 50, (int((~alive).sum()), 7))
    boxes = np.zeros((p, d, 4), np.float32)
    dxy = xy[:, :dets] + rng.normal(0, 6, (p, dets, 2))
    boxes[:, :dets] = np.concatenate([dxy, dxy + wh[:, :dets]], -1)
    dvalid = np.zeros((p, d), bool)
    dvalid[:, :dets] = True
    return mean, boxes, alive, dvalid


def assoc_box_cases(rng):
    """K4 boxes-mode cases → name → (mean, boxes, alive, dvalid, thresh):
    the main path's road scene (1 x 100 x 100, IoU 0.35) and a fleet's
    (8 problems); IoU exactly at the threshold (both sides, exact in
    float32); equal scores (twin tracks and twin detections); NaN,
    infinite and zero-area boxes and means; every track or detection
    invalid; detect.max_det = 300 (a road scene, and 300 x 300 dense
    overlapping boxes: the cells no longer fit in shared memory and are
    recomputed from the boxes); 1024 x 1024; ragged sizes."""
    cases = {"main 1x100x100": road_tracks(rng, 1) + (0.35,),
             "fleet 8x100x100": road_tracks(rng, 8) + (0.35,)}
    # x_to_bbox((5, 5, 100, 1)) = (0, 0, 10, 10) exactly; a detection of
    # (0, 0, 10, 5) has IoU 0.5, of (0, 0, 10, 2.5) 0.25, of (0, 0, 5, 5)
    # 0.25: at 0.5 the first matches (>=), at 0.25 all three can
    mean = np.zeros((2, 100, 7), np.float32)
    mean[:, :, :4] = (5, 5, 100, 1)
    mean[:, :, 0] += np.arange(100) * 100.0
    boxes = np.zeros((2, 100, 4), np.float32)
    pick = rng.randint(0, 3, (2, 100))
    boxes[:] = np.array([[0, 0, 10, 5], [0, 0, 10, 2.5], [0, 0, 5, 5]],
                        np.float32)[pick]
    boxes[..., ::2] += np.arange(100)[:, None] * 100.0
    every = (np.ones((2, 100), bool), np.ones((2, 100), bool))
    cases["at threshold 0.5 2x100x100"] = (mean, boxes) + every + (0.5,)
    cases["at threshold 0.25 2x100x100"] = (mean, boxes) + every + (0.25,)
    m, b, a, v = road_tracks(rng, 4, tracks=30, dets=30)
    m[:, 1::2] = m[:, 0::2]                 # twin slots
    b[:, 1::2] = b[:, 0::2]                 # twin detections
    cases["ties 4x100x100"] = (m, b, a | np.roll(a, 1, 1), v, 0.35)
    m, b, a, v = road_tracks(rng, 4, tracks=40, dets=40)
    m[:, 3::7, 2] = 0.0                     # zero-area predictions
    m[:, 5::11, 0] = np.nan
    m[:, 6::13, 3] = np.inf
    b[:, 2::5, 2] = b[:, 2::5, 0]           # zero-width detections
    b[:, 4::9, 1] = np.nan
    b[:, 8::9, 3] = np.inf
    cases["nan zero-area 4x100x100"] = (m, b, a, v, 0.35)
    m, b, a, v = road_tracks(rng, 2)
    cases["invalid tracks 2x100x100"] = (m, b, np.zeros_like(a), v, 0.35)
    cases["invalid dets 2x100x100"] = (m, b, a, np.zeros_like(v), 0.35)
    cases["max_det road 2x300x300"] = road_tracks(
        rng, 2, 300, 300, tracks=60, dets=40) + (0.35,)
    m, b, a, v = road_tracks(rng, 2, 300, 300, tracks=240, dets=240)
    cases["max_det dense 2x300x300"] = (m, b, a | (rng.rand(2, 300) < 0.5),
                                        v | (rng.rand(2, 300) < 0.5), 0.1)
    cases["1024 1x1024x1024"] = road_tracks(
        rng, 1, 1024, 1024, tracks=500, dets=400) + (0.35,)
    cases["ragged 3x7x130"] = road_tracks(rng, 3, 7, 130, tracks=5,
                                          dets=60) + (0.35,)
    return cases


def train_costs(rng, images: int = 4, sets: int = 7, m: int = 50,
                nq: int = 300, nc: int = 80):
    """K5 matcher-mode inputs as RT-DETR training makes them
    (``models/rtdetr_train.py::match_cost`` of random normalised boxes and
    logits against random gts): ``images`` x ``sets`` problems (the
    smoke's 640 x 4 step: 4 images, the encoder's and six decoder
    layers' sets) of ``m`` gt slots, 5-30 of them valid an image (a
    prefix), against ``nq`` queries → (cost (p, m, nq) f32, gt_mask (p, m)
    bool) on the CPU, the problems in the step's order."""
    import torch
    from roadvision_tpu_torch.models import rtdetr_train as RT
    p = images * sets

    def xyxy(n):
        c = rng.uniform(0.05, 0.95, (p, n, 2))
        wh = rng.uniform(0.02, 0.3, (p, n, 2))
        return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    logits = rng.normal(-4, 1.5, (p, nq, nc)).astype(np.float32)
    cls = rng.randint(0, nc, (p, m)).astype(np.int32)
    cost = RT.match_cost(*(torch.from_numpy(a) for a in (
        xyxy(nq), logits, xyxy(m), cls))).numpy()
    mask = np.arange(m) < rng.randint(5, 31, (images, 1))
    return cost, np.tile(mask, (sets, 1))


def match_cases(rng):
    """K5 matcher-mode cases → name → (cost, gt_mask, eps, max_iters): the
    smoke's RT-DETR step (28 x 50 x 300), M close to NQ, M = NQ, one gt
    and one query, the floor (gt 0's runner-up -1.5e9, gt 1's -3e9: with
    the second best floored at -1e9 both bid 1e9 + eps and gt 0 wins),
    every gt masked, the max_iters cap, NaN and infinite costs."""
    eps, iters = 1e-3, 1024
    cost, mask = train_costs(rng)
    cases = {"train 28x50x300": (cost, mask, eps, iters)}
    near = rng.uniform(0, 20, (4, 290, 300)).astype(np.float32)
    cases["M near NQ 4x290x300"] = (near, rng.rand(4, 290) < 0.95, eps,
                                    iters)
    sq = rng.uniform(0, 20, (2, 64, 64)).astype(np.float32)
    cases["square 2x64x64"] = (sq, np.ones((2, 64), bool), eps, iters)
    cases["one 3x1x1"] = (rng.uniform(0, 5, (3, 1, 1)).astype(np.float32),
                          np.ones((3, 1), bool), eps, iters)
    floor = np.float32([[[0, 1.5e9], [0, 3e9]]]).repeat(2, 0)
    cases["floor 2x2x2"] = (floor, np.ones((2, 2), bool), eps, iters)
    cases["masked 2x50x300"] = (cost[:2], np.zeros((2, 50), bool), eps,
                                iters)
    cases["cap 2x290x300"] = (near[:2], cases["M near NQ 4x290x300"][1][:2],
                              eps, 5)
    nan = cost[4:8].copy()
    nan[rng.rand(*nan.shape) < 0.02] = np.nan
    nan[rng.rand(*nan.shape) < 0.01] = np.inf
    cases["nan 4x50x300"] = (nan, mask[4:8], eps, iters)
    return cases


def match_rounds(cost, mask, eps, iters) -> int:
    """Rounds the matcher takes on each problem, summed, from the plain
    version's flag reads (``AUCTION_BLOCK`` 1: a read before each round,
    one more than the rounds)."""
    import torch
    from roadvision_tpu_torch.models import rtdetr_train as RT
    saved = RT.AUCTION_BLOCK
    RT.AUCTION_BLOCK = 1
    total = 0
    try:
        for i in range(cost.shape[0]):
            RT.reset_host_syncs()
            RT.hungarian_match_plain(torch.from_numpy(cost[i:i + 1]),
                                     torch.from_numpy(mask[i:i + 1]), eps,
                                     iters)
            total += RT.host_syncs - 1
    finally:
        RT.AUCTION_BLOCK = saved
    return total


def road_candidates(rng, b: int, k: int, objects: int = 18,
                    valid_share: float = 0.4):
    """K6 boxes-mode inputs as NMS's candidates on a road scene: ``k``
    score-sorted candidates a frame, the first ``valid_share`` valid (a
    prefix), jittered around ``objects`` vehicles of classes 2, 5, 7 (a
    tenth of them under another class) → (boxes (b, k, 4) f32, cls (b, k)
    i32, valid (b, k) bool)."""
    xy = rng.uniform(0, 1800, (b, objects, 2))
    wh = rng.uniform(40, 200, (b, objects, 2))
    ocls = rng.choice([2, 5, 7], (b, objects))
    who = rng.randint(0, objects, (b, k))
    take = lambda a: np.take_along_axis(a, who[..., None], 1)  # noqa: E731
    c = take(xy) + take(wh) / 2 + rng.normal(0, 5, (b, k, 2))
    size = take(wh) * rng.uniform(0.85, 1.15, (b, k, 2))
    boxes = np.concatenate([c - size / 2, c + size / 2], -1) \
        .astype(np.float32)
    cls = np.take_along_axis(ocls, who, 1).astype(np.int32)
    flip = rng.rand(b, k) < 0.1
    cls[flip] = rng.choice([2, 5, 7], int(flip.sum()))
    valid = np.zeros((b, k), bool)
    valid[:, :int(k * valid_share)] = True
    return boxes, cls, valid


def nms_box_cases(rng):
    """K6 boxes-mode cases → name → (boxes, cls, valid, iou_thres): the
    main path's 8 frames x 300 candidates of a road scene at 0.7; IoU
    exactly at the threshold (0.5 and 0.25, strict >); every candidate the
    same box, in one class and in several; overlapping boxes of different
    classes; coordinates near the class offsets (a class-0 box at 7680
    meets a class-1 box at 0); NaN, infinite and zero-area boxes; none
    valid; a scattered valid mask; 600 (TTA, tiling) and 1024 candidates;
    a ragged 33."""
    cases = {"main 8x300": road_candidates(rng, 8, 300) + (0.7,)}
    base = np.array([[0, 0, 10, 10], [0, 0, 10, 5], [0, 0, 5, 5],
                     [0, 0, 10, 2.5]], np.float32)
    boxes = np.tile(base, (2, 75, 1)).reshape(2, 300, 4)
    boxes += (np.arange(300) // 4 * 20.0)[None, :, None]
    cls = np.zeros((2, 300), np.int32)
    every = np.ones((2, 300), bool)
    cases["at threshold 0.5 2x300"] = (boxes, cls, every, 0.5)
    cases["at threshold 0.25 2x300"] = (boxes, cls, every, 0.25)
    same = np.broadcast_to(np.float32([100, 100, 180, 160]),
                           (2, 300, 4)).copy()
    cases["all the same box 2x300"] = (same, cls, every, 0.7)
    cases["same box, classes 2x300"] = (same, rng.randint(0, 3, (2, 300))
                                        .astype(np.int32), every, 0.7)
    b, c, v = road_candidates(rng, 2, 300, valid_share=1.0)
    cases["classes overlapping 2x300"] = (b, rng.randint(0, 80, (2, 300))
                                          .astype(np.int32), v, 0.5)
    near = np.zeros((2, 300, 4), np.float32)
    near[:, 0::2] = [7670, 7675, 7690, 7700]       # class 0, near 7680
    near[:, 1::2] = [-10, -5, 10, 20]              # class 1 → 7670 ..
    ncls = np.tile([0, 1], (2, 150)).astype(np.int32)
    near += rng.normal(0, 2, near.shape).astype(np.float32)
    cases["near the class offsets 2x300"] = (near, ncls, every, 0.3)
    b, c, v = road_candidates(rng, 4, 300, valid_share=0.8)
    b[:, 3::7, 0] = np.nan
    b[:, 5::11, 3] = np.inf
    b[:, 2::5, 2] = b[:, 2::5, 0]                  # zero width
    b[:, 6::9] = b[:, 6::9, :1].repeat(4, -1)      # a point
    cases["nan zero-area 4x300"] = (b, c, v, 0.7)
    b, c, v = road_candidates(rng, 2, 300)
    cases["none valid 2x300"] = (b, c, np.zeros_like(v), 0.7)
    cases["scattered valid 2x300"] = (b, c, rng.rand(2, 300) < 0.5, 0.45)
    cases["tta 2x600"] = road_candidates(rng, 2, 600) + (0.7,)
    cases["1024 1x1024"] = road_candidates(rng, 1, 1024,
                                           valid_share=0.9) + (0.7,)
    cases["ragged 3x33"] = road_candidates(rng, 3, 33, objects=4,
                                           valid_share=0.8) + (0.6,)
    return cases


def assoc_rounds(plain, host, block=None) -> int:
    """Rounds the loop takes on each problem of ``host``, summed, from the
    plain version's flag reads, one problem at a time: the greedy reads
    once after each round's scans (the last finds no pair), the auction
    (``block`` 1: a read before each round) once more than its rounds."""
    import torch
    from roadvision_tpu_torch.track import sort as tsort
    saved = tsort.AUCTION_BLOCK
    if block is not None:
        tsort.AUCTION_BLOCK = block
    total = 0
    try:
        for i in range(host[0].shape[0]):
            tsort.reset_host_syncs()
            plain(*(torch.from_numpy(a[i]) for a in host), 0.35)
            total += tsort.host_syncs - (block is not None)
    finally:
        tsort.AUCTION_BLOCK = saved
    return total


EMPTY_KERNEL_CU = r"""
#include <cuda_runtime.h>
__global__ void rvt_empty_kernel() {}
extern "C" int rvt_empty(void* stream) {
  rvt_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_kernel():
    """A launcher of an empty kernel (built here with nvcc, beside the
    port's libraries): the card's launch floor."""
    import ctypes
    import torch
    from roadvision_tpu_torch.kernels import _build
    out = _build.BUILD_DIR / "libempty_kernel.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(EMPTY_KERNEL_CU)
        subprocess.run([_build._nvcc(), *_build.BASE_FLAGS, "-o", str(out),
                        str(src)], check=True, capture_output=True,
                       timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.rvt_empty.argtypes = [ctypes.c_void_p]
    lib.rvt_empty.restype = ctypes.c_int

    def launch():
        code = lib.rvt_empty(torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"empty kernel: CUDA error {code}")
    return launch


def graph_ms(fn, n: int = GRAPH_LAUNCHES) -> dict:
    """``fn`` (one kernel launch and its wrapper) captured ``n`` times into
    one CUDA graph: the ms a launch when the graph replays back to back
    (warm L2; no host time between launches), and the ms of a graph of
    one launch replayed after L2_FLUSH_BYTES went through L2."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    many, one = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(many):
        for _ in range(n):
            fn()
    with torch.cuda.graph(one):
        fn()
    return {"graph_ms": cuda_ms(many.replay, 20) / n,
            "graph_flushed_ms": cuda_ms_flushed(one.replay)}


def kernel_times(fn, plain) -> dict:
    """A kernel's wrapper ``fn`` timed four ways (50 queued eager calls,
    one eager call after an L2 flush, 50 launches in one graph, one
    graph launch after a flush) beside its plain version."""
    out = {"ms": cuda_ms(fn, 50), "flushed_ms": cuda_ms_flushed(fn)}
    out.update(graph_ms(fn))
    out["plain_ms"] = cuda_ms(plain, 5, 1)
    return out


def fmt_times(r: dict) -> str:
    return (f"{r['ms']:.4f} ms warm, {r['flushed_ms']:.4f} ms flushed, "
            f"in a graph {r['graph_ms']:.4f} ms warm, "
            f"{r['graph_flushed_ms']:.4f} ms flushed; plain "
            f"{r['plain_ms']:.4f} ms")


def box_scores(case):
    """The (iou, alive, dvalid) that a K4 boxes case's plain version
    associates, as numpy."""
    import torch
    from roadvision_tpu_torch.track import sort as tsort
    mean, boxes, alive, dvalid = case[:4]
    iou = tsort.iou_matrix(tsort.x_to_bbox(torch.from_numpy(mean)),
                           torch.from_numpy(boxes)).numpy()
    return iou, alive, dvalid


def check_tail_kernels() -> dict:
    """K4-K6 against their plain versions on the card, bit for bit: K4's
    matrix mode and K5's on every case of :func:`assoc_cases` (K5 also
    under a max_iters cap of 3), the boxes modes of K4 and K5 (both maps)
    on :func:`assoc_box_cases`, K5's matcher mode on :func:`match_cases`,
    K6's matrix mode on :func:`nms_cases`, its boxes mode on
    :func:`nms_box_cases`; each K4 and K5 problem alone equal to the
    batch. Timed at the main path's shapes (K4 one 100 x 100 problem a
    frame, K6 8 x 300 candidates a batch, both in boxes mode; the matrix
    modes beside them; K5 in the three modes: the hungarian tracker's
    problem, the RT-DETR step's 28 x 50 x 300) four ways
    (:func:`kernel_times`), beside an empty kernel's launch in a graph
    (the card's floor), the plain version and the bound, whose operations
    count the rounds and the live cells these inputs take."""
    import torch
    from roadvision_tpu_torch.models import rtdetr_train as RT
    from roadvision_tpu_torch.ops import nms as tnms
    from roadvision_tpu_torch.track import sort as tsort
    rng = np.random.RandomState(12)
    dev = torch.device("cuda")
    def cpu(host):
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in host]

    def on(host):
        return [a.to(dev) for a in cpu(host)]

    rows = {}
    floor = graph_ms(empty_kernel())["graph_ms"]
    print(f"[kernels] launch floor: an empty kernel {floor:.4f} ms a launch "
          f"({GRAPH_LAUNCHES} in one graph)", flush=True)

    # K4 matrix mode and K5
    cases = assoc_cases(rng)
    for name, wrapper, plain in (
            ("assoc_greedy", tsort.greedy_associate,
             tsort.greedy_associate_plain),
            ("assoc_auction", tsort.auction_associate,
             tsort.auction_associate_plain)):
        for case, host in cases.items():
            args = on(host)
            got = wrapper(*args, 0.35)
            torch.cuda.synchronize()
            want = plain(*cpu(host), 0.35)
            if not torch.equal(got.cpu(), want):
                bad = int((got.cpu() != want).sum())
                fail(f"{name} on {case}: {bad} entries differ from plain")
            for i in range(host[0].shape[0]):
                if not torch.equal(wrapper(*(a[i] for a in args),
                                           0.35).cpu(), want[i]):
                    fail(f"{name} on {case}: problem {i} alone differs")
    for case in ("ties 4x100x100", "max_det 2x300x300", "chain 1x300x300"):
        got = tsort.auction_associate(*on(cases[case]), 0.35, max_iters=3)
        want = tsort.auction_associate_plain(*cpu(cases[case]), 0.35,
                                             max_iters=3)
        if not torch.equal(got.cpu(), want):
            fail(f"assoc_auction on {case}, max_iters 3: differs from "
                 f"plain")
    # K4 and K5 boxes modes
    bcases = assoc_box_cases(rng)
    for name, wrapper, plain in (
            ("assoc_greedy", tsort.greedy_associate_boxes,
             tsort.greedy_associate_boxes_plain),
            ("assoc_auction", tsort.auction_associate_boxes,
             tsort.auction_associate_boxes_plain)):
        for case, host in bcases.items():
            args, thresh = on(host[:4]), host[4]
            got = wrapper(*args, thresh)
            torch.cuda.synchronize()
            want = plain(*cpu(host[:4]), thresh)
            for g, w, what in zip(got, want, ("det2trk", "trk2det")):
                if not torch.equal(g.cpu(), w):
                    fail(f"{name} boxes mode on {case}: "
                         f"{int((g.cpu() != w).sum())} {what} entries "
                         f"differ from plain")
            for i in range(host[0].shape[0]):
                one = wrapper(*(a[i:i + 1] for a in args), thresh)
                if not all(torch.equal(g.cpu()[0], w[i])
                           for g, w in zip(one, want)):
                    fail(f"{name} boxes mode on {case}: problem {i} "
                         f"alone differs")
    # K5 matcher mode
    mcases = match_cases(rng)
    for case, (cost, mask, eps, iters) in mcases.items():
        args = on((cost, mask))
        got = RT.hungarian_match(*args, eps, iters)
        torch.cuda.synchronize()
        want = RT.hungarian_match_plain(*cpu((cost, mask)), eps, iters)
        if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
            fail(f"assoc_auction matcher mode on {case}: differs from "
                 f"plain")
        for i in range(min(cost.shape[0], 4)):
            if not torch.equal(RT.hungarian_match(
                    *(a[i:i + 1] for a in args), eps, iters).cpu()[0],
                    want[i]):
                fail(f"assoc_auction matcher mode on {case}: problem {i} "
                     f"alone differs")
    # K6 matrix mode and boxes mode
    ncases = nms_cases(rng)
    for case, host in ncases.items():
        got = tnms.greedy_keep(*on(host))
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), tnms.greedy_keep_plain(*cpu(host))):
            fail(f"nms_keep on {case}: differs from plain")
    nbcases = nms_box_cases(rng)
    for case, host in nbcases.items():
        got = tnms.greedy_keep_boxes(*on(host[:3]), host[3])
        torch.cuda.synchronize()
        want = tnms.greedy_keep_boxes_plain(*cpu(host[:3]), host[3])
        if not torch.equal(got.cpu(), want):
            fail(f"nms_keep boxes mode on {case}: "
                 f"{int((got.cpu() != want).sum())} entries differ from "
                 f"plain")

    # times: K4 (boxes mode on the main path, matrix mode beside it), K5
    main = bcases["main 1x100x100"]
    margs = on(main[:4])
    scores = box_scores(main)
    sargs = on(scores)
    p, t, d = scores[0].shape
    rounds = assoc_rounds(tsort.greedy_associate_plain, scores)
    live = int(sum(a.sum() * v.sum() for a, v in zip(main[2], main[3])))
    row = kernel_times(
        lambda: tsort.greedy_associate_boxes(*margs, 0.35),
        lambda: tsort.greedy_associate_boxes_plain(*margs, 0.35))
    row.update(max_abs_err=0, library_ms=None, rounds=rounds,
               launch_floor_ms=floor,
               **bound(p * (t * 7 * 4 + d * 16 + (t + d) + (t + d) * 4),
                       live * (IOU_OPS_PER_PAIR
                               + max(rounds, 1) * K4_OPS_PER_CELL)
                       + p * (t + d) * K4_OPS_PER_BOX))
    fleet = on(bcases["fleet 8x100x100"][:4])
    row["fleet_8_ms"] = cuda_ms(
        lambda: tsort.greedy_associate_boxes(*fleet, 0.35), 50)
    big = {k: on(bcases[k][:4]) for k in ("max_det road 2x300x300",
                                           "max_det dense 2x300x300")}
    row["max_det_300_ms"] = {
        k: cuda_ms(lambda a=a: tsort.greedy_associate_boxes(*a, 0.35), 10)
        for k, a in big.items()}
    mrow = kernel_times(lambda: tsort.greedy_associate(*sargs, 0.35),
                        lambda: tsort.greedy_associate_plain(*sargs, 0.35))
    rand300 = on(cases["max_det 2x300x300"])
    mrow["max_det_300_ms"] = cuda_ms(
        lambda: tsort.greedy_associate(*rand300, 0.35), 10)
    mrow["max_det_300_rounds"] = assoc_rounds(tsort.greedy_associate_plain,
                                              cases["max_det 2x300x300"])
    row["matrix_mode"] = mrow
    rows["assoc_greedy"] = row
    print(f"[kernels] assoc_greedy: bit-equal to plain, matrix mode on "
          f"{', '.join(cases)}; boxes mode (both maps) on "
          f"{', '.join(bcases)}; each problem alone equal to the batch",
          flush=True)
    print(f"[kernels] assoc_greedy boxes mode, 1 x 100 x 100 (the main "
          f"path's problem, {rounds} rounds, {live} live cells): "
          f"{fmt_times(row)}; bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']}); launch floor {floor:.4f} ms; 8 problems in "
          f"one launch {row['fleet_8_ms']:.4f} ms; max_det 300 "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in
                      row["max_det_300_ms"].items()), flush=True)
    print(f"[kernels] assoc_greedy matrix mode, the same problem's IoU: "
          f"{fmt_times(mrow)}; max_det 300 (2 x 300 x 300 random, "
          f"{mrow['max_det_300_rounds']} rounds, the scores read in place) "
          f"{mrow['max_det_300_ms']:.4f} ms", flush=True)
    # K5: matrix mode (scores handed over), boxes mode ([tracker]
    # hungarian's problem), matcher mode (the RT-DETR step's)
    host = cases["main 1x100x100"]
    args = on(host)
    p, t, d = host[0].shape
    rounds = assoc_rounds(tsort.auction_associate_plain, host, 1)
    row = kernel_times(lambda: tsort.auction_associate(*args, 0.35),
                       lambda: tsort.auction_associate_plain(*args, 0.35))
    row.update(max_abs_err=0, library_ms=None, rounds=rounds,
               launch_floor_ms=floor,
               **bound(p * t * d * 4 + p * (t + d) + p * d * 4,
                       max(rounds, 1) * K5_OPS_PER_CELL * d * (t + d)))
    fargs = on(cases["fleet 8x100x100"])
    row["fleet_8_ms"] = cuda_ms(
        lambda: tsort.auction_associate(*fargs, 0.35), 50)
    row["fleet_8_graph_ms"] = graph_ms(
        lambda: tsort.auction_associate(*fargs, 0.35))["graph_ms"]
    big = on(cases["max_det 2x300x300"])
    row["max_det_300_ms"] = cuda_ms(
        lambda: tsort.auction_associate(*big, 0.35), 10)
    row["max_det_300_rounds"] = assoc_rounds(tsort.auction_associate_plain,
                                             cases["max_det 2x300x300"], 1)
    main = bcases["main 1x100x100"]
    margs = on(main[:4])
    brounds = assoc_rounds(tsort.auction_associate_plain, box_scores(main),
                           1)
    live = int(sum(a.sum() * v.sum() for a, v in zip(main[2], main[3])))
    brow = kernel_times(
        lambda: tsort.auction_associate_boxes(*margs, 0.35),
        lambda: tsort.auction_associate_boxes_plain(*margs, 0.35))
    brow.update(max_abs_err=0, library_ms=None, rounds=brounds,
                **bound(p * (t * 7 * 4 + d * 16 + (t + d) + (t + d) * 4),
                        live * IOU_OPS_PER_PAIR
                        + max(brounds, 1) * K5_OPS_PER_CELL * d * (t + d)
                        + p * (t + d) * K4_OPS_PER_BOX))
    row["boxes_mode"] = brow
    cost, mask, eps, iters = mcases["train 28x50x300"]
    cargs = on((cost, mask))
    mp, m, nq = cost.shape
    mrounds = match_rounds(cost, mask, eps, iters)
    mrow = kernel_times(lambda: RT.hungarian_match(*cargs, eps, iters),
                        lambda: RT.hungarian_match_plain(*cargs, eps, iters))
    mrow.update(max_abs_err=0, library_ms=None, rounds=mrounds,
                problems=mp, **bound(mp * m * nq * 4 + mp * m + mp * m * 8,
                                     max(mrounds, 1) * K5_OPS_PER_CELL * m
                                     * nq))
    row["matcher_mode"] = mrow
    rows["assoc_auction"] = row
    print(f"[kernels] assoc_auction: bit-equal to plain, matrix mode on "
          f"{', '.join(cases)} (and max_iters 3); boxes mode (both maps) "
          f"on {', '.join(bcases)}; matcher mode on {', '.join(mcases)}; "
          f"each problem alone equal to the batch", flush=True)
    print(f"[kernels] assoc_auction matrix mode, 1 x 100 x 100 ({rounds} "
          f"rounds): {fmt_times(row)}; bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']}); launch floor {floor:.4f} ms; 8 problems in "
          f"one launch {row['fleet_8_ms']:.4f} ms, in a graph "
          f"{row['fleet_8_graph_ms']:.4f} ms; max_det 300 (2 x 300 x "
          f"300 random, {row['max_det_300_rounds']} rounds) "
          f"{row['max_det_300_ms']:.4f} ms", flush=True)
    print(f"[kernels] assoc_auction boxes mode, 1 x 100 x 100 ([tracker] "
          f"hungarian's problem, {brounds} rounds, {live} live cells): "
          f"{fmt_times(brow)}; bound {brow['bound_ms']:.6f} ms "
          f"({brow['bound_by']})", flush=True)
    print(f"[kernels] assoc_auction matcher mode, {mp} x {m} x {nq} (the "
          f"RT-DETR step's, {mrounds} rounds summed over its problems): "
          f"{fmt_times(mrow)}; bound {mrow['bound_ms']:.6f} ms "
          f"({mrow['bound_by']})", flush=True)

    # K6: boxes mode on the main path, matrix mode beside it
    boxes, cls, valid, thr = nbcases["main 8x300"]
    bargs = on((boxes, cls, valid))
    b, k = valid.shape
    pairs = int(sum(v * (v - 1) // 2 for v in valid.sum(1)))
    row = kernel_times(lambda: tnms.greedy_keep_boxes(*bargs, thr),
                       lambda: tnms.greedy_keep_boxes_plain(*bargs, thr))
    row.update(max_abs_err=0, library_ms=None, launch_floor_ms=floor,
               valid_per_frame=float(valid.sum(1).mean()),
               **bound(b * k * (16 + 4 + 1) + b * k,
                       pairs * IOU_OPS_PER_PAIR + b * k * K6_OPS_PER_BOX))
    row["k_ms"] = {c: cuda_ms(lambda a=on(nbcases[c][:3]), th=nbcases[c][3]:
                              tnms.greedy_keep_boxes(*a, th), 20)
                   for c in ("tta 2x600", "1024 1x1024")}
    words = -(-k // 32)
    matrix = {}
    for c in ("main 8x300x300", "obb 8x300x300"):
        o, v = on(ncases[c])
        matrix[c] = kernel_times(lambda o=o, v=v: tnms.greedy_keep(o, v),
                                 lambda o=o, v=v: tnms.greedy_keep_plain(o, v))
        matrix[c].update(**bound(b * k * k + 2 * b * k,
                                 b * (k * k + k * words)))
    row["matrix_mode"] = matrix
    rows["nms_keep"] = row
    print(f"[kernels] nms_keep: bit-equal to plain, boxes mode on "
          f"{', '.join(nbcases)}; matrix mode on {', '.join(ncases)}",
          flush=True)
    print(f"[kernels] nms_keep boxes mode, 8 x 300 (the main path's, "
          f"{row['valid_per_frame']:g} valid a frame): {fmt_times(row)}; "
          f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}); launch "
          f"floor {floor:.4f} ms; "
          + ", ".join(f"{c} {v:.4f} ms" for c, v in row["k_ms"].items()),
          flush=True)
    for c, r in matrix.items():
        print(f"[kernels] nms_keep matrix mode, {c}: {fmt_times(r)}; bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
    for r in rows.values():
        r["fleet"] = {}
    return rows


def resident_run(eng, step_fn, inputs, k0: int, n: int, keep: bool = False):
    """``n`` batches ``inputs(k0..)`` through ``step_fn`` (the engine's
    eager ``step`` or ``step_batch``), results copied back through the
    engine's pinned buffers, two batches in flight, as the bench's
    device-resident loop. Returns the host arrays when ``keep``."""
    pending, kept = [], []

    def finish(item):
        bufs, key, done = item
        done.synchronize()
        if keep:
            kept.append([t.numpy().copy() for t in bufs])
        eng.recycle(key, bufs)

    for k in range(k0, k0 + n):
        _, arrays = step_fn(*inputs(k), want_proc=False)
        pending.append(eng.download(list(arrays)))
        if len(pending) >= 2:
            finish(pending.pop(0))
    while pending:
        finish(pending.pop(0))
    return kept


def same_arrays(a, b, what: str) -> dict:
    """One batch's 7 arrays, two runs: valid, classes and ids exact where
    valid, boxes within BOX_TOL, confidences within CONF_TOL."""
    boxes, conf, cls_id, valid, ids = a[:5]
    if not np.array_equal(valid, b[3]):
        fail(f"{what}: different detections kept")
    if not (np.array_equal(cls_id[valid], b[2][valid])
            and np.array_equal(ids[valid], b[4][valid])):
        fail(f"{what}: classes or ids differ")
    box = float(np.abs(boxes[valid] - b[0][valid]).max(initial=0.0))
    cf = float(np.abs(conf[valid] - b[1][valid]).max(initial=0.0))
    if box > BOX_TOL or cf > CONF_TOL:
        fail(f"{what}: boxes {box:.3e} px, confidences {cf:.3e}")
    return {"box": box, "conf": cf, "n": int(valid.sum())}


def fleet_scaling(eng, card: str) -> dict:
    """The fleet step at 1080p x 8 a stream for S = 1, 2, 4, 8 streams,
    eager (the stacked step called) against its captured graph, frames
    rendered on the card beforehand: frames/s in all, two windows each,
    in turns (eager, graph, graph, eager)."""
    import torch
    from roadvision_tpu_torch.io_video import DeviceSyntheticSource
    from roadvision_tpu_torch.parallel.inference import make_stream_step
    from roadvision_tpu_torch.runtime.graph import CapturedStep
    out = {}
    for s in FLEET_SIZES:
        step, init_states = make_stream_step(eng, (BATCH, HEIGHT, WIDTH))
        render = DeviceSyntheticSource(WIDTH, HEIGHT, num_vehicles=6,
                                       seed=s, device=eng.device) \
            .make_render_fn(s * BATCH)
        clip = [render(k * s * BATCH).reshape(s, BATCH, HEIGHT, WIDTH, 3)
                for k in range(3)]
        base = torch.arange(s * BATCH, dtype=torch.float32,
                            device=eng.device).reshape(s, BATCH) / 30.0

        def inp(k):
            return clip[k % 3], base + k * s * BATCH / 30.0

        states = {"eager": init_states(s), "graph": init_states(s)}
        graph = CapturedStep(step, states["graph"], inp(0))
        n_k = iter(range(1, 10 ** 9))

        def window(mode, n=4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = []
            for _ in range(n):
                k = next(n_k)
                if mode == "graph":
                    outs = graph(*inp(k))
                else:
                    outs, states["eager"] = step(states["eager"], *inp(k))
                pending.append(eng.download(list(outs)))
                if len(pending) >= 2:
                    bufs, key, done = pending.pop(0)
                    done.synchronize()
                    eng.recycle(key, bufs)
            for bufs, key, done in pending:
                done.synchronize()
                eng.recycle(key, bufs)
            return n * s * BATCH / (time.perf_counter() - t0)

        window("eager", 1)
        window("graph", 1)
        fps = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            fps[mode].append(window(mode))
        out[s] = {m: float(np.median(v)) for m, v in fps.items()}
        del graph, clip
    one = out[FLEET_SIZES[0]]
    print("[graph] fleet at 1080p x 8 a stream, frames/s in all, eager / "
          "graph (x one stream's): "
          + "; ".join(f"S={s} {r['eager']:.1f} / {r['graph']:.1f} "
                      f"({r['eager'] / one['eager']:.2f} x / "
                      f"{r['graph'] / one['graph']:.2f} x)"
                      for s, r in out.items()) + f" ({card})", flush=True)
    return out


# the torch functions whose work K4's and K6's boxes modes took over: the
# main path must call none of them on the card
TORCH_IOU = (("track.sort", "x_to_bbox"), ("track.sort", "iou_matrix"),
             ("track.sort", "trk2det_map"), ("ops.nms", "iou_matrix_xyxy"))


def torch_iou_calls(fn) -> dict:
    """How often each of TORCH_IOU is called while ``fn`` runs."""
    import importlib
    counts, saved = {}, []
    for mod_name, attr in TORCH_IOU:
        mod = importlib.import_module(f"roadvision_tpu_torch.{mod_name}")
        orig = getattr(mod, attr)
        counts[attr] = 0

        def counted(*a, _orig=orig, _attr=attr, **kw):
            counts[_attr] += 1
            return _orig(*a, **kw)
        saved.append((mod, attr, orig))
        setattr(mod, attr, counted)
    try:
        fn()
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    return counts


def graph_phase(model: str, card: str) -> dict:
    """``[graph]``: the main path (1080p x 8, bfloat16) replays one CUDA
    graph a batch (``engine.step_mode == "graph"``). GRAPH_BATCHES
    replayed batches against as many eager ``engine.step`` batches from
    the same (reset) state under the smoke's limits, with the same launch
    counts, exact, and no host read in the replayed ones; stage ms eager
    (``tools/bench.py::stage_ms``) against each stage captured alone
    (``graph_stage_ms``); frames/s eager against graph (device-resident,
    in turns); then the fleet
    at S = 1, 2, 4, 8 and multi_stream.yaml's fleet."""
    import torch
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.io_video import DeviceSyntheticSource
    from roadvision_tpu_torch.runtime import MultiStreamEngine, PipelineEngine
    from roadvision_tpu_torch.tools.bench import graph_stage_ms, stage_ms
    from roadvision_tpu_torch.track import sort as tsort
    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    eng = PipelineEngine(pipeline_cfg(model), device=GRAPH_DEVICE)
    if eng.step_mode != "graph":
        fail(f"[graph]: the main path runs {eng.step_mode} "
             f"({eng.eager_reason})")
    render = DeviceSyntheticSource(WIDTH, HEIGHT, num_vehicles=6, seed=0,
                                   device=eng.device).make_render_fn(BATCH)
    steps = torch.arange(BATCH, device=eng.device,
                         dtype=torch.float32) / 30.0
    rendered = {}

    def inputs(k):
        if k not in rendered:
            rendered[k] = render(k * BATCH)
        return rendered[k], k * BATCH / 30.0 + steps

    runs, counts = {}, {}
    eng.step_batch(*inputs(0), want_proc=False)   # captures, outside counts
    for mode, fn in (("graph", eng.step_batch), ("eager", eng.step)):
        eng.reset()
        kernels.reset_launch_counts()
        tsort.reset_host_syncs()
        runs[mode] = resident_run(eng, fn, inputs, 0, GRAPH_BATCHES,
                                  keep=True)
        counts[mode] = add_to_totals(dict(kernels.launch_counts))
        want = dict({k: GRAPH_BATCHES for k in PRE_KERNELS},
                    **tail_want(GRAPH_BATCHES, GRAPH_BATCHES * BATCH))
        if counts[mode] != want:
            launch_mismatch(f"[graph] {mode}: launches {counts[mode]}, "
                            f"expected {want}")
        if tsort.host_syncs:
            fail(f"[graph] {mode}: {tsort.host_syncs} flag reads")
    worst = {"box": 0.0, "conf": 0.0, "n": 0}
    for i, (g, e) in enumerate(zip(runs["graph"], runs["eager"])):
        r = same_arrays(g, e, f"[graph] batch {i} graph vs eager")
        worst = {"box": max(worst["box"], r["box"]),
                 "conf": max(worst["conf"], r["conf"]),
                 "n": worst["n"] + r["n"]}
    if worst["n"] < GRAPH_BATCHES * BATCH:
        fail(f"[graph]: only {worst['n']} detections compared")
    syncs = {m: count_syncs(lambda f=f: [f(*inputs(k), want_proc=False)
                                         for k in range(4)]) / 4
             for m, f in (("graph", eng.step_batch), ("eager", eng.step))}
    if syncs["graph"]:
        fail(f"[graph]: {syncs['graph']} host syncs a replayed batch")
    iou_calls = torch_iou_calls(
        lambda: eng.step(*inputs(0), want_proc=False))
    if any(iou_calls.values()):
        fail(f"[graph]: the eager main path still calls the torch IoU: "
             f"{iou_calls}")
    print(f"[graph] an eager main-path batch calls the torch IoU helpers "
          f"{json.dumps(iou_calls)} times: K4 and K6 compute it (boxes "
          f"modes)", flush=True)
    print(f"[graph] main path step_mode graph: {GRAPH_BATCHES} replayed "
          f"1080p x {BATCH} bf16 batches equal {GRAPH_BATCHES} eager "
          f"engine.step batches from the same state ({worst['n']} "
          f"detections; ids, classes, counts exact; boxes {worst['box']:.2e}"
          f" px, conf {worst['conf']:.2e}); launches a batch "
          + json.dumps({k: v / GRAPH_BATCHES for k, v in
                        counts["graph"].items()})
          + f" both ways; host syncs a batch graph {syncs['graph']:g}, "
          f"eager {syncs['eager']:g}", flush=True)

    # frames/s, device-resident, in turns
    fps = {"eager": [], "graph": []}
    k = GRAPH_BATCHES
    for mode in ("eager", "graph", "graph", "eager"):
        fn = eng.step if mode == "eager" else eng.step_batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident_run(eng, fn, inputs, k, GRAPH_FPS_BATCHES)
        torch.cuda.synchronize()
        fps[mode].append(GRAPH_FPS_BATCHES * BATCH
                         / (time.perf_counter() - t0))
        k += GRAPH_FPS_BATCHES
    rendered.clear()
    frames_np = render(k * BATCH).cpu().numpy()
    ts_np = 2000.0 + np.arange(BATCH) / 30.0
    stages = {"eager": stage_ms(eng, frames_np, ts_np),
              "graph": graph_stage_ms(eng, frames_np, ts_np)}
    rendered.clear()
    med = {m: float(np.median(v)) for m, v in fps.items()}
    print(f"[graph] frames/s device-resident, 1080p x {BATCH} bf16: eager "
          f"{med['eager']:.1f} {[round(v, 1) for v in fps['eager']]}, graph "
          f"{med['graph']:.1f} {[round(v, 1) for v in fps['graph']]} "
          f"({med['graph'] / med['eager']:.2f} x) ({card})", flush=True)
    for m in ("eager", "graph"):
        print(f"[graph] stage ms {m}: "
              + json.dumps({s: round(v, 3) for s, v in stages[m].items()})
              + f" ({card})", flush=True)
    fleet = fleet_scaling(eng, card)
    del eng
    # multi_stream.yaml's fleet replays its graph too, with no host read
    multi = MultiStreamEngine(multi_cfg(model), 4, devices=[GRAPH_DEVICE])
    if multi.step_mode != "graph":
        fail(f"[graph]: multi_stream.yaml runs {multi.step_mode}")
    fb = fleet_batches(multi_cfg(model), 2)
    multi.process_batch(*fb[0])
    tsort.reset_host_syncs()
    frames = torch.from_numpy(fb[1][0]).to(multi.engine.device)
    ts = torch.from_numpy((fb[1][1] - multi._t0).astype(np.float32)) \
        .to(multi.engine.device)
    grp = multi.groups[0]
    graph = grp.engine._graphs[("fleet", tuple(frames.shape))]
    multi_syncs = count_syncs(lambda: graph(frames, ts))
    if multi_syncs or tsort.host_syncs:
        fail(f"[graph] multi_stream.yaml: {multi_syncs} host syncs a fleet "
             f"batch")
    print(f"[graph] multi_stream.yaml: step_mode graph, {multi_syncs} host "
          f"syncs a replayed fleet batch; the phase ran "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches_per_batch": {k: v / GRAPH_BATCHES
                                   for k, v in counts["graph"].items()},
            "graph_vs_eager": worst, "host_syncs_per_batch": syncs,
            "fps": fps, "fps_median": med, "stage_ms": stages,
            "fleet_fps": fleet,
            "multi_stream_syncs": multi_syncs, "torch_iou_calls": iou_calls}


# [graph] trackers: the hooked backends and GMC behind the chain, replayed
# name → tracking overrides (strongsort turns GMC on by default)
TRACKER_GRAPH_PATHS = {
    "bytetrack": {"backend": "bytetrack"},
    "ocsort": {"backend": "ocsort"},
    "deepsort": {"backend": "deepsort"},
    "strongsort": {"backend": "strongsort"},
    "botsort gmc": {"backend": "botsort", "gmc": True},
}
TRACKER_FLEETS = ("deepsort", "botsort gmc")
TRK_FPS_BATCHES = 8                # batches a timed window
FLEET_TRK_BATCHES = 3              # fleet batches replayed against eager


def _assoc_of(name: str) -> tuple:
    return ASSOC_PER_FRAME[name.split()[0]]


def _same_fleet_results(got, want, what: str) -> int:
    """Two runs' fleet batches (per-stream lists of FrameResults): every
    detection equal, boxes, confidences, classes, ids, distance and speed
    bit for bit. Returns the detections compared."""
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        for si, (gs, ws) in enumerate(zip(g, w)):
            for fi, (a, b) in enumerate(zip(gs, ws)):
                if a.detections != b.detections:
                    fail(f"{what}: batch {i} stream {si} frame {fi} "
                         f"differs")
                n += len(a.detections)
    return n


def fleet_tracker_scaling(model: str, name: str, card: str) -> dict:
    """The camera fleet of a hooked backend as users run it:
    ``MultiStreamEngine(cfg, S, devices=[GRAPH_DEVICE]).process_batch``
    at 1080p x 8 a stream, S = 1, 2, 4, 8 (for botsort + GMC the groups'
    state holds GMC's (S, G, G) carry). Against the same fleet forced to
    ``step_mode = "eager"``, each after its first batch (the capture, the
    cuDNN search) and a ``reset()``: FLEET_TRK_BATCHES fleet batches, a
    ``reset()``, the same batches again. Every detection bit-equal,
    the second pass equal to the first, the state after equal; launches
    exact both ways (K1-K3 and K6 once a fleet batch, K4 ``B · k`` for
    all S streams); no host sync in a replayed fleet batch; the graph
    kept its state tensors through both resets. Then frames/s in all
    through ``process_batch``, eager against replayed, in turns."""
    import torch
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.io_video import DeviceSyntheticSource
    from roadvision_tpu_torch.runtime import MultiStreamEngine
    from roadvision_tpu_torch.track import sort as tsort
    cfg = merge(pipeline_cfg(model), {"tracking": TRACKER_GRAPH_PATHS[name]})
    per_frame = _assoc_of(name)
    n = FLEET_TRK_BATCHES
    what = f"[graph] trackers fleet {name}"
    out = {}
    for s in FLEET_SIZES:
        fleets = {m: MultiStreamEngine(cfg, s, devices=[GRAPH_DEVICE])
                  for m in ("graph", "eager")}
        if fleets["graph"].step_mode != "graph":
            fail(f"{what} S={s}: the fleet runs "
                 f"{fleets['graph'].step_mode} "
                 f"({fleets['graph'].engine.eager_reason})")
        fleets["eager"].step_mode = "eager"
        for grp in fleets["eager"].groups:
            grp.engine.step_mode = "eager"
        render = DeviceSyntheticSource(
            WIDTH, HEIGHT, num_vehicles=6, seed=s,
            device=fleets["graph"].engine.device).make_render_fn(s * BATCH)
        clip = [render(k * s * BATCH).reshape(s, BATCH, HEIGHT, WIDTH, 3)
                .cpu().numpy() for k in range(1 + n)]
        del render

        def inp(k):
            return clip[k % len(clip)], 1000.0 + np.repeat(
                (k * BATCH + np.arange(BATCH))[None] / 30.0, s, axis=0)

        runs, ends, syncs, counts = {}, {}, {}, {}
        for mode, fleet in fleets.items():
            fleet.process_batch(*inp(0))       # graph: the capture
            grp = fleet.groups[0]
            held = grp.step_state()
            fleet.reset()
            kernels.reset_launch_counts()
            tsort.reset_host_syncs()
            kept, syncs[mode] = [], 0
            for rep in range(2):
                if rep:
                    fleet.reset()
                syncs[mode] += count_syncs(lambda: [
                    kept.append(fleet.process_batch(*inp(k)))
                    for k in range(1, 1 + n)])
            counts[mode] = exact_launches(
                f"{what} S={s} {mode}",
                {**{k: 2 * n for k in PRE_KERNELS},
                 **tail_want(2 * n, 2 * n * BATCH, *per_frame)})
            if mode == "graph":
                if syncs[mode] or tsort.host_syncs:
                    fail(f"{what} S={s}: {syncs[mode]} host syncs, "
                         f"{tsort.host_syncs} flag reads in {2 * n} "
                         f"replayed fleet batches")
                if grp.step_state() is not held \
                        or len(grp.engine._graphs) != 1:
                    fail(f"{what} S={s}: the graph's state was rebound or "
                         f"captured again")
            _same_fleet_results(kept[n:], kept[:n],
                                f"{what} S={s} {mode} after reset()")
            runs[mode] = kept[:n]
            ends[mode] = [t.cpu().numpy() for t in grp.step_state()]
        n_det = _same_fleet_results(runs["graph"], runs["eager"],
                                    f"{what} S={s} replayed vs eager")
        if not n_det:
            fail(f"{what} S={s}: no detections compared")
        if not all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip(ends["graph"], ends["eager"])):
            fail(f"{what} S={s}: the state after differs from eager")
        k_next = iter(range(1 + n, 10 ** 9))

        def window(mode, m=3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(m):
                fleets[mode].process_batch(*inp(next(k_next)))
            return m * s * BATCH / (time.perf_counter() - t0)

        fps = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            fps[mode].append(window(mode))
        out[s] = {"fps": {m: float(np.median(v)) for m, v in fps.items()},
                  "fps_windows": fps,
                  "assoc_launches_per_batch":
                      counts["graph"]["assoc_greedy"] / (2 * n),
                  "host_syncs": syncs, "detections": n_det}
        del fleets, clip
    print(f"{what} at 1080p x 8 a stream through "
          f"MultiStreamEngine.process_batch: {FLEET_TRK_BATCHES} fleet "
          f"batches, reset(), the same again, replayed bit-equal to eager "
          f"each S; K4 launches a fleet batch "
          + ", ".join(f"S={s} {r['assoc_launches_per_batch']:g}"
                      for s, r in out.items())
          + f" (B x k = {BATCH * per_frame[0]}); frames/s in all, eager / "
          "graph: " + "; ".join(f"S={s} {r['fps']['eager']:.1f} / "
                                f"{r['fps']['graph']:.1f}"
                                for s, r in out.items())
          + f" ({card})", flush=True)
    return out


def graph_trackers_phase(model: str, card: str) -> dict:
    """``[graph] trackers``: bytetrack, ocsort, deepsort, strongsort (GMC
    on) and botsort with GMC at 1080p x 8 bf16 behind the chain (K1-K3,
    K6 and K4 in one graph), frames rendered on the card. Each: SORT +
    geometry ms eager (``tools/bench.py::stage_ms``, GMC and the
    descriptors included) against captured (``graph_stage_ms``);
    device-resident frames/s eager and replayed, in turns, launches
    exact in every window; launches a batch. Every engine must replay
    (``step_mode == "graph"``). Then the fleet of TRACKER_FLEETS at S =
    1, 2, 4, 8 through ``MultiStreamEngine``
    (:func:`fleet_tracker_scaling`)."""
    import torch
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.io_video import DeviceSyntheticSource
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.tools.bench import graph_stage_ms, stage_ms
    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    out = {}
    for name, over in TRACKER_GRAPH_PATHS.items():
        t0 = time.perf_counter()
        eng = PipelineEngine(merge(pipeline_cfg(model), {"tracking": over}),
                             device=GRAPH_DEVICE)
        if eng.step_mode != "graph":
            fail(f"[graph] trackers {name}: runs {eng.step_mode} "
                 f"({eng.eager_reason})")
        per_frame = _assoc_of(name)
        render = DeviceSyntheticSource(WIDTH, HEIGHT, num_vehicles=6,
                                       seed=0, device=eng.device) \
            .make_render_fn(BATCH)
        steps = torch.arange(BATCH, device=eng.device,
                             dtype=torch.float32) / 30.0
        rendered = {}

        def inputs(k):
            if k not in rendered:
                if len(rendered) > 40:
                    rendered.clear()
                rendered[k] = render(k * BATCH)
            return rendered[k], k * BATCH / 30.0 + steps

        # one eager batch first: the process's first one searches
        # cuDNN's algorithms (cudnn.benchmark), which no window should time
        eng.step(*inputs(0), want_proc=False)
        modes = {"eager": eng.step, "graph": eng.step_batch}
        eng.step_batch(*inputs(0), want_proc=False)   # the capture
        fps = {m: [] for m in modes}
        counts = {}
        k = 1
        for mode in ("eager", "graph", "graph", "eager"):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            resident_run(eng, modes[mode], inputs, k, TRK_FPS_BATCHES)
            torch.cuda.synchronize()
            fps[mode].append(TRK_FPS_BATCHES * BATCH
                             / (time.perf_counter() - t1))
            n = TRK_FPS_BATCHES
            counts[mode] = exact_launches(
                f"[graph] trackers {name} {mode}",
                {**{c: n for c in PRE_KERNELS},
                 **tail_want(n, n * BATCH, *per_frame)})
            k += TRK_FPS_BATCHES
        frames_np = render(k * BATCH).cpu().numpy()
        ts_np = 2000.0 + np.arange(BATCH) / 30.0
        stages = {"eager": stage_ms(eng, frames_np, ts_np),
                  "graph": graph_stage_ms(eng, frames_np, ts_np)}
        med = {m: float(np.median(v)) for m, v in fps.items()}
        row = {"step_mode": eng.step_mode, "fps": fps, "fps_median": med,
               "stage_ms": stages,
               "launches_per_batch": {
                   m: {c: v / TRK_FPS_BATCHES for c, v in cnt.items()}
                   for m, cnt in counts.items()}}
        sort_ms = {m: st["sort_geometry"] for m, st in stages.items()}
        print(f"[graph] trackers {name}: step_mode {eng.step_mode}; SORT + "
              f"geometry ms " + json.dumps({m: round(v, 3) for m, v in
                                            sort_ms.items()})
              + "; frames/s device-resident, 1080p x 8 bf16, "
              + ", ".join(f"{m} {med[m]:.1f} {[round(v, 1) for v in fps[m]]}"
                          for m in fps)
              + "; launches a batch "
              + json.dumps(row["launches_per_batch"]["graph"])
              + f" ({card}); {time.perf_counter() - t0:.1f} s", flush=True)
        del eng
        rendered.clear()
        if name in TRACKER_FLEETS:
            row["fleet"] = fleet_tracker_scaling(model, name, card)
        out[name] = row
    print(f"[graph] trackers: the phase ran "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------------
# K7 deform_sample and the RT-DETR-L step replayed from a CUDA graph

RTDETR_NPZ = "rtdetr_l_synthetic_256.npz"
DEFORM_RTOL, DEFORM_ATOL = 1e-5, 1e-5   # f32 sums of O(1) values
# scalar operations, as K7 computes them: per channel and point the four
# corner products and sums and the point's weighting (10); per point its
# location, corner weights, bounds and rows (~40); per logit the softmax
# (max, subtract, exp, sum, divide: ~8 with the butterflies)
DEFORM_OPS_PER_CHANNEL_POINT = 10
DEFORM_OPS_PER_POINT = 40
DEFORM_OPS_PER_LOGIT = 8
# K8 against its plain version: the value and box gradients are sums taken
# by atomics (their order changes from run to run), the others sums over
# lanes in another order; ATOL is times the gradient's largest magnitude
DEFORM_BWD_RTOL, DEFORM_BWD_ATOL = 1e-4, 1e-5
# scalar operations, as K8 computes them: per channel and point the four
# corners' v·g products, the value-gradient product, compare and atomic,
# the S / Dx / Dy terms (~12 each corner) and three 5-step butterflies
# (15); per point K7's ~40 plus the offset and box chain (~20); per logit
# the softmax and its backward (~16)
DEFORM_BWD_OPS_PER_CHANNEL_POINT = 63
DEFORM_BWD_OPS_PER_POINT = 60
DEFORM_BWD_OPS_PER_LOGIT = 16
TRAIN_DEFORM = (640, 4)            # RT-DETR-L's training imgsz and batch
RT_GRAPH_BATCHES = 8               # replayed RT-DETR batches held to eager
RT_FPS_BATCHES = 8                 # batches a timed window


def rtdetr_model_path() -> str:
    return str(Path(__file__).resolve().parent / "assets" / RTDETR_NPZ)


def decoder_inputs(nq: int, frames: np.ndarray) -> list:
    """The deformable sampling's inputs as RT-DETR-L's decoder makes them
    (the asset at 640, bf16 convs, ``nq`` queries) on ``frames``: one
    (off, logits, refer, values, shapes) a decoder layer, recorded on
    their way into ``ops/deform.py::deform_sample`` (the decoder's
    ``sample``)."""
    import torch
    from roadvision_tpu_torch.detect.rtdetr_torch import RTDETRTorch
    from roadvision_tpu_torch.ops.deform import deform_sample
    det = RTDETRTorch({"model": rtdetr_model_path(), "imgsz": 640,
                       "num_queries": nq, "max_det": 100}, device="cuda")
    m = det.model
    seen = []

    def record(off, logits, refer, values, shapes, **kw):
        seen.append((off.clone(), logits.clone(), refer.clone(),
                     values.clone(), list(shapes)))
        return deform_sample(off, logits, refer, values, shapes, **kw)
    with torch.inference_mode():
        imgs = det.letterbox(torch.from_numpy(frames).cuda())[0]
        m.dec(m.features(imgs), det.num_queries, det.decoder_layers,
              sample=record)
    return seen


def deform_cases(rng, shapes, nq: int, edges: bool = False):
    """Decoder-like K7 inputs on the card: offsets of a few points,
    logits, boxes in (0.05, 0.95), values. ``edges``: boxes (0.5, 0.5, 1,
    1) and offsets that put points on and just outside the map edges, and
    one NaN location."""
    import torch
    from roadvision_tpu_torch.models import rtdetr as T
    rows = sum(h * w for h, w in shapes)
    off = rng.randn(BATCH, nq, T.NH, T.NL, T.NDP, 2) * 3
    if edges:
        for lvl, (hl, wl) in enumerate(shapes):
            locs = np.array([0.0, 0.5 / wl, (wl - 0.5) / wl, 1.0,
                             -0.5 / wl, 1.0 + 0.5 / wl, -0.25, 1.25])
            off[:, :, :, lvl] = (rng.choice(locs, off[:, :, :, lvl].shape)
                                 - 0.5) * 8.0
        off[0, 1, 2, 0, 1, 0] = np.nan
    refer = np.full((BATCH, nq, 4), 0.5) if edges else \
        rng.uniform(0.05, 0.95, (BATCH, nq, 4))
    if edges:
        refer[..., 2:] = 1.0
    arrays = (off, rng.randn(BATCH, nq, T.NH, T.NL * T.NDP), refer,
              rng.randn(BATCH, rows, T.NH, T.HD // T.NH))
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays] \
        + [list(shapes)]


def deform_rows_touched(off, refer, values, shapes) -> int:
    """Distinct value rows (batch, map row, head) the corners of these
    inputs read, each clamped into its level as K7 reads it."""
    import torch
    b, nq, nh, nl, ndp, _ = off.shape
    loc = refer[:, :, None, None, None, :2] \
        + off / ndp * refer[:, :, None, None, None, 2:] * 0.5
    keys, start = [], 0
    bi = torch.arange(b, device=off.device).view(b, 1, 1, 1)
    hi = torch.arange(nh, device=off.device).view(1, 1, nh, 1)
    rows = values.shape[1]
    for lvl, (hl, wl) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0] * wl - 0.5)
        y0 = torch.floor(loc[:, :, :, lvl, :, 1] * hl - 0.5)
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            r = ((y0 + dy).clamp(0, hl - 1) * wl
                 + (x0 + dx).clamp(0, wl - 1)).nan_to_num(0.0).long()
            keys.append(((bi * rows + start + r) * nh + hi).reshape(-1))
        start += hl * wl
    return int(torch.unique(torch.cat(keys)).numel())


def deform_bound(off, logits, refer, values, shapes) -> dict:
    """K7's bound on these inputs: offsets, logits and boxes read once,
    the output written once and the value rows its corners touch read
    once (in the values' dtype; f32 rows are read whole when K7 rounds
    them to bf16), against its scalar operations."""
    b, nq, nh, nl, ndp, _ = off.shape
    dh = values.shape[-1]
    rows = deform_rows_touched(off, refer, values, shapes)
    nbytes = 4 * (off.numel() + logits.numel() + refer.numel()
                  + b * nq * nh * dh) + rows * dh * values.element_size()
    warps = b * nq * nh
    nops = warps * (nl * ndp * (dh * DEFORM_OPS_PER_CHANNEL_POINT
                                + DEFORM_OPS_PER_POINT
                                + DEFORM_OPS_PER_LOGIT))
    return {**bound(nbytes, nops), "rows_touched": rows,
            "bytes": nbytes, "ops": nops}


def grid_sample_composition(off, logits, refer, values, shapes):
    """The same function by PyTorch calls (the MSDeformAttn reference
    composition): the softmax, the locations, three ``F.grid_sample``
    calls (bilinear, zeros, ``align_corners=False``) and the
    attention-weighted sum. A yardstick, never the port's route."""
    import torch
    import torch.nn.functional as F
    b, nq, nh, nl, ndp, _ = off.shape
    dh = values.shape[-1]
    attw = logits.softmax(dim=-1).view(b, nq, nh, nl, ndp)
    loc = refer[:, :, None, None, None, :2] \
        + off / ndp * refer[:, :, None, None, None, 2:] * 0.5
    grids = 2.0 * loc - 1.0
    out = torch.zeros((b * nh, dh, nq), device=off.device)
    start = 0
    for lvl, (hl, wl) in enumerate(shapes):
        v = values[:, start:start + hl * wl].float().permute(0, 2, 3, 1) \
            .reshape(b * nh, dh, hl, wl)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4) \
            .reshape(b * nh, nq, ndp, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)           # (B·NH, dh, NQ, P)
        a = attw[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * nh, 1, nq,
                                                           ndp)
        out = out + (s * a).sum(dim=-1)
        start += hl * wl
    return out.view(b, nh, dh, nq).permute(0, 3, 1, 2)


def train_decoder_inputs() -> list:
    """RT-DETR-L's training sampling (the asset, f32, TF32 off, one
    AdamW step of ``make_train_step_rtdetr`` at TRAIN_DEFORM on a
    synthetic batch): one (grad_out, off, logits, refer, values, shapes)
    a decoder layer, the inputs recorded on their way into
    ``ops/deform.py::deform_sample`` and the output gradient by a hook
    on its output."""
    import torch
    from roadvision_tpu_torch.detect import dataset as ds
    from roadvision_tpu_torch.models import rtdetr as R
    from roadvision_tpu_torch.models.yolo import weights as W
    imgsz, nb = TRAIN_DEFORM
    model = _model(W.import_npz(Path(rtdetr_model_path())), "cuda")
    step, init = _train_step("rtdetr", 1e-4)
    batch = _on(next(ds.synthetic_batches(nb, imgsz=imgsz, seed=2)),
                torch.device("cuda"))
    seen, wrapped = [], R.deform_sample
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def record(off, logits, refer, values, shapes, **kw):
        out = wrapped(off, logits, refer, values, shapes, **kw)
        entry = [None] + [t.detach().clone()
                          for t in (off, logits, refer, values)] \
            + [list(shapes)]
        seen.append(entry)
        out.register_hook(lambda g, e=entry: e.__setitem__(
            0, g.detach().clone()))
        return out
    R.deform_sample = record
    try:
        step(model, init(model), *batch)
    finally:
        R.deform_sample = wrapped
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    torch.cuda.synchronize()
    if len(seen) != RTDETR_LAYERS or any(e[0] is None for e in seen):
        fail(f"[kernels] deform_sample_bwd: recorded {len(seen)} training "
             f"layers, not {RTDETR_LAYERS} with their gradients")
    return seen


def k8_compare(got, want, what: str) -> dict:
    """K8 against its plain backward, gradient by gradient (off, logits,
    refer, values): non-finite values in the same tensors, the rest
    within DEFORM_BWD_RTOL / DEFORM_BWD_ATOL times the gradient's
    largest magnitude; the largest difference and whether the
    non-finite places are the same too."""
    import torch
    errs, rel, places = [], [], True
    for name, g, w in zip(("off", "logits", "refer", "values"), got, want):
        bad_g, bad_w = ~torch.isfinite(g), ~torch.isfinite(w)
        if bool(bad_g.any()) != bool(bad_w.any()):
            fail(f"[kernels] deform_sample_bwd {what}: {name} gradient "
                 f"non-finite {int(bad_g.sum())} times, the plain "
                 f"backward's {int(bad_w.sum())}")
        places = places and torch.equal(bad_g, bad_w)
        ok = ~(bad_g | bad_w)
        if not ok.any():
            continue
        scale = float(w[ok].abs().max())
        err = float((g[ok] - w[ok]).abs().max())
        errs.append(err)
        rel.append(err / scale if scale else 0.0)
        if not torch.allclose(g[ok], w[ok], rtol=DEFORM_BWD_RTOL,
                              atol=DEFORM_BWD_ATOL * scale):
            fail(f"[kernels] deform_sample_bwd {what}: {name} max |K8 - "
                 f"plain| {err:.3e} over rtol {DEFORM_BWD_RTOL}, atol "
                 f"{DEFORM_BWD_ATOL} x {scale:.3e}")
    return {"max_abs_err": max(errs), "max_err_over_scale": max(rel),
            "nonfinite": int(sum(int((~torch.isfinite(t)).sum())
                                 for t in want)),
            "nonfinite_places_equal": bool(places)}


def deform_bwd_bound(grad_out, off, logits, refer, values, shapes) -> dict:
    """K8's bound on these inputs: the output gradient, offsets, logits
    and boxes read once, the value rows its corners touch read once, the
    offset, logit and box gradients written once and the whole value
    gradient written once (the zero fill), against its scalar
    operations."""
    b, nq, nh, nl, ndp, _ = off.shape
    dh = values.shape[-1]
    rows = deform_rows_touched(off, refer, values, shapes)
    small = grad_out.numel() + 2 * (off.numel() + logits.numel()
                                    + refer.numel())
    nbytes = 4 * (small + values.numel()) + rows * dh * 4
    nops = b * nq * nh * (nl * ndp * (dh * DEFORM_BWD_OPS_PER_CHANNEL_POINT
                                      + DEFORM_BWD_OPS_PER_POINT
                                      + DEFORM_BWD_OPS_PER_LOGIT))
    return {**bound(nbytes, nops), "rows_touched": rows,
            "bytes": nbytes, "ops": nops}


def backward_of(fn, args, grad_out):
    """A callable that runs only the backward of ``fn(*args)`` (off,
    logits, refer, values needing gradients) for ``grad_out``: autograd
    over a graph built once and kept."""
    import torch
    ins = [t.detach().clone().requires_grad_(True) for t in args[:4]]
    out = fn(*ins, *args[4:])
    return lambda: torch.autograd.grad(out, ins, grad_out,
                                       retain_graph=True)


def check_deform_backward(rng) -> dict:
    """``[kernels]`` K8 ``deform_sample_bwd`` against
    ``deform_sample_backward_plain`` on the card: RT-DETR-L's own
    training inputs and output gradients (``train_decoder_inputs``,
    every layer), random decoder-like inputs at 4 × 300 (the training
    shape) and 8 × 100, non-square levels, and points on and just
    outside the edges with a NaN location; then timed at layer 0 of the
    training inputs (the wrapper: its zero fills and K8) beside the
    plain backward, the backward of the ``grid_sample`` composition and
    the bound. Returns (K8's row, the training inputs)."""
    import torch
    from roadvision_tpu_torch.ops import deform as D
    square = [(80, 80), (40, 40), (20, 20)]
    train = train_decoder_inputs()
    cases = {f"train {TRAIN_DEFORM[1]}x300 layer {i}": e
             for i, e in enumerate(train)}
    for b, nq, shapes, edges, name in (
            (4, 300, square, False, "random 4x300"),
            (8, 100, square, False, "random 8x100"),
            (4, 300, [(48, 80), (24, 40), (12, 20)], False, "ragged 4x300"),
            (4, 300, square, True, "edges 4x300"),
            (8, 100, square, True, "edges 8x100")):
        args = [t[:b] for t in deform_cases(rng, shapes, nq, edges)[:4]]
        go = torch.from_numpy(rng.randn(b, nq, 8, 32).astype(np.float32))
        cases[name] = [go.cuda()] + args + [list(shapes)]
    results = {}
    for name, args in cases.items():
        got = D._sample_backward_cuda(*args)
        want = D.deform_sample_backward_plain(*args)
        torch.cuda.synchronize()
        results[name] = k8_compare(got, want, name)
    for name in ("edges 4x300", "edges 8x100"):
        if results[name]["nonfinite"] == 0:
            fail(f"[kernels] deform_sample_bwd {name}: the NaN location "
                 f"gave no non-finite gradient")
    main = train[0]
    fwd = main[1:]
    row = kernel_times(lambda: D._sample_backward_cuda(*main),
                       backward_of(D.deform_sample_plain, fwd, main[0]))
    row["library_ms"] = cuda_ms(backward_of(grid_sample_composition, fwd,
                                            main[0]), 5, 1)
    row.update(deform_bwd_bound(*main))
    # the wrapper's two parts apart, 50 launches in a graph each: its zero
    # fills alone, and K8 alone into buffers zero-filled once (adding up
    # over the replays)
    go = D._aligned(main[0])
    fills = graph_ms(lambda: D._backward_buffers(*fwd[:4]))
    bufs = D._backward_buffers(*fwd[:4])
    alone = graph_ms(lambda: D._launch_backward(go, *fwd, bufs))
    row.update(zero_fill_ms=fills["graph_ms"],
               zero_fill_flushed_ms=fills["graph_flushed_ms"],
               kernel_ms=alone["graph_ms"],
               kernel_flushed_ms=alone["graph_flushed_ms"])
    errs = [r["max_abs_err"] for r in results.values()]
    row.update(max_abs_err=max(errs),
               max_err_over_scale=max(r["max_err_over_scale"]
                                      for r in results.values()),
               nonfinite_places_equal=all(r["nonfinite_places_equal"]
                                          for r in results.values()),
               cases=results, launches_per_step=RTDETR_LAYERS,
               library="the backward of three F.grid_sample calls + the "
                       "attention-weighted sum (a composition, not one "
                       "call)", fleet={})
    print(f"[kernels] deform_sample_bwd: {len(results)} cases against the "
          f"plain backward (RT-DETR-L's training inputs and output "
          f"gradients at {TRAIN_DEFORM[0]} x {TRAIN_DEFORM[1]}, every "
          f"layer; random 4 x 300 / 8 x 100; non-square levels; edges and "
          f"a NaN location): max |K8 - plain| {row['max_abs_err']:.3e}, "
          f"{row['max_err_over_scale']:.2e} of the gradient's largest "
          f"(rtol {DEFORM_BWD_RTOL}, atol {DEFORM_BWD_ATOL} x it); "
          f"non-finite in the same tensors, at the same places: "
          f"{row['nonfinite_places_equal']}", flush=True)
    print(f"[kernels] deform_sample_bwd, layer 0 of RT-DETR-L training at "
          f"{TRAIN_DEFORM[0]} x {TRAIN_DEFORM[1]}, 300 queries, f32: "
          f"{fmt_times(row)} (the plain backward: autograd of the "
          f"12-gather version); grid_sample composition's backward "
          f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']}: {row['bytes'] / 1e6:.2f} MB, "
          f"{row['rows_touched']} value rows touched); {RTDETR_LAYERS} "
          f"launches a train step", flush=True)
    print(f"[kernels] deform_sample_bwd's wrapper apart, in a graph: its "
          f"zero fills {row['zero_fill_ms']:.4f} ms warm, "
          f"{row['zero_fill_flushed_ms']:.4f} ms flushed; K8 alone "
          f"{row['kernel_ms']:.4f} ms warm, {row['kernel_flushed_ms']:.4f} "
          f"ms flushed", flush=True)
    return row, train


def k7_compare(got, want, what: str) -> dict:
    """K7 against its plain version: NaN where it is NaN, the rest within
    DEFORM_RTOL / DEFORM_ATOL; bit-equal or the largest difference."""
    import torch
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        fail(f"[kernels] deform_sample {what}: NaN at other places than "
             f"the plain version's")
    err = float((got[~nan] - want[~nan]).abs().max()) if (~nan).any() \
        else 0.0
    if not torch.allclose(got[~nan], want[~nan], rtol=DEFORM_RTOL,
                          atol=DEFORM_ATOL):
        fail(f"[kernels] deform_sample {what}: max |K7 - plain| {err:.3e} "
             f"over rtol {DEFORM_RTOL}, atol {DEFORM_ATOL}")
    bits = torch.equal(torch.where(nan, 0.0, got).view(torch.int32),
                       torch.where(nan, 0.0, want).view(torch.int32))
    return {"max_abs_err": err, "bit_equal": bool(bits),
            "nan": int(nan.sum())}


def check_deform_kernel(frames: np.ndarray) -> dict:
    """``[kernels]`` K7 ``deform_sample`` against ``deform_sample_plain``
    on the card: the decoder's own inputs (RT-DETR-L at 640 on a road
    batch, every layer, 100 and 300 queries) with f32 values rounded to
    bf16 (the serving default) and kept f32; random decoder-like inputs
    at 8 × 100 and 8 × 300 (levels 80², 40², 20²) in f32, f32 as bf16 and
    bf16 storage; non-square levels; points on and just outside the
    edges and a NaN location; RT-DETR-L's training inputs at
    TRAIN_DEFORM (every layer, f32). Timed on layer 0's inputs at 100
    queries four ways (:func:`kernel_times`) beside the plain version,
    the ``grid_sample`` composition and the bound, and at the training
    shape in f32. First K8 (:func:`check_deform_backward`), whose
    training inputs these are."""
    import torch
    from roadvision_tpu_torch.ops import deform as D
    row8, train = check_deform_backward(np.random.RandomState(17))
    rng = np.random.RandomState(15)
    square = [(80, 80), (40, 40), (20, 20)]
    cases = {}
    with torch.inference_mode():
        layers = {nq: decoder_inputs(nq, frames) for nq in (100, 300)}
        for nq, seen in layers.items():
            for i, args in enumerate(seen):
                for bf16 in (True, False):
                    cases[f"decoder {nq} layer {i}"
                          f"{' bf16' if bf16 else ' f32'}"] = (args, bf16)
        for nq in (100, 300):
            args = deform_cases(rng, square, nq)
            cases[f"random 8x{nq} f32"] = (args, False)
            cases[f"random 8x{nq} f32 as bf16"] = (args, True)
            cases[f"random 8x{nq} bf16"] = (
                args[:3] + [args[3].to(torch.bfloat16), args[4]], False)
        cases["ragged 8x100 as bf16"] = (deform_cases(
            rng, [(48, 80), (24, 40), (12, 20)], 100), True)
        cases["edges 8x100 f32"] = (deform_cases(rng, square, 100, True),
                                    False)
        cases["edges 8x300 as bf16"] = (deform_cases(rng, square, 300, True),
                                        True)
        for i, e in enumerate(train):
            cases[f"train {TRAIN_DEFORM[1]}x300 layer {i} f32"] = (e[1:],
                                                                False)
        results = {}
        for name, (args, bf16) in cases.items():
            got = D.deform_sample(*args, bf16_vals=bf16)
            want = D.deform_sample_plain(*args, bf16_vals=bf16)
            torch.cuda.synchronize()
            results[name] = k7_compare(got, want, name)
        if results["edges 8x100 f32"]["nan"] != 32:
            fail("[kernels] deform_sample: the NaN location gave "
                 f"{results['edges 8x100 f32']['nan']} NaN outputs, not 32")
        main = layers[100][0]
        row = kernel_times(lambda: D.deform_sample(*main, bf16_vals=True),
                           lambda: D.deform_sample_plain(*main,
                                                         bf16_vals=True))
        row["library_ms"] = cuda_ms(lambda: grid_sample_composition(*main),
                                    5, 1)
        lib = grid_sample_composition(*main)
        plain32 = D.deform_sample_plain(*main, bf16_vals=False)
        row["library_max_abs_err_f32"] = float((lib - plain32).abs().max())
        row["paired_plain_ms"] = cuda_ms(
            lambda: D.deform_sample_plain(*main, bf16_vals=True, paired=True),
            5, 1)
        row["ms_300"] = cuda_ms(lambda: D.deform_sample(
            *layers[300][0], bf16_vals=True), 50)
        row.update(deform_bound(*main))
        row["bound_300"] = deform_bound(*layers[300][0])
        # the training shape, f32 values (the card's training path)
        t0 = train[0][1:]
        row["ms_train"] = cuda_ms(lambda: D.deform_sample(*t0), 50)
        row["flushed_ms_train"] = cuda_ms_flushed(lambda: D.deform_sample(
            *t0))
        row["plain_ms_train"] = cuda_ms(lambda: D.deform_sample_plain(*t0),
                                        5, 1)
        row["bound_train"] = deform_bound(*t0)
    floor = graph_ms(empty_kernel())["graph_ms"]
    errs = [r["max_abs_err"] for r in results.values()]
    row.update(max_abs_err=max(errs), launch_floor_ms=floor,
               bit_equal=all(r["bit_equal"] for r in results.values()),
               cases=results, launches_per_forward=RTDETR_LAYERS,
               library="three F.grid_sample calls + the attention-weighted "
                       "sum (a composition, not one call)",
               fleet={})
    n_bits = sum(r["bit_equal"] for r in results.values())
    print(f"[kernels] deform_sample: {len(results)} cases against the plain "
          f"version (decoder inputs of RT-DETR-L at 640 x 8, 100 and 300 "
          f"queries, every layer, bf16 and f32 values; random 8 x 100 / 300 "
          f"in f32, f32 as bf16, bf16; non-square levels; edges and a NaN "
          f"location): {n_bits} bit-equal, max |K7 - plain| "
          f"{row['max_abs_err']:.3e} (rtol {DEFORM_RTOL}, atol "
          f"{DEFORM_ATOL}), NaN where the plain version's are", flush=True)
    print(f"[kernels] deform_sample, layer 0 of RT-DETR-L at 640 x 8, 100 "
          f"queries, bf16 values: {fmt_times(row)} (12-gather plain; 3-gather "
          f"plain {row['paired_plain_ms']:.4f} ms); 300 queries "
          f"{row['ms_300']:.4f} ms warm; grid_sample composition "
          f"{row['library_ms']:.4f} ms (max |Δ| "
          f"{row['library_max_abs_err_f32']:.2e} against f32 plain); bound "
          f"{row['bound_ms']:.6f} ms "
          f"({row['bound_by']}: {row['bytes'] / 1e6:.2f} MB, "
          f"{row['rows_touched']} value rows touched); launch floor "
          f"{floor:.4f} ms; {RTDETR_LAYERS} launches a forward", flush=True)
    print(f"[kernels] deform_sample at RT-DETR-L's training shape "
          f"({TRAIN_DEFORM[1]} x 300 queries, f32 values, layer 0): "
          f"{row['ms_train']:.4f} ms warm, {row['flushed_ms_train']:.4f} ms "
          f"flushed; plain {row['plain_ms_train']:.4f} ms; bound "
          f"{row['bound_train']['bound_ms']:.6f} ms "
          f"({row['bound_train']['bytes'] / 1e6:.2f} MB)", flush=True)
    return {"deform_sample": row, "deform_sample_bwd": row8}


def rtdetr_forward_ms(eng, frames) -> dict:
    """RT-DETR-L's forward on one stretched batch: eager by stage
    (:func:`rtdetr_stage_ms`'s backbone, encoder, decoder, host clock,
    synchronised), the decoder's kernel launches a call by torch.profiler
    and the whole forward and the decoder each captured in a CUDA graph
    and replayed (CUDA events, 10 replays)."""
    import torch
    from roadvision_tpu_torch.runtime.graph import CapturedStep
    from roadvision_tpu_torch.tools.profile_rtdetr import launches_of
    det = eng.detector
    m = det.model
    x = torch.from_numpy(frames).to(eng.device)
    out = {"eager": rtdetr_stage_ms(eng, frames, "rtdetr", card_line())}
    with torch.inference_mode():
        imgs = det.letterbox(eng.pipeline.apply_batch(x))[0]
        feats = m.enc(*m.backbone(imgs.permute(0, 3, 1, 2)
                                  .to(m.compute_dtype)))

        def dec():
            return m.dec(feats, det.num_queries, det.decoder_layers)

        def fwd(_, a):
            return m(a, det.num_queries, det.decoder_layers), None

        out["decoder_launches"] = launches_of(dec, eng.device)[
            "kernel_launches"]
        graphs = {"forward": (CapturedStep(fwd, None, (imgs,)), (imgs,)),
                  "decoder": (CapturedStep(lambda _, *f: (dec(), None),
                                           None, tuple(feats)), tuple(feats))}
    out["graph"] = {}
    for name, (g, args) in graphs.items():
        g(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            g(*args)
        end.record()
        end.synchronize()
        out["graph"][name] = start.elapsed_time(end) / 10
    return out


def rtdetr_graph_phase(card: str) -> dict:
    """``[graph] rtdetr``: RT-DETR-L (the asset, stretched to 640, bf16,
    ``num_queries`` at its default) behind the main chain at 1080p x 8 on
    frames rendered on the card, which must run ``step_mode == "graph"``.
    One eager batch under ``torch.cuda.set_sync_debug_mode("error")`` (no
    host read); RT_GRAPH_BATCHES replayed batches against as
    many eager ones from the same state (ids, classes, counts exact,
    boxes BOX_TOL, confidences CONF_TOL) with the same launch counts,
    exact (K1-K3 once a batch, K4 once a frame, K7 RTDETR_LAYERS, no
    K6); frames/s device-resident eager and replayed in turns; the
    forward eager by stage and replayed, the decoder's launches.
    ``[graph] rtdetr_demo``: configs/rtdetr_demo.yaml as shipped (256² x
    8, the impulse-keyed gate, classes_keep, SORT, homography) on road
    frames, some with impulse noise: graph mode, replayed batches (their
    processed frames too) against eager ones, K3 twice a batch."""
    import torch
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.config import merge
    from roadvision_tpu_torch.io_video import DeviceSyntheticSource
    from roadvision_tpu_torch.runtime import PipelineEngine
    from roadvision_tpu_torch.track import sort as tsort
    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    cfg = merge(pipeline_cfg(rtdetr_model_path()),
                {"detect": {"model": rtdetr_model_path(), "imgsz": 640}})
    eng = PipelineEngine(cfg, device=GRAPH_DEVICE)
    if eng.step_mode != "graph":
        fail(f"[graph] rtdetr: runs {eng.step_mode} ({eng.eager_reason})")
    render = DeviceSyntheticSource(WIDTH, HEIGHT, num_vehicles=6, seed=0,
                                   device=eng.device).make_render_fn(BATCH)
    steps = torch.arange(BATCH, device=eng.device,
                         dtype=torch.float32) / 30.0
    rendered = {}

    def inputs(k):
        if k not in rendered:
            rendered[k] = render(k * BATCH)
        return rendered[k], k * BATCH / 30.0 + steps

    out = {"step_mode": eng.step_mode, "eager_reason": eng.eager_reason}
    with torch.inference_mode():
        eng.step(*inputs(0), want_proc=False)       # constants, cuDNN
        probe = inputs(1)
        out["eager_syncs"] = count_syncs(
            lambda: eng.step(*probe, want_proc=False))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step(*probe, want_proc=False)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            fail(f"[graph] rtdetr: an eager step reads the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"[graph] rtdetr: an eager batch makes {out['eager_syncs']} host "
          f"syncs (torch.cuda.set_sync_debug_mode)", flush=True)
    modes = (("graph", eng.step_batch), ("eager", eng.step))
    eng.step_batch(*inputs(0), want_proc=False)       # the capture
    runs, counts = {}, {}
    per_batch = {"clahe_tile_luts": 1, "clahe_apply": 1, "median_k": 1,
                 "nms_keep": 0, "assoc_greedy": BATCH, "assoc_auction": 0,
                 "deform_sample": RTDETR_LAYERS, "deform_sample_bwd": 0}
    for mode, fn in modes:
        eng.reset()
        kernels.reset_launch_counts()
        tsort.reset_host_syncs()
        runs[mode] = resident_run(eng, fn, inputs, 0, RT_GRAPH_BATCHES,
                                  keep=True)
        counts[mode] = add_to_totals(dict(kernels.launch_counts))
        want = {k: RT_GRAPH_BATCHES * v for k, v in per_batch.items()}
        if counts[mode] != want:
            launch_mismatch(f"[graph] rtdetr {mode}: launches "
                            f"{counts[mode]}, expected {want}")
        if tsort.host_syncs:
            fail(f"[graph] rtdetr {mode}: {tsort.host_syncs} flag reads")
    worst = {"box": 0.0, "conf": 0.0, "n": 0}
    for i, (g, e) in enumerate(zip(runs["graph"], runs["eager"])):
        r = same_arrays(g, e, f"[graph] rtdetr batch {i} graph vs eager")
        worst = {"box": max(worst["box"], r["box"]),
                 "conf": max(worst["conf"], r["conf"]),
                 "n": worst["n"] + r["n"]}
    if worst["n"] < RT_GRAPH_BATCHES * BATCH:
        fail(f"[graph] rtdetr: only {worst['n']} detections compared")
    syncs = count_syncs(lambda: [eng.step_batch(*inputs(k),
                                                want_proc=False)
                                 for k in range(4)]) / 4
    if syncs:
        fail(f"[graph] rtdetr: {syncs} host syncs a replayed batch")
    print(f"[graph] rtdetr step_mode graph: {RT_GRAPH_BATCHES} replayed "
          f"1080p x {BATCH} bf16 batches (RT-DETR-L at 640, "
          f"{eng.detector.num_queries} queries) equal "
          f"{RT_GRAPH_BATCHES} eager ones from the same state "
          f"({worst['n']} detections; ids, classes, counts exact; boxes "
          f"{worst['box']:.2e} px, conf {worst['conf']:.2e}); launches a "
          f"batch " + json.dumps({k: v / RT_GRAPH_BATCHES for k, v in
                                  counts["graph"].items()})
          + f" both ways; host syncs a replayed batch {syncs:g}",
          flush=True)
    out.update(launches=counts, worst=worst)
    fps = {m: [] for m, _ in modes}
    k = RT_GRAPH_BATCHES
    for mode in ("eager", "graph", "graph", "eager"):
        fn = eng.step if mode == "eager" else eng.step_batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident_run(eng, fn, inputs, k, RT_FPS_BATCHES)
        torch.cuda.synchronize()
        fps[mode].append(RT_FPS_BATCHES * BATCH
                         / (time.perf_counter() - t0))
        k += RT_FPS_BATCHES
    rendered.clear()
    frames = render(k * BATCH + 50 * BATCH).cpu().numpy()
    fwd = rtdetr_forward_ms(eng, frames)
    med = {m: float(np.median(v)) for m, v in fps.items()}
    for m, _ in modes:
        print(f"[graph] rtdetr {m}: device-resident 1080p x {BATCH} "
              f"frames/s {med[m]:.1f} {[round(v, 1) for v in fps[m]]} "
              f"({card})", flush=True)
    print(f"[graph] rtdetr forward (8 x 640², bf16): eager "
          + json.dumps({s: round(v["median"], 3)
                        for s, v in fwd["eager"].items()})
          + f" ms (median of 5); replayed forward "
          f"{fwd['graph']['forward']:.3f} ms, decoder "
          f"{fwd['graph']['decoder']:.3f} ms; decoder launches a call "
          f"{fwd['decoder_launches']} ({card})", flush=True)
    out.update(fps=fps, fps_median=med, forward=fwd,
               demo=rtdetr_demo_graph(card))
    out["seconds"] = time.perf_counter() - t_phase
    del eng
    return out


def rtdetr_demo_graph(card: str) -> dict:
    """``[graph] rtdetr_demo``: configs/rtdetr_demo.yaml as shipped."""
    import torch
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.config import load_config
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    from roadvision_tpu_torch.runtime import PipelineEngine
    root = Path(__file__).resolve().parent
    cfg = load_config(str(root / "configs" / "rtdetr_demo.yaml"))
    cfg["detect"]["model"] = rtdetr_model_path()
    cam = cfg["camera"]
    eng = PipelineEngine(cfg, device=GRAPH_DEVICE)
    if eng.step_mode != "graph":
        fail(f"[graph] rtdetr_demo: runs {eng.step_mode} "
             f"({eng.eager_reason})")
    b = eng.batch_size
    src = SyntheticRoadSource(cam["width"], cam["height"], num_vehicles=3,
                              seed=1)
    rng = np.random.RandomState(2)
    batches = []
    for k in range(5):
        frames = np.stack([src.render(k * b + i) for i in range(b)])
        for i in range(1, b, 3):             # impulse noise: the chain runs
            hit = rng.rand(*frames.shape[1:3]) < 0.08
            frames[i][hit] = rng.choice([0, 255], (int(hit.sum()), 1))
        batches.append((torch.from_numpy(frames).to(eng.device),
                        torch.from_numpy(((k * b + np.arange(b)) / 30.0)
                                         .astype(np.float32))
                        .to(eng.device)))
    eng.step_batch(*batches[0])                        # the capture
    outs, counts = {}, {}
    for mode, fn in (("graph", eng.step_batch), ("eager", eng.step)):
        eng.reset()
        kernels.reset_launch_counts()
        outs[mode] = []
        for x, t in batches:
            proc, arrays = fn(x, t)
            outs[mode].append((proc.cpu().numpy(),
                               [a.cpu().numpy() for a in arrays]))
        counts[mode] = add_to_totals(dict(kernels.launch_counts))
        n = len(batches)
        want = {"clahe_tile_luts": n, "clahe_apply": n, "median_k": 2 * n,
                **tail_want(0, n * b, deform=n * RTDETR_LAYERS)}
        if counts[mode] != want:
            launch_mismatch(f"[graph] rtdetr_demo {mode}: launches "
                            f"{counts[mode]}, expected {want}")
    worst = {"box": 0.0, "conf": 0.0, "n": 0}
    ran = 0
    for i, ((pg, ag), (pe, ae)) in enumerate(zip(outs["graph"],
                                                 outs["eager"])):
        if not np.array_equal(pg, pe):
            fail(f"[graph] rtdetr_demo batch {i}: processed frames differ")
        ran += sum(not np.array_equal(pg[j], batches[i][0][j].cpu().numpy())
                   for j in range(b))
        r = same_arrays(ag, ae, f"[graph] rtdetr_demo batch {i}")
        worst = {"box": max(worst["box"], r["box"]),
                 "conf": max(worst["conf"], r["conf"]),
                 "n": worst["n"] + r["n"]}
    if worst["n"] == 0 or ran == 0:
        fail(f"[graph] rtdetr_demo: {worst['n']} detections, the chain ran "
             f"on {ran} frames")
    print(f"[graph] rtdetr_demo (configs/rtdetr_demo.yaml as shipped, "
          f"{cam['width']}x{cam['height']} x {b}): step_mode graph; "
          f"{len(batches)} replayed batches equal eager ones (processed "
          f"frames bit-equal, the gate ran the chain on {ran} frames; "
          f"{worst['n']} detections, boxes {worst['box']:.2e} px, conf "
          f"{worst['conf']:.2e}); launches a batch "
          + json.dumps({k: v / len(batches)
                        for k, v in counts["graph"].items()})
          + f" both ways ({card})", flush=True)
    return {"launches": counts, "worst": worst, "chain_frames": ran}


def profile_batch(engine, frames, ts) -> dict:
    """torch.profiler over one bf16 batch: device busy share, kernel
    launches, and the top kernels and host ops (full tables to
    chiprun_out/profile.txt)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.process_batch(frames, ts, want_proc=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.process_batch(frames, ts + 1.0, want_proc=False)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    # the hand-written kernels, by the names nvcc gives them
    ours = {name: e.self_device_time_total / 1e3 / e.count
            for name in ("clahe_tile_luts_kernel", "clahe_apply_kernel",
                         "median3_kernel")
            for e in kern if name in e.key}
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "kernel_launches": sum(e.count for e in kern),
           "port_kernels_ms": ours,
           "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/profile.txt").write_text(
        events.table(sort_by="self_cpu_time_total", row_limit=60) + "\n\n"
        + events.table(sort_by="self_device_time_total", row_limit=40))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from roadvision_tpu_torch import kernels
    from roadvision_tpu_torch.runtime import PipelineEngine

    card = card_line()
    print(f"[card] {card}", flush=True)

    t0 = time.perf_counter()
    kernels.build_all(verbose=True)
    print(f"[build] kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)

    if "--fleet-cards" in sys.argv[1:]:
        model = str(Path(__file__).resolve().parent / "assets"
                    / "yolov8n_synthetic_256.npz")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        line = fleet_cards_phase(model, card)
        Path("chiprun_out").mkdir(exist_ok=True)
        Path("chiprun_out/fleet_cards.json").write_text(
            json.dumps(line, indent=1))
        print(json.dumps(line), flush=True)
        print(card_line(), flush=True)
        return 0
    if "--multi-cards" in sys.argv[1:]:
        Path("chiprun_out").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory() as tmp:
            line = multi_cards_phase(card, Path(tmp))
        Path("chiprun_out/multi_cards.json").write_text(
            json.dumps(line, indent=1))
        print(f"[time] chip_smoke.py --multi-cards ran "
              f"{time.perf_counter() - T_START:.1f} s", flush=True)
        print(card_line(), flush=True)
        return 0
    if "--parallel-only" in sys.argv[1:]:
        Path("chiprun_out").mkdir(exist_ok=True)
        Path("chiprun_out/parallel.json").write_text(
            json.dumps(parallel_phase(card), indent=1))
        print(f"[time] chip_smoke.py --parallel-only ran "
              f"{time.perf_counter() - T_START:.1f} s", flush=True)
        return 0
    if "--tools-only" in sys.argv[1:]:
        model = str(Path(__file__).resolve().parent / "assets"
                    / "yolov8n_synthetic_256.npz")
        tools_phases(model, render_batches(1)[0][0], card)
        print("[kernels] launches on the tool paths "
              + json.dumps(PATH_TOTALS), flush=True)
        print(f"[time] chip_smoke.py --tools-only ran "
              f"{time.perf_counter() - T_START:.1f} s", flush=True)
        print(card_line(), flush=True)
        return 0
    if "--train-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as tmp:
            training = train_phase(card, Path(tmp))
            training["entry"] = entry_train(Path(tmp), card)
        Path("chiprun_out").mkdir(exist_ok=True)
        Path("chiprun_out/training.json").write_text(
            json.dumps(training, indent=1))
        print(f"[time] chip_smoke.py --train-only ran "
              f"{time.perf_counter() - T_START:.1f} s", flush=True)
        return 0
    if "--rtdetr-only" in sys.argv[1:]:
        torch.backends.cudnn.benchmark = True
        rows = check_deform_kernel(render_batches(1)[0][0])
        rt = rtdetr_graph_phase(card)
        Path("chiprun_out").mkdir(exist_ok=True)
        Path("chiprun_out/rtdetr_graph.json").write_text(json.dumps(
            {"rtdetr": rt, "kernels": rows}, indent=1, default=str))
        print(f"[time] chip_smoke.py --rtdetr-only ran "
              f"{time.perf_counter() - T_START:.1f} s", flush=True)
        print(card_line(), flush=True)
        return 0
    if "--trackers-only" in sys.argv[1:]:
        model = str(Path(__file__).resolve().parent / "assets"
                    / "yolov8n_synthetic_256.npz")
        line = graph_trackers_phase(model, card)
        Path("chiprun_out").mkdir(exist_ok=True)
        Path("chiprun_out/graph_trackers.json").write_text(
            json.dumps(line, indent=1, default=str))
        print(f"[time] chip_smoke.py --trackers-only ran "
              f"{time.perf_counter() - T_START:.1f} s", flush=True)
        print(card_line(), flush=True)
        return 0
    # seconds of each part of the whole run, printed at its end
    phase_s, last = {}, [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = round(now - last[0], 1)
        last[0] = now

    batches = render_batches(6)
    rows = check_kernels(batches[0][0])
    rows.update(check_tail_kernels())
    rows.update(check_deform_kernel(batches[0][0]))
    mark("kernels")
    if "--kernels-only" in sys.argv[1:]:
        return 0

    model = str(Path(__file__).resolve().parent / "assets"
                / "yolov8n_synthetic_256.npz")
    if "--graph-only" in sys.argv[1:]:
        graph = graph_phase(model, card)
        graph["trackers"] = graph_trackers_phase(model, card)
        graph["rtdetr"] = rtdetr_graph_phase(card)
        Path("chiprun_out").mkdir(exist_ok=True)
        Path("chiprun_out/graph.json").write_text(json.dumps(
            {"graph": graph, "kernels": rows}, indent=1, default=str))
        print(f"[time] chip_smoke.py --graph-only ran "
              f"{time.perf_counter() - T_START:.1f} s", flush=True)
        print(card_line(), flush=True)
        return 0

    # one batch in float32, TF32 off for cuDNN and matmul, vs the CPU path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = pipeline_cfg(model)
    cfg32["tpu"]["compute_dtype"] = "float32"
    frames, ts = batches[0]
    gpu32 = PipelineEngine(cfg32, device="cuda")
    cpu32 = PipelineEngine(cfg32, device="cpu")
    r_gpu = gpu32.process_batch(frames, ts)
    t_cpu = time.perf_counter()
    r_cpu = cpu32.process_batch(frames, ts)
    t_cpu = time.perf_counter() - t_cpu
    n_dets = sum(len(r.detections) for r in r_cpu)
    worst = compare_results(r_cpu, r_gpu)
    print(f"[e2e] float32 batch: processed frames bit-equal, {n_dets} "
          f"detections match the CPU path (max box err {worst:.2e} px), "
          f"track ids identical; CPU path {t_cpu:.2f} s", flush=True)
    for r in r_gpu:
        for d in r.detections:
            if not all(np.isfinite(v) for v in (d.x1, d.y1, d.x2, d.y2,
                                                 d.conf)):
                fail("non-finite detection")

    paths = second_paths(model, batches, card)
    mark("e2e f32, second paths")
    # the host-free device step: the main path replayed from a CUDA graph,
    # the hooked trackers and GMC, then RT-DETR-L and rtdetr_demo.yaml
    graph = graph_phase(model, card)
    mark("[graph]")
    graph["trackers"] = graph_trackers_phase(model, card)
    mark("[graph] trackers")
    graph["rtdetr"] = rtdetr_graph_phase(card)
    mark("[graph] rtdetr")

    # the serving surface, each path with its own launch counts
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        entries = {
            "api": entry_api(model, batches, out_dir),
            "preview": entry_preview(model, Path(tmp)),
            "serve": entry_serve(model),
            "state": state_phase(model, batches, Path(tmp)),
            "state ocsort gmc": state_phase(
                model, batches, Path(tmp),
                {"backend": "ocsort", "gmc": True}),
            "tracker": tracker_phase(model, batches),
            "track --gt": entry_track_gt(model, Path(tmp)),
        }
    mark("serving surface")
    entries["bench"] = bench_phase(model, card)
    mark("[bench]")
    # the tracker family, GMC and the gate: the CPU engines share one
    # preprocess + detector pass per distinct batch
    front = SharedFront()
    entries["trackers"] = tracker_backends(model, batches, card, front)
    entries["gmc"] = gmc_phase(model, batches, card, front)
    entries["gate"] = gate_phase(model, batches, card, front)
    front.memo.clear()
    mark("[tracker], [gmc], [gate]")
    with tempfile.TemporaryDirectory() as tmp:
        detector = detector_phase(batches, card, Path(tmp))
    (out_dir / "detector.json").write_text(json.dumps(detector, indent=1))
    mark("[detector]")
    entries["weather"] = weather_phase(card)
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("rtdetr_demo", "weather_demo"):
            entries[name] = entry_demo(name, Path(tmp))
    mark("[weather], demos")
    # the camera fleet and traffic analytics
    fleet = {"streams": streams_phase(model, card),
             "streams gate": streams_gate_phase(model, card)}
    with tempfile.TemporaryDirectory() as tmp:
        fleet["multi_preview"] = entry_multi_preview(model, Path(tmp))
        fleet["analytics_demo"] = entry_analytics_demo(Path(tmp))
    fleet["multi_serve"] = entry_multi_serve(model)
    fleet["streams_api"] = entry_streams_api(model)
    fleet["bench streams"] = bench_streams_phase(model, card)
    (out_dir / "streams.json").write_text(json.dumps(fleet, indent=1))
    entries.update(fleet)
    mark("fleet")

    # training: every family, then the train entry points
    with tempfile.TemporaryDirectory() as tmp:
        training = train_phase(card, Path(tmp))
        training["entry"] = entry_train(Path(tmp), card)
    (out_dir / "training.json").write_text(json.dumps(training, indent=1))
    mark("training")

    # multi-card parallelism over lists that repeat cuda:0
    parallel = parallel_phase(card)
    (out_dir / "parallel.json").write_text(json.dumps(parallel, indent=1))
    mark("[parallel]")

    # the offline and auxiliary modules
    tools = tools_phases(model, batches[0][0], card)
    mark("tools")

    # the default bfloat16 path: counters from 0 around the main-path run
    torch.backends.cudnn.benchmark = True
    engine = PipelineEngine(pipeline_cfg(model), device="cuda")
    engine.process_batch(*batches[0], want_proc=False)     # warm-up
    engine.reset()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    n_timed = 0
    t0 = time.perf_counter()
    results = []
    for rep in range(4):
        for frames, ts in batches:
            shift = rep * len(batches) * BATCH / 30.0
            results.append(engine.process_batch(frames, ts + shift,
                                                want_proc=False))
            n_timed += 1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = add_to_totals(dict(kernels.launch_counts))
    fps = n_timed * BATCH / elapsed
    for name in PRE_KERNELS:
        if counts[name] != n_timed:    # one launch of each kernel per batch
            launch_mismatch(f"kernel {name} launched {counts[name]} times "
                            f"in {n_timed} batches")
    # NMS once a batch, the association once a frame
    check_tail("[e2e] bfloat16 main path", counts,
               tail_want(n_timed, n_timed * BATCH))
    for name, c in counts.items():
        print(f"[kernels] {name}: {c / n_timed:g} launches per 1080p batch "
              f"on the main path", flush=True)
    n16 = [len(r.detections) for r in results[0]]
    n32 = [len(r.detections) for r in r_gpu]
    tracks16 = len({d.track_id for r in results[0] for d in r.detections})
    tracks32 = len({d.track_id for r in r_gpu for d in r.detections})
    print(f"[e2e] bfloat16: {n_timed} batches of {BATCH} x {WIDTH}x{HEIGHT} "
          f"through process_batch in {elapsed:.3f} s = {fps:.1f} frames/s "
          f"({card}); launches {counts}", flush=True)
    print(f"[e2e] first batch: detections per frame bf16 {n16} vs f32 "
          f"{n32}; distinct tracks bf16 {tracks16} vs f32 {tracks32}",
          flush=True)
    if tracks16 != tracks32 or tracks32 == 0:
        fail("bf16 and f32 track a different number of objects")
    from roadvision_tpu_torch.tools.bench import stage_ms
    stages = stage_ms(engine, *batches[1])
    print("[e2e] stage ms (one batch, host clock, synchronised): "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}),
          flush=True)
    if "--profile" in sys.argv[1:]:
        print("[profile] " + json.dumps(profile_batch(engine, *batches[2])),
              flush=True)

    replaces = {
        "clahe_tile_luts": ("roadvision_tpu_torch/csrc/clahe.cu",
                            "roadvision_tpu/ops/clahe.py:222"),
        "clahe_apply": ("roadvision_tpu_torch/csrc/clahe.cu",
                        "roadvision_tpu/ops/pallas_clahe.py:64"),
        "median_k": ("roadvision_tpu_torch/csrc/median.cu",
                     "roadvision_tpu/ops/pallas_median.py:87"),
        "assoc_greedy": ("roadvision_tpu_torch/csrc/assoc.cu",
                         "roadvision_tpu/track/sort_tpu.py:227"),
        "assoc_auction": ("roadvision_tpu_torch/csrc/assoc.cu",
                          "roadvision_tpu/track/sort_tpu.py:300"),
        "nms_keep": ("roadvision_tpu_torch/csrc/nms.cu",
                     "roadvision_tpu/ops/nms.py:99"),
        "deform_sample": ("roadvision_tpu_torch/csrc/deform.cu",
                          "roadvision_tpu/models/rtdetr.py:422"),
        "deform_sample_bwd": ("roadvision_tpu_torch/csrc/deform.cu",
                              "roadvision_tpu/models/rtdetr_train.py:263"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": replaces[name][0],
         "replaces": replaces[name][1], "launches": PATH_TOTALS[name],
         "launches_main_path": counts[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r.get("library_ms"), "flushed_ms": r["flushed_ms"],
         "fleet": r["fleet"],
         **{k: r[k] for k in ("graph_ms", "graph_flushed_ms",
                              "launch_floor_ms", "matrix_mode", "boxes_mode",
                              "matcher_mode", "library", "bit_equal",
                              "launches_per_forward", "zero_fill_ms",
                              "kernel_ms") if k in r}}
        for name, r in rows.items()],
        "pipeline_fps": fps, "batches": n_timed, "stages_ms": stages,
        "second_paths": paths, "graph": graph, "entries": entries,
        "training": training,
        "parallel": parallel, "tools": {
            k: v.get("launches") if isinstance(v, dict) else v
            for k, v in tools.items()}}
    (out_dir / "chip_smoke.json").write_text(json.dumps(line, indent=1))
    mark("bf16 main path")
    print("[time] seconds by part " + json.dumps(phase_s), flush=True)
    print(f"[time] chip_smoke.py ran {time.perf_counter() - T_START:.1f} s "
          f"(the kernels' build included)", flush=True)
    print(json.dumps(line), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
