"""The port's multi-device story (``roadvision_tpu_torch/parallel``)
against the JAX package's on its 8 virtual CPU devices (tests/conftest.py)
and against the port's own single-device forward, on CPU entries repeated
(``["cpu"] * k``), float32.

Tolerances:

  * a column-parallel conv against the unsplit conv: atol 1e-5 on outputs
    of order 1 (each output element's reduction is unchanged; the smaller
    convs may sum in another order), its input gradient within 1e-5 of
    the largest;
  * pipelines and the sharded model against the plain forward and
    against JAX's pipelines: boxes rtol 1e-4, atol 1e-3 px; scores rtol
    1e-4, atol 1e-6 (JAX's pipeline tests hold rtol 1e-4; XLA's and
    oneDNN's convolutions sum in other orders);
  * the row-sharded forward against the port's plain forward: JAX's
    spatial tolerances (boxes rtol 1e-5, atol 1e-4; scores as above), as
    JAX's test holds its sharded forward to its unsharded one; against
    JAX's ``make_spatial_forward``: the pipelines' bounds. Across the two
    frameworks 1e-4 px is float32 noise: the port's plain forward sits
    at 0.42 of that bound from JAX's, and the bands' convs (other shapes,
    other oneDNN kernels) add 0.3–0.6 more at the /32 level, where a box
    is 32 × its grid distance (measured 0.59–0.89 against the plain
    forward and up to 1.04 against JAX's, 1 to 8 torch threads).
"""
import io
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models import rtdetr as jrtdetr
from roadvision_tpu.parallel import make_mesh as jmake_mesh
from roadvision_tpu.parallel import param_shardings as jparam_shardings
from roadvision_tpu.parallel.pipeline import PipelinedRTDETR as JPipeRT
from roadvision_tpu.parallel.pipeline import PipelinedYOLO as JPipeYOLO
from roadvision_tpu.parallel.spatial import \
    make_spatial_forward as jmake_spatial_forward
from roadvision_tpu_torch.models import rtdetr as trtdetr
from roadvision_tpu_torch.models.yolo import weights as tw
from roadvision_tpu_torch.models.yolo.yolov8 import Conv
from roadvision_tpu_torch.parallel import (ColumnParallelConv,
                                           PipelinedRTDETR, PipelinedYOLO,
                                           batch_sharding, dryrun_multicard,
                                           make_mesh, make_spatial_forward,
                                           param_shardings, replicated,
                                           shard_model, spatial_sharding)
from roadvision_tpu_torch.parallel import pipeline as tpipe
from roadvision_tpu_torch.parallel import sharding as tsharding

V8_NPZ = "assets/yolov8n_synthetic_256.npz"
BOX_RTOL, BOX_ATOL = 1e-4, 1e-3
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-6
SPATIAL_BOX_RTOL, SPATIAL_BOX_ATOL = 1e-5, 1e-4   # JAX's spatial test
CPU8 = ["cpu"] * 8


def close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def close_outputs(got, want, box_rtol=BOX_RTOL, box_atol=BOX_ATOL):
    close(got[0], want[0], box_rtol, box_atol, "boxes")
    close(got[1], want[1], SCORE_RTOL, SCORE_ATOL, "scores")


@pytest.fixture(scope="module")
def v8_tree():
    return tw.import_npz(V8_NPZ)


@pytest.fixture(scope="module")
def v8_plain(v8_tree):
    return tpipe.v8_detect_model(v8_tree, "n", 80, torch.float32)


@pytest.fixture(scope="module")
def rt_tree():
    return trtdetr.tree_from_model(trtdetr.random_model(7, seed=3))


@pytest.fixture(autouse=True)
def f32_values(monkeypatch):
    """Both packages read ``_BF16_VALS`` at import: pin it off."""
    monkeypatch.setattr(jrtdetr, "_BF16_VALS", False)
    monkeypatch.setattr(trtdetr, "_BF16_VALS", False)


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# --- meshes and the sharding rule ---------------------------------------

def test_make_mesh_shapes_and_errors(monkeypatch):
    mesh = make_mesh(8, model_parallel=2, device="cpu")
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.devices == [torch.device("cpu")] * 8
    assert make_mesh(devices=CPU8[:3]).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(3, model_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="given"):
        make_mesh(4, devices=CPU8[:2])
    # more cards than are visible: raise, never shrink or fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert make_mesh().devices == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="1 card"):
        make_mesh(2)
    with pytest.raises(ValueError, match="1 card"):
        make_mesh(4, model_parallel=2)


def test_batch_sharding_and_replicated():
    mesh = make_mesh(4, model_parallel=2, device="cpu")
    x = torch.arange(6.0).reshape(6, 1)
    pieces = batch_sharding(mesh, torch.arange(4.0).reshape(4, 1))
    assert [p.tolist() for p in pieces] == [[[0.0], [1.0]], [[2.0], [3.0]]]
    with pytest.raises(ValueError, match="divisible"):
        batch_sharding(make_mesh(4, device="cpu"), x)
    lin = torch.nn.Linear(2, 2)
    copies = replicated(mesh, lin)
    assert len(copies) == 4 and all(c is copies[0] for c in copies)
    assert copies[0] is not lin


@pytest.mark.parametrize("family", ["v8", "rtdetr"])
def test_param_shardings_pick_jax_leaves(family, v8_tree, rt_tree):
    tree = v8_tree if family == "v8" else rt_tree
    jmesh = jmake_mesh(8, model_parallel=2)
    want = tw.flatten_tree(jax.tree_util.tree_map(
        lambda s: np.asarray(tuple(s.spec), dtype=object),
        jparam_shardings(tree, jmesh)))
    got = tw.flatten_tree(jax.tree_util.tree_map(
        lambda s: np.asarray(s, dtype=object),
        param_shardings(tree, make_mesh(8, 2, device="cpu")),
        is_leaf=lambda s: isinstance(s, tuple)))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k
    assert any(tuple(v) for v in got.values())


@pytest.mark.parametrize("groups", [1, "depthwise"])
@pytest.mark.parametrize("mp", [2, 4])
def test_column_parallel_conv_matches_unsplit(groups, mp):
    gen = torch.Generator().manual_seed(0)
    cin = 128
    g = cin if groups == "depthwise" else 1
    conv = Conv(cin, 128, 3, stride=2, groups=g)
    with torch.no_grad():           # He-normal: outputs of order 1
        fan_in = conv.weight[0].numel()
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                          * (2.0 / fan_in) ** 0.5)
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
    x = torch.randn(2, cin, 17, 23, generator=gen, requires_grad=True)
    par = ColumnParallelConv(conv, ["cpu"] * mp)
    assert len(par.shards) == mp
    want, got = conv(x), par(x)
    close(got.detach(), want.detach(), 0, 1e-5)
    # the backward through the shards is the unsplit conv's, within 1e-5
    # of the largest input gradient (it sums over the out channels)
    gw = torch.autograd.grad(want.square().sum(), x)[0]
    gg = torch.autograd.grad(got.square().sum(), x)[0]
    close(gg, gw, 0, 1e-5 * float(gw.abs().max()))


@pytest.mark.parametrize("family", ["v8", "rtdetr"])
def test_shard_model_splits_the_rule_convs(family, v8_tree, rt_tree):
    tree = v8_tree if family == "v8" else rt_tree
    model = tw.model_from_params(tree).set_compute_dtype(torch.float32)
    mesh = make_mesh(4, model_parallel=2, device="cpu")
    sharded = shard_model(model, mesh)
    split = {n for n, m in sharded.named_modules()
             if isinstance(m, ColumnParallelConv)}
    spec = tw.flatten_tree(jax.tree_util.tree_map(
        lambda s: np.asarray(len(s.spec)),
        jparam_shardings(tree, jmake_mesh(8, model_parallel=2))))
    prefix = "layers." if family == "v8" else ""
    want = {prefix + k[:-2] for k, v in spec.items()
            if k.endswith(".w") and int(v) == 4}
    assert split == want and split
    # the state merges back to the unsharded names and values
    merged = tsharding.merge_shards(sharded.state_dict())
    ref = model.state_dict()
    assert merged.keys() == ref.keys()
    for k in ref:
        assert torch.equal(merged[k], ref[k]), k
    if family == "v8":
        x = torch.from_numpy(np.random.RandomState(2).rand(
            2, 64, 96, 3).astype(np.float32))
        with torch.no_grad():
            close_outputs(sharded(x), model.eval()(x))


# --- pipelines -----------------------------------------------------------

@pytest.fixture(scope="module")
def yolo_batch():
    return np.random.RandomState(7).rand(4, 64, 64, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_yolo_pipes(v8_tree, yolo_batch):
    out = {}
    for n in (2, 4):
        pipe = JPipeYOLO(jnp_tree(v8_tree), "n", 80, n_stages=n)
        out[n] = tuple(np.asarray(a) for a in pipe(jnp.asarray(yolo_batch)))
    return out


def test_stage_keys_cover_the_v8_graph(v8_plain):
    flat = [k for g in tpipe.STAGE_KEYS for k in g]
    assert len(flat) == len(set(flat))
    assert set(flat) == set(v8_plain.layers.keys())


@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_pipelined_yolo_matches_jax_and_plain(n_stages, v8_tree, v8_plain,
                                              yolo_batch, jax_yolo_pipes):
    pipe = PipelinedYOLO(v8_tree, "n", 80, n_stages=n_stages,
                         devices=CPU8[:n_stages])
    got = pipe(torch.from_numpy(yolo_batch))
    with torch.no_grad():
        close_outputs(got, v8_plain(torch.from_numpy(yolo_batch)))
    if n_stages in jax_yolo_pipes:
        close_outputs(got, jax_yolo_pipes[n_stages])


def test_groups_match_jax(v8_tree, rt_tree):
    for n in (2, 3, 4):
        want = JPipeYOLO(jnp_tree(v8_tree), "n", 80, n_stages=n).groups
        got = PipelinedYOLO(v8_tree, "n", 80, n_stages=n,
                            devices=CPU8[:n]).groups
        assert [list(g) for g in got] == [list(g) for g in want]
    for n in (2, 4):
        want = JPipeRT(jnp_tree(rt_tree), nc=7, n_stages=n).groups
        got = PipelinedRTDETR(rt_tree, nc=7, n_stages=n,
                              devices=CPU8[:n]).groups
        assert [list(g) for g in got] == [list(g) for g in want]


def test_balanced_groups_contiguous_and_minimal():
    groups = tpipe._balanced_groups([10, 1, 1, 10], 2)
    assert [list(g) for g in groups] == [[0, 1], [2, 3]]
    groups = tpipe._balanced_groups([1, 1, 1, 9], 2)
    assert [list(g) for g in groups] == [[0, 1, 2], [3]]


def test_pick_microbatch_as_jax():
    for n_stages in (2, 3, 4):
        for batch in (1, 2, 3, 4, 6, 8, 9, 12, 16, 30):
            want = JPipeYOLO._pick_microbatch(SimpleNamespace(
                microbatch=None, n_stages=n_stages), batch)
            got = tpipe._Pipelined._pick_microbatch(SimpleNamespace(
                microbatch=None, n_stages=n_stages), batch)
            assert got == want, (n_stages, batch)


def test_explicit_microbatch_and_divisibility(v8_tree, yolo_batch):
    pipe = PipelinedYOLO(v8_tree, "n", 80, n_stages=2, devices=CPU8[:2],
                         microbatch=2)
    assert pipe(torch.from_numpy(yolo_batch))[0].shape[0] == 4
    bad = PipelinedYOLO(v8_tree, "n", 80, n_stages=2, devices=CPU8[:2],
                        microbatch=3)
    with pytest.raises(ValueError, match="divisible"):
        bad(torch.from_numpy(yolo_batch))


def test_pipeline_value_errors(v8_tree, rt_tree):
    for n in (1, 5):
        with pytest.raises(ValueError, match="unsupported"):
            PipelinedYOLO(v8_tree, "n", 80, n_stages=n, devices=CPU8)
        with pytest.raises(ValueError, match="unsupported"):
            PipelinedRTDETR(rt_tree, nc=7, n_stages=n, devices=CPU8)
    with pytest.raises(ValueError, match="devices"):
        PipelinedYOLO(v8_tree, "n", 80, n_stages=2, devices=CPU8[:1])
    with pytest.raises(ValueError, match="devices"):
        PipelinedRTDETR(rt_tree, nc=7, n_stages=4, devices=CPU8[:3])
    v11 = tw.tree_from_model(tw.random_model("11", "detect", "n", 80))
    v5 = tw.import_npz("assets/yolov5n_synthetic_256.npz")
    for tree in (v11, v5, rt_tree):
        with pytest.raises(ValueError, match="v8 detect graph"):
            PipelinedYOLO(tree, "n", 80, n_stages=2, devices=CPU8[:2])
    with pytest.raises(ValueError, match="'enc'"):
        PipelinedRTDETR({k: v for k, v in rt_tree.items() if k != "enc"},
                        nc=7, n_stages=2, devices=CPU8[:2])
    with pytest.raises(ValueError, match="classes"):
        PipelinedRTDETR(rt_tree, nc=80, n_stages=2, devices=CPU8[:2])


def test_stage_modules_live_on_their_devices(v8_tree):
    pipe = PipelinedYOLO(v8_tree, "n", 80, n_stages=4, devices=CPU8[:4])
    assert pipe.devices == [torch.device("cpu")] * 4
    assert len(pipe.stage_modules) == 4
    for mods, dev in zip(pipe.stage_modules, pipe.devices):
        assert {p.device for p in mods.parameters()} == {dev}
    names = [set(m.keys()) for m in pipe.stage_modules]
    assert set().union(*names) == {"0", "1", "2", "3"}


@pytest.fixture(scope="module")
def rt_batch():
    return np.random.RandomState(5).rand(2, 96, 96, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_rt(rt_tree, rt_batch):
    saved = jrtdetr._BF16_VALS
    jrtdetr._BF16_VALS = False
    try:
        params = jnp_tree(rt_tree)
        x = jnp.asarray(rt_batch)
        out = {"plain": tuple(np.asarray(a) for a in jrtdetr.
                              forward_rtdetr_raw(params, x, nc=7,
                                                 num_queries=300))}
        for n in (2, 4):
            out[n] = tuple(np.asarray(a) for a in JPipeRT(
                params, nc=7, n_stages=n)(x))
    finally:
        jrtdetr._BF16_VALS = saved
    return out


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipelined_rtdetr_matches_jax_and_plain(n_stages, rt_tree, rt_batch,
                                                jax_rt):
    pipe = PipelinedRTDETR(rt_tree, nc=7, n_stages=n_stages,
                           devices=CPU8[:n_stages])
    got = pipe(torch.from_numpy(rt_batch))
    plain = trtdetr.model_from_params(rt_tree).eval()
    with torch.no_grad():
        want = plain(torch.from_numpy(rt_batch), num_queries=300)
    # 96²: 189 anchors, fewer than the 300 queries
    assert got[0].shape == (2, 189, 4) and got[1].shape == (2, 189, 7)
    close_outputs(got, want)
    close_outputs(got, jax_rt[n_stages])
    close_outputs(jax_rt[n_stages], jax_rt["plain"])


# --- the row-sharded forward ---------------------------------------------

@pytest.fixture(scope="module")
def spatial_cases(v8_tree):
    jmesh = jmake_mesh(8, model_parallel=1)
    jrun = jmake_spatial_forward("n", 80, jmesh)
    out = {}
    for h, w, seed in ((256, 192, 7), (224, 160, 11)):
        x = np.random.RandomState(seed).rand(1, h, w, 3).astype(np.float32)
        out[h] = (x, tuple(np.asarray(a) for a in jrun(jnp_tree(v8_tree),
                                                        x)))
    return out


@pytest.mark.parametrize("h", [256, 224])
def test_spatial_forward_matches_jax_and_plain(h, v8_tree, v8_plain,
                                               spatial_cases):
    x, want_jax = spatial_cases[h]
    run = make_spatial_forward("n", 80, make_mesh(8, device="cpu"))
    got = run(v8_tree, torch.from_numpy(x))
    with torch.no_grad():
        close_outputs(got, v8_plain(torch.from_numpy(x)),
                      SPATIAL_BOX_RTOL, SPATIAL_BOX_ATOL)
    close_outputs(got, want_jax)


def test_spatial_bands_span_the_devices():
    mesh = make_mesh(8, device="cpu")
    x = torch.zeros(1, 256, 192, 3)
    bands = spatial_sharding(mesh, x)
    assert bands.slots == list(range(8))
    assert {tuple(p.shape) for p in bands.parts} == {(1, 32, 192, 3)}
    assert bands.starts == list(range(0, 256, 32))
    # 224 rows: 7 cells over 8 devices; the first holds none
    bands = spatial_sharding(mesh, torch.zeros(1, 224, 160, 3))
    assert bands.slots == list(range(1, 8))
    assert {tuple(p.shape) for p in bands.parts} == {(1, 32, 160, 3)}
    # 10 cells over 4: the remainder to the last bands
    bands = spatial_sharding(make_mesh(4, device="cpu"),
                             torch.zeros(1, 320, 64, 3))
    assert [p.shape[1] for p in bands.parts] == [64, 64, 96, 96]
    with pytest.raises(ValueError, match="multiple of 32"):
        spatial_sharding(mesh, torch.zeros(1, 100, 64, 3))


def test_spatial_halos_span_several_bands(v8_tree, v8_plain):
    """One-row bands at /32 take SPPF's 2-row halos from two neighbours."""
    x = np.random.RandomState(3).rand(1, 160, 64, 3).astype(np.float32)
    run = make_spatial_forward("n", 80, make_mesh(5, device="cpu"))
    with torch.no_grad():
        close_outputs(run(v8_tree, torch.from_numpy(x)),
                      v8_plain(torch.from_numpy(x)),
                      SPATIAL_BOX_RTOL, SPATIAL_BOX_ATOL)


# --- the dry run ---------------------------------------------------------

def test_dryrun_multicard_on_eight_cpu_entries():
    buf = io.StringIO()
    with redirect_stdout(buf):
        dryrun_multicard(CPU8)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[dryrun]")]
    want = ["[dryrun] mesh axes: {'data': 4, 'model': 2}",
            "[dryrun] one sharded train step OK:",
            "[dryrun] config-driven 8-stream sharded inference OK:",
            "[dryrun] fleet temporal gate OK:",
            "[dryrun] 4-stage pipeline-parallel inference OK:",
            "[dryrun] 4-stage rtdetr pipeline OK:",
            "[dryrun] one sharded rtdetr train step OK:",
            "[dryrun] row-sharded (sp) inference OK:"]
    assert len(lines) == len(want)
    for line, prefix in zip(lines, want):
        assert line.startswith(prefix), line
    assert "devices=8 dp=4 tp=2" in lines[1]
    assert "devices_spanned=8" in lines[2]
    assert "bands=8×32 rows" in lines[7]
