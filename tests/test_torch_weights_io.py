"""The port's checkpoint I/O vs the JAX package's (host only, numpy):
``models/yolo/onnx_io.py`` (the protobuf reader and writer, the tree →
ultralytics-name mapping), ``models/yolo/weights.py`` (``.pt`` through
``torch.save`` / ``torch.load(weights_only=True)`` with conv + BN fusion,
``.npz``, ``.onnx``; ``load_params`` with its fallbacks and messages;
``describe``) for YOLOv8, YOLO11, YOLOv5 and the seg / pose / obb
heads, the export tool and the ``onnx`` backend.

Trees are compared leaf by leaf and bit for bit: both sides do the same
float64 fusion and float32 rounding in numpy.
"""
import numpy as np
import pytest
import torch

from roadvision_tpu.models.yolo import onnx_io as jonnx
from roadvision_tpu.models.yolo import weights as jweights
from roadvision_tpu_torch.detect import build_detector
from roadvision_tpu_torch.detect.yolo_torch import YOLOTorch
from roadvision_tpu_torch.models.yolo import onnx_io as tonnx
from roadvision_tpu_torch.models.yolo import weights as tweights
from roadvision_tpu_torch.tools import export

from tests.oracles import torch_port

NPZ = "assets/yolov8n_synthetic_256.npz"
FAMILIES = [("v8", "detect"), ("11", "detect"), ("v5", "detect"),
            ("v8", "segment"), ("11", "segment"), ("v8", "pose"),
            ("11", "obb")]


def _tree(arch, task, nc=None, seed=0):
    nc = nc or {"pose": 1, "obb": 15}.get(task, 80)
    return tweights.tree_from_model(
        tweights.random_model(arch, task, "n", nc, seed=seed))


def _same_tree(a, b):
    fa, fb = tweights.flatten_tree(a), tweights.flatten_tree(b)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype == np.float32, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _bn_state_dict(tree, arch, seed=1):
    """The tree as an unfused ultralytics checkpoint: every conv followed
    by a BatchNorm with seeded statistics (the head's last convs and the
    transposed convolution keep their bias), ``model.`` prefixed."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in jonnx.params_to_state_dict(tree, arch).items():
        if k.endswith(".conv.bias"):
            stem = k[:-len(".conv.bias")]
            c = v.shape[0]
            sd[f"{stem}.bn.weight"] = rng.uniform(0.5, 1.5, c)
            sd[f"{stem}.bn.bias"] = rng.normal(0, 0.1, c)
            sd[f"{stem}.bn.running_mean"] = rng.normal(0, 0.2, c)
            sd[f"{stem}.bn.running_var"] = rng.uniform(0.2, 2.0, c)
        else:
            sd[k] = v
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
            sd.items()}


def test_onnx_wire_format_interchanges_with_jax(tmp_path):
    sd = {"a": np.random.RandomState(0).rand(3, 4).astype(np.float32),
          "b": np.arange(6, dtype=np.int64).reshape(2, 3),
          "c": np.float32(2.5).reshape(()),
          "d": np.random.RandomState(1).rand(5).astype(np.float16),
          "e": np.arange(-3, 4, dtype=np.int8)}
    for save, load in ((tonnx.save_onnx, jonnx.load_onnx),
                       (jonnx.save_onnx, tonnx.load_onnx),
                       (tonnx.save_onnx, tonnx.load_onnx)):
        save(sd, tmp_path / "w.onnx")
        back = load(tmp_path / "w.onnx")
        assert set(back) == set(sd)
        for k in sd:
            assert back[k].dtype == sd[k].dtype
            np.testing.assert_array_equal(back[k], sd[k])
    (tmp_path / "bad.onnx").write_bytes(b"\x00\xffnot a model")
    with pytest.raises(ValueError):
        tonnx.load_onnx(tmp_path / "bad.onnx")


@pytest.mark.parametrize("arch,task", FAMILIES)
def test_checkpoints_load_as_in_jax(tmp_path, arch, task):
    """One tree per family and head, written as a BN ``.pt``
    (``torch.save``), a fused ``.onnx`` and the repo's ``.npz``: the
    port's ``load_params`` gives the JAX function's tree, arch and size
    for each, and the ``.onnx`` / ``.npz`` give back the tree itself."""
    tree = _tree(arch, task)
    name = {"segment": "-seg", "pose": "-pose", "obb": "-obb"}.get(task, "")
    torch.save(_bn_state_dict(tree, arch), tmp_path / f"m{name}.pt")
    tonnx.export_onnx(tree, tmp_path / f"m{name}.onnx", arch=arch)
    tweights.export_npz(tree, tmp_path / f"m{name}.npz")
    for suffix in (".pt", ".onnx", ".npz"):
        path = str(tmp_path / f"m{name}{suffix}")
        got, garch, gsize, gloaded = tweights.load_params(path)
        want, warch, wsize, wloaded = jweights.load_params(path)
        assert (garch, gsize, gloaded) == (warch, wsize, wloaded) == \
            (arch, "n", True)
        _same_tree(got, torch_port.jax_tree(want))
        assert tweights.describe(got)[:2] == (arch, task)
        if suffix != ".pt":
            _same_tree(got, tree)
    assert jonnx.params_to_state_dict(tree, arch).keys() == \
        tonnx.params_to_state_dict(tree, arch).keys()



@pytest.mark.parametrize("size,want", [("m", "m"), ("l", "l")])
def test_yolo11_size_from_npz_depth(tmp_path, size, want):
    """YOLO11 m and l share the stem width 64: the depth tells them apart
    (one block per C3k2 at m, two at l)."""
    tree = tweights.tree_from_model(tweights.new_model("11", "detect", size,
                                                       2))
    tweights.export_npz(tree, tmp_path / "w.npz")
    got = tweights.load_params(str(tmp_path / "w.npz"))[1:]
    assert got == jweights.load_params(str(tmp_path / "w.npz"))[1:] == \
        ("11", want, True)


@pytest.mark.parametrize("task,nc", [("detect", 80), ("segment", 80),
                                     ("pose", 1), ("obb", 15)])
def test_random_init_fallbacks_and_messages(tmp_path, capsys, task, nc):
    """Missing file, unreadable ONNX, mismatched keys: random init of the
    hinted arch and task (pose nc 1, obb nc 15) with the JAX package's
    messages, or the JAX package's exceptions with ``allow_random``
    False."""
    got = tweights.load_params("no/such.pt", arch="11", task=task)
    assert got[1:] == ("11", "n", False)
    assert tweights.describe(got[0]) == ("11", task, "n", nc)
    (tmp_path / "bad.onnx").write_bytes(b"\x00\xffnot a model")
    torch.save({"model.0.conv.weight": torch.zeros(16, 3, 3, 3)},
               tmp_path / "odd.pt")
    for path, msg, exc in (("bad.onnx", "unreadable ONNX", ValueError),
                           ("odd.pt", "checkpoint key mismatch", KeyError)):
        p = str(tmp_path / path)
        params, arch, size, loaded = tweights.load_params(p, task=task)
        out = capsys.readouterr().out
        assert not loaded and msg in out
        assert tweights.describe(params) == ("v8", task, "n", nc)
        with pytest.raises(exc) as err:
            tweights.load_params(p, allow_random=False)
        # the JAX package's messages (weights.py:373-374, 413-414); its
        # eager random init takes ~20 s here, so they are not rerun
        assert out.splitlines()[-1] == f"[roadvision] {msg} ({err.value}); " \
            f"using random init"
    with pytest.raises(FileNotFoundError):
        tweights.load_params("no/such.pt", allow_random=False)


def test_load_torch_reads_weights_only_first(tmp_path):
    sd = _bn_state_dict(_tree("v8", "detect"), "v8")
    torch.save(sd, tmp_path / "sd.pt")
    got = tweights._load_torch(tmp_path / "sd.pt")
    assert set(got) == set(sd)
    (tmp_path / "junk.pt").write_bytes(b"not a pickle")
    assert tweights._load_torch(tmp_path / "junk.pt") is None


def test_export_tool(tmp_path, capsys):
    """.pt → .npz → .onnx → .npz: the tree survives; the tool refuses to
    overwrite its input and refuses RT-DETR; the port's files load in
    the JAX package."""
    tree = _tree("11", "pose")
    torch.save(_bn_state_dict(tree, "11"), tmp_path / "yolo11n-pose.pt")
    npz, onnx, npz2 = (tmp_path / n for n in ("a.npz", "b.onnx", "c.npz"))
    assert export.main(["--weights", str(tmp_path / "yolo11n-pose.pt"),
                        "--format", "npz", "--out", str(npz)]) == 0
    assert export.main(["--weights", str(npz), "--format", "onnx",
                        "--out", str(onnx)]) == 0
    assert export.main(["--weights", str(onnx), "--format", "npz",
                        "--out", str(npz2)]) == 0
    assert "exported yolo11n" in capsys.readouterr().out
    a, b = tweights.import_npz(npz), tweights.import_npz(npz2)
    _same_tree(a, b)
    _same_tree(a, torch_port.jax_tree(jweights.load_params(str(onnx))[0]))
    before = onnx.read_bytes()
    assert export.main(["--weights", str(onnx), "--format", "onnx"]) == 2
    assert onnx.read_bytes() == before
    assert export.main(["--weights", "rtdetr-l.pt", "--format", "npz"]) == 2
    with pytest.raises(FileNotFoundError):
        export.main(["--weights", str(tmp_path / "none.pt")])


def test_onnx_backend_runs_the_exported_weights(tmp_path):
    """``detect.backend: onnx`` on the yolov8n asset exported to ONNX:
    the same detections as the ``.npz``; the two fail-fast checks."""
    tree = tweights.import_npz(NPZ)
    tonnx.export_onnx(tree, tmp_path / "w.onnx")
    cfg = {"model": NPZ, "imgsz": 96, "conf_thres": 0.05,
           "compute_dtype": "float32"}
    frames = np.random.RandomState(2).randint(0, 256, (2, 72, 96, 3),
                                              dtype=np.uint8)
    want = build_detector(cfg, device="cpu").infer_batch(frames)
    det = build_detector(dict(cfg, backend="onnx",
                              model=str(tmp_path / "w.onnx")), device="cpu")
    assert det.loaded
    got = det.infer_batch(frames)
    for f in ("boxes", "conf", "cls_id", "valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError, match="onnx"):
        build_detector({"backend": "onnx", "model": NPZ}, device="cpu")
    with pytest.raises(FileNotFoundError):
        build_detector({"backend": "onnx", "model": "none.onnx"},
                       device="cpu")


def test_set_params_reads_the_familys_own_head():
    """A YOLO11 tree with 5 classes: ``set_params`` takes nc from head 23
    (the JAX detector reads head 22 here, which a YOLO11 tree lacks)."""
    det = YOLOTorch({"model": "yolo11n.pt", "imgsz": 64}, device="cpu")
    assert (det.arch, det.nc) == ("11", 80)
    det.set_params(_tree("11", "detect", nc=5))
    assert det.nc == 5 and det.names == {i: str(i) for i in range(5)}
    pose = YOLOTorch({"model": "yolov8n-pose.pt", "imgsz": 64},
                     device="cpu")
    pose.set_params(_tree("v8", "pose", seed=3))
    assert pose.names == {0: "person"}
    with pytest.raises(ValueError, match="set_params"):
        det.set_params(_tree("v8", "detect"))
