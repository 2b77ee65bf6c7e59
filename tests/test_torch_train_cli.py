"""The port's training entry points on the CPU (``--device cpu``).

``cli.train`` runs each family for two steps at 96² (v8, -seg, -pose,
-obb, RT-DETR) and writes the training state plus the ``.weights.npz`` /
``.raw.npz`` exports; ``--save-every`` checkpoints at its steps and
``--resume`` continues at the saved step, in the port and in the JAX
tool; the ``.weights.npz`` serves in ``YOLOTorch`` and in ``YOLOJax``
(float32 both, boxes within 1e-4 px, confidences 1e-5); ``--dp 2`` and a
run without ``--device cpu`` and without a card raise. ``train_reid``
trains three steps with JAX's loss history (rtol 1e-4); its gradient
matches ``jax.value_and_grad`` per leaf and its Adam update ``optax.adam``'s
on the same gradients (1e-7). Parameters after Adam steps are not held
one to one: Adam's first steps move a weight by ≈ lr · sign(g), so where a
gradient is near 0 float noise picks the sign (one weight of 4608 in
``w2`` moved 4.8e-4 apart under the six-worker suite, 1.8e-5 alone);
``identity_separation`` of a saved file equals JAX's within 1e-6. ``eval_map``
scores a tiny YOLO dir written from the synthetic scenes, and box mAP of
the same detector equals JAX's.
"""
import numpy as np
import pytest
import torch
from PIL import Image

from roadvision_tpu_torch import cli
from roadvision_tpu_torch.detect import dataset as tds
from roadvision_tpu_torch.models.yolo import weights as tw
from roadvision_tpu_torch.runtime.checkpoint import load_train_state
from roadvision_tpu_torch.tools import train as ttool

ASSET = "assets/yolov8n_synthetic_256.npz"
SMALL = ["--device", "cpu", "--data", "synthetic", "--steps", "2",
         "--imgsz", "96", "--batch", "2"]


@pytest.mark.parametrize("weights,leaf", [
    ("none.pt", ("22", "cv3")),
    ("yolov8n-seg.pt", ("22", "proto")),
    ("yolov8n-pose.pt", ("22", "cv4")),
    ("yolov8n-obb.pt", ("22", "cv4")),
    ("rtdetr-l.pt", ("dec", "enc_score")),
])
def test_cli_train_each_family(tmp_path, weights, leaf):
    out = tmp_path / "r.npz"
    assert cli.train(SMALL + ["--weights", weights, "--out", str(out)]) == 0
    params, opt, step = load_train_state(out)
    assert step == 2 and leaf[1] in params[leaf[0]]
    if weights.startswith("rtdetr"):
        assert set(opt) == {"m", "v", "t"} and int(opt["t"]) == 2
    deploy = tw.import_npz(out.with_suffix(".weights.npz"))
    raw = tw.import_npz(out.with_suffix(".raw.npz"))
    assert tw.flatten_tree(deploy).keys() == tw.flatten_tree(params).keys()
    assert all(np.array_equal(a, b) for a, b in zip(
        tw.flatten_tree(raw).values(), tw.flatten_tree(params).values()))


def test_cli_train_needs_a_card_or_cpu_and_names_dp(tmp_path):
    # --dp 2 trains two replicas on the CPU; a batch they cannot split
    # evenly is refused (tests/test_torch_train_dp.py holds --dp 2 to 1)
    assert cli.train(SMALL + ["--dp", "2", "--out",
                              str(tmp_path / "a.npz")]) == 0
    with pytest.raises(ValueError, match="--dp 3"):
        cli.train(SMALL + ["--dp", "3", "--out", str(tmp_path / "c.npz")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.train(["--data", "synthetic", "--steps", "1",
                       "--out", str(tmp_path / "b.npz")])


def test_save_every_and_resume(tmp_path, monkeypatch):
    saved = []
    real = ttool.save_train_state

    def spy(path, model, opt, step):
        saved.append(step)
        return real(path, model, opt, step)

    monkeypatch.setattr(ttool, "save_train_state", spy)
    a = tmp_path / "a.npz"
    base = ["--device", "cpu", "--data", "synthetic", "--imgsz", "96",
            "--batch", "2", "--weights", ASSET]
    assert cli.train(base + ["--steps", "3", "--save-every", "2",
                             "--out", str(a)]) == 0
    assert saved == [2, 3]
    b = tmp_path / "b.npz"
    assert cli.train(base + ["--steps", "2", "--resume", str(a),
                             "--out", str(b)]) == 0
    assert saved == [2, 3, 5]
    pa, _, sa = load_train_state(a)
    pb, _, sb = load_train_state(b)
    assert (sa, sb) == (3, 5)
    assert not np.array_equal(pa["0"]["w"], pb["0"]["w"])

    # the JAX tool resumes the port's state where it stopped
    import tools.train as jtool
    c = tmp_path / "c.npz"
    assert jtool.main(["--data", "synthetic", "--steps", "1", "--imgsz",
                       "96", "--batch", "2", "--weights",
                       str(b.with_suffix(".weights.npz")), "--resume",
                       str(b), "--out", str(c)]) == 0
    from roadvision_tpu.runtime.checkpoint import load_train_state as jload
    assert jload(str(c))[2] == 6

    with pytest.raises(FileNotFoundError):
        cli.train(base + ["--steps", "1", "--resume",
                          str(tmp_path / "missing.npz"),
                          "--out", str(tmp_path / "d.npz")])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match=r"\.npz"):
        cli.train(base + ["--steps", "1", "--resume",
                          str(tmp_path / "orbax"),
                          "--out", str(tmp_path / "e.npz")])


def test_weights_npz_serves_in_both_packages(tmp_path):
    out = tmp_path / "ft.npz"
    assert cli.train(["--device", "cpu", "--data", "synthetic", "--steps",
                      "2", "--imgsz", "96", "--batch", "2", "--lr", "1e-4",
                      "--weights", ASSET, "--out", str(out)]) == 0
    path = str(out.with_suffix(".weights.npz"))
    cfg = {"model": path, "imgsz": 256, "conf_thres": 0.25,
           "compute_dtype": "float32", "classes_keep": []}
    from roadvision_tpu.detect.yolo_jax import YOLOJax
    from roadvision_tpu_torch.detect.yolo_torch import YOLOTorch
    frames = tds.synthetic_batches(2, imgsz=256, seed=21)
    bgr = np.ascontiguousarray(next(frames)[0][..., ::-1])
    got = YOLOTorch(cfg, device="cpu").infer_batch(bgr)
    want = YOLOJax(cfg).infer_batch(bgr)
    assert got.valid.sum() == want.valid.sum() > 0
    np.testing.assert_array_equal(got.cls_id[got.valid],
                                  want.cls_id[want.valid])
    np.testing.assert_allclose(got.boxes[got.valid], want.boxes[want.valid],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.conf[got.valid], want.conf[want.valid],
                               rtol=0, atol=1e-5)


def test_train_reid_matches_jax(tmp_path):
    """The tool trains and saves; the loss history of three steps equals
    JAX's ``train_reid`` (same seed) within 1e-4, and the separation of the
    saved parameters equals JAX's on the same file."""
    from roadvision_tpu.track import reid as jreid
    from roadvision_tpu_torch.tools import train_reid
    from roadvision_tpu_torch.track import reid as treid
    out = tmp_path / "reid.npz"
    assert train_reid.main(["--steps", "3", "--device", "cpu",
                            "--out", str(out)]) == 0
    _, want = jreid.train_reid(steps=3)
    _, got = treid.train_reid(steps=3, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    held = np.arange(128, 144)
    np.testing.assert_allclose(
        treid.identity_separation(treid.load_reid_params(out, device="cpu"),
                                  held),
        jreid.identity_separation(jreid.load_reid_params(out), held),
        rtol=0, atol=1e-6)


def test_reid_gradient_and_adam_step_match_jax():
    """One batch: the triplet loss and its gradient per leaf against
    ``jax.value_and_grad`` (max |Δ| ≤ 1e-3 · max |g_leaf| + 1e-6); the Adam
    update from one set of gradients equals ``optax.adam``'s within 1e-7
    over three steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from roadvision_tpu.track import reid as jreid
    from roadvision_tpu_torch.track import reid as treid
    rng = np.random.default_rng(5)
    frames, boxes, labels = treid.synthetic_reid_batch(
        rng, rng.choice(128, size=8, replace=False), 4)
    jp = jreid.init_reid_params(0)
    want_loss, want_g = jax.value_and_grad(
        lambda p: jreid.batch_hard_triplet(jreid.embed_frames(
            p, jnp.asarray(frames), jnp.asarray(boxes)), labels))(jp)
    tp = treid.init_reid_params(0, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    loss = treid.batch_hard_triplet(treid.embed_frames(
        tp, torch.from_numpy(frames), torch.from_numpy(boxes)),
        torch.from_numpy(labels))
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for k, g in grads.items():
        w = np.asarray(want_g[k])
        got = g.numpy().transpose(2, 3, 1, 0) if g.dim() == 4 else g.numpy()
        assert np.abs(got - w).max() <= 1e-3 * np.abs(w).max() + 1e-6, k

    g_np = {k: np.asarray(v) for k, v in want_g.items()}
    opt = optax.adam(1e-3)
    jstate = opt.init(jp)
    jparams = jp
    tp = treid.reid_params_from_jax(jp, device="cpu")
    state = treid.init_adam(tp)
    tgrads = treid.reid_params_from_jax(g_np, device="cpu")
    for _ in range(3):
        upd, jstate = opt.update(g_np, jstate)
        jparams = optax.apply_updates(jparams, upd)
        treid.adam_update(tp, tgrads, state, 1e-3)
    want_p = treid.reid_params_from_jax(jparams, device="cpu")
    for k in tp:
        torch.testing.assert_close(tp[k], want_p[k], rtol=0, atol=1e-7)


def test_eval_map_on_a_tiny_set(tmp_path, capsys):
    import json
    from roadvision_tpu.detect import eval as jev
    from roadvision_tpu.detect.yolo_jax import YOLOJax
    from roadvision_tpu_torch.detect import eval as tev
    from roadvision_tpu_torch.detect.yolo_torch import YOLOTorch
    from roadvision_tpu_torch.tools import eval_map
    imgs, boxes, _, mask = next(tds.synthetic_batches(3, imgsz=128, seed=8))
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    for i in range(3):
        Image.fromarray(imgs[i]).save(tmp_path / "images" / f"{i}.png")
        lines = [f"2 {(b[0] + b[2]) / 256} {(b[1] + b[3]) / 256} "
                 f"{(b[2] - b[0]) / 128} {(b[3] - b[1]) / 128}"
                 for b in boxes[i][mask[i]]]
        (tmp_path / "labels" / f"{i}.txt").write_text("\n".join(lines))
    assert eval_map.main(["--data", str(tmp_path), "--weights", ASSET,
                          "--imgsz", "128", "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    data = tds.load_dataset(str(tmp_path), imgsz=128)
    cfg = {"model": ASSET, "imgsz": 128, "conf_thres": 0.001,
           "iou_thres": 0.7, "max_det": 300, "classes_keep": [],
           "compute_dtype": "float32"}
    got = tev.evaluate_detector(YOLOTorch(cfg, device="cpu"), *data)
    want = jev.evaluate_detector(YOLOJax(cfg), *data)
    assert printed == got
    assert got["mAP@0.5"] > 0
    np.testing.assert_allclose(got["mAP@0.5"], want["mAP@0.5"], rtol=0,
                               atol=1e-6)
