"""The port's datasets and mAP against the JAX package (CPU).

Every loader on tiny fixture datasets written in ``tmp_path`` (a YOLO
dir, a YOLO-OBB dir, COCO instances with polygons and an RLE, COCO
keypoints), every synthetic generator (detect, segment, obb, pose),
mosaic and flip + HSV augmentation from the same ``RandomState``: all
bit-equal to the JAX package's. Train-time fog from the same seeds:
within 2 levels of JAX's in ≤ 0.1 % of the pixels (the fog synthesizer's
bound, tests/test_torch_fog.py). Box, mask, OKS and rotated-box AP, the
mAP over classes and ``match_report``: equal to JAX's on the same
records. The training-state files cross in tests/test_torch_train.py
(YOLO) and tests/test_torch_rtdetr_train.py (RT-DETR).
"""
import json

import numpy as np
import pytest
from PIL import Image

from roadvision_tpu.detect import dataset as jds
from roadvision_tpu.detect import eval as jev
from roadvision_tpu_torch.detect import dataset as tds
from roadvision_tpu_torch.detect import eval as tev

FOG_LEVELS = 2
FOG_SHARE = 1e-3


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _save_img(path, w, h, seed=0):
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(path)


@pytest.fixture()
def yolo_dir(tmp_path):
    root = tmp_path / "yolo"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    _save_img(root / "images" / "a.png", 80, 48, 1)
    _save_img(root / "images" / "b.jpg", 40, 72, 2)
    (root / "labels" / "a.txt").write_text(
        "2 0.5 0.5 0.3 0.4\n0 0.2 0.3 0.1 0.2\n")
    (root / "labels" / "b.txt").write_text("5 0.61 0.42 0.37 0.19\n")
    return root


def test_yolo_dir_loads_as_jax(yolo_dir):
    for kw in ({"imgsz": 64}, {"imgsz": 96, "max_boxes": 3, "limit": 1}):
        assert_same(tds.load_yolo_dir(str(yolo_dir), **kw),
                    jds.load_yolo_dir(str(yolo_dir), **kw))
    assert_same(tds.load_dataset(str(yolo_dir), imgsz=64),
                jds.load_dataset(str(yolo_dir), imgsz=64))


def test_yolo_obb_dir_loads_as_jax(tmp_path):
    root = tmp_path / "dota"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    _save_img(root / "images" / "a.png", 64, 32)
    quads = ["3 0.25 0.375 0.75 0.375 0.75 0.625 0.25 0.625",
             "1 0.3 0.2 0.6 0.35 0.5 0.55 0.2 0.4"]
    (root / "labels" / "a.txt").write_text("\n".join(quads) + "\n")
    assert_same(tds.load_yolo_obb_dir(str(root), imgsz=64, max_boxes=4),
                jds.load_yolo_obb_dir(str(root), imgsz=64, max_boxes=4))


def _coco(tmp_path, w, h):
    _save_img(tmp_path / "im.png", w, h)
    _save_img(tmp_path / "im2.png", h, w, 3)
    return {"images": [{"id": 1, "file_name": "im.png", "width": w,
                        "height": h},
                       {"id": 2, "file_name": "im2.png", "width": h,
                        "height": w}],
            "categories": [{"id": 7, "name": "person"},
                           {"id": 3, "name": "car"}]}


def test_coco_json_loaders_load_as_jax(tmp_path):
    spec = _coco(tmp_path, 64, 40)
    kpts = [0.0] * 51
    kpts[0:3] = [10.0, 8.0, 2.0]
    kpts[3:6] = [20.0, 16.0, 0.0]
    kpts[15:18] = [14.5, 20.25, 1.0]
    poly = [16.0, 6.0, 48.0, 9.5, 44.0, 30.0, 12.0, 28.0]
    spec["annotations"] = [
        {"id": 1, "image_id": 1, "category_id": 7, "iscrowd": 0,
         "bbox": [8.0, 6.0, 20.0, 18.0], "keypoints": kpts,
         "num_keypoints": 2, "segmentation": [poly]},
        {"id": 2, "image_id": 1, "category_id": 3, "iscrowd": 0,
         "bbox": [30.5, 4.25, 12.0, 9.0],
         "segmentation": {"counts": "rle-blob", "size": [40, 64]}},
        {"id": 3, "image_id": 2, "category_id": 3, "iscrowd": 1,
         "bbox": [1.0, 2.0, 5.0, 6.0], "segmentation": [poly]},
        {"id": 4, "image_id": 2, "category_id": 7, "iscrowd": 0,
         "bbox": [3.0, 9.0, 20.0, 30.0], "segmentation": [poly]},
    ]
    p = tmp_path / "ann.json"
    p.write_text(json.dumps(spec))
    for name in ("load_coco_json", "load_coco_kpts_json",
                 "load_coco_seg_json"):
        assert_same(getattr(tds, name)(str(p), imgsz=64),
                    getattr(jds, name)(str(p), imgsz=64))
    assert_same(tds.load_dataset(str(p), imgsz=96),
                jds.load_dataset(str(p), imgsz=96))
    assert tds.coco_names(str(p)) == jds.coco_names(str(p))


@pytest.mark.parametrize("name,kw", [
    ("synthetic_batches", {}),
    ("synthetic_batches", {"seed": 5, "max_boxes": 3, "num_vehicles": 7}),
    ("synthetic_seg_batches", {"seed": 2}),
    ("synthetic_obb_batches", {"seed": 1}),
    ("synthetic_pose_batches", {"seed": 4}),
])
def test_synthetic_batches_are_jax_bit_for_bit(name, kw):
    tg, jg = (getattr(m, name)(3, imgsz=64, **kw) for m in (tds, jds))
    for _ in range(2):
        assert_same(next(tg), next(jg))


def test_mosaic_and_augment_are_jax_bit_for_bit():
    imgs, boxes, cls, mask = next(tds.synthetic_batches(4, imgsz=64,
                                                        seed=6))
    for seed in (0, 1, 2):
        t_rng, j_rng = np.random.RandomState(seed), \
            np.random.RandomState(seed)
        got = tds.mosaic_batch(imgs, boxes, cls, mask, t_rng)
        want = jds.mosaic_batch(imgs, boxes, cls, mask, j_rng)
        assert_same(got, want)
        assert_same(tds.augment_batch(got[0], got[1], got[3], t_rng),
                    jds.augment_batch(want[0], want[1], want[3], j_rng))
    quad = np.array([[1, 2], [9, 4], [8, 8], [0, 6]], np.float32)
    assert tds.corners_to_rbox(quad) == jds.corners_to_rbox(quad)


def test_fog_augment_within_the_fog_bound():
    imgs = next(tds.synthetic_batches(3, imgsz=64, seed=7))[0][..., ::-1]
    got = tds.fog_augment_batch(imgs, np.random.RandomState(77), p=0.7,
                                device="cpu")
    want = jds.fog_augment_batch(imgs, np.random.RandomState(77), p=0.7)
    assert got.dtype == want.dtype == np.uint8
    fogged = [i for i in range(3) if not np.array_equal(want[i], imgs[i])]
    assert fogged
    for i in range(3):
        if i not in fogged:
            np.testing.assert_array_equal(got[i], imgs[i])
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= FOG_LEVELS
    assert (diff > 0).mean() <= FOG_SHARE


def _records(seed, n_img=5, rotated=False):
    rng = np.random.RandomState(seed)
    preds, confs, gts = [], [], []
    for _ in range(n_img):
        g = rng.randint(0, 4)
        gt = np.concatenate([rng.uniform(0, 40, (g, 2)),
                             rng.uniform(5, 20, (g, 2))], 1)
        k = rng.randint(0, 6)
        pr = np.concatenate([gt, rng.uniform(0, 40, (max(k - g, 0), 4))])[:k]
        pr = pr + rng.normal(0, 2.0, pr.shape)
        if not rotated:
            gt[:, 2:] += gt[:, :2]
            pr[:, 2:] = pr[:, :2] + np.abs(pr[:, 2:])
        else:
            gt = np.concatenate([gt, rng.uniform(-0.7, 2.3, (g, 1))], 1)
            pr = np.concatenate([pr, rng.uniform(-0.7, 2.3, (len(pr), 1))],
                                1)
            pr[:, 2:4] = np.abs(pr[:, 2:4]) + 1
        preds.append(pr.astype(np.float32))
        confs.append(rng.rand(len(pr)).astype(np.float32))
        gts.append(gt.astype(np.float32))
    return preds, confs, gts


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.75])
def test_box_and_rbox_ap_equal_jax(thr):
    for seed in range(4):
        p, c, g = _records(seed)
        assert tev.average_precision(p, c, g, thr) == \
            jev.average_precision(p, c, g, thr)
        p, c, g = _records(seed, rotated=True)
        assert tev.average_precision_rboxes(p, c, g, thr) == \
            jev.average_precision_rboxes(p, c, g, thr)
        np.testing.assert_array_equal(tev.rbox_iou_matrix(p[0], g[0]),
                                      jev.rbox_iou_matrix(p[0], g[0]))
    p, c, g = _records(9)
    per_class = {0: (p[:3], c[:3]), 2: (p[3:], c[3:])}
    gts = {0: g[:3], 2: g[3:]}
    assert tev.mean_ap(per_class, gts, (thr, 0.9)) == \
        jev.mean_ap(per_class, gts, (thr, 0.9))
    assert tev.match_report(p[1], g[1], thr) == \
        jev.match_report(p[1], g[1], thr)


def test_oks_and_mask_ap_equal_jax():
    rng = np.random.RandomState(3)
    pk, pc, gk, ga, pm, gmasks = [], [], [], [], [], []
    for _ in range(4):
        g = rng.randint(1, 4)
        gt = rng.uniform(0, 60, (g, 17, 3)).astype(np.float32)
        gt[..., 2] = rng.rand(g, 17) > 0.2
        pr = gt[rng.permutation(g)] + rng.normal(0, 1.5, gt.shape) \
            .astype(np.float32)
        pk.append(pr)
        pc.append(rng.rand(g).astype(np.float32))
        gk.append(gt)
        ga.append(rng.uniform(50, 900, g).astype(np.float32))
        gm = rng.rand(g, 24, 24) > 0.6
        pm.append(gm ^ (rng.rand(g, 24, 24) > 0.9))
        gmasks.append(gm)
    np.testing.assert_array_equal(tev.oks_matrix(pk[0], gk[0], ga[0]),
                                  jev.oks_matrix(pk[0], gk[0], ga[0]))
    for thr in (0.5, 0.75):
        assert tev.average_precision_oks(pk, pc, gk, ga, thr) == \
            jev.average_precision_oks(pk, pc, gk, ga, thr)
        assert tev.average_precision_masks(pm, pc, gmasks, thr) == \
            jev.average_precision_masks(pm, pc, gmasks, thr)
