"""roadvision_tpu_torch.vis vs roadvision_tpu.vis: the same pixels.

The port's overlay code is the JAX package's numpy path alone; the JAX
package asks its C++ host ops first where they are built. Every function
draws on the same seeded canvas through both packages and must give the
same bytes, with the JAX side on its numpy path and (where the helpers
exist) on its native path.
"""
import numpy as np
import pytest

from roadvision_tpu.detect.types import Detection as JDetection
from roadvision_tpu.vis import draw as jdraw
from roadvision_tpu.vis import font5x7 as jfont
from roadvision_tpu.vis import legacy as jlegacy
from roadvision_tpu_torch import vis as tvis
from roadvision_tpu_torch.detect import Detection
from roadvision_tpu_torch.ops.masks import paste_masks
from roadvision_tpu_torch.vis import draw as tdraw
from roadvision_tpu_torch.vis import font5x7 as tfont
from roadvision_tpu_torch.vis import legacy as tlegacy

H, W = 120, 200


@pytest.fixture(params=["numpy", "native"])
def jax_path(request, monkeypatch):
    """Run the JAX side on its numpy path, then with its C++ helpers
    (which falls back to numpy by itself where they are not built)."""
    monkeypatch.setattr(jdraw, "_NATIVE",
                        False if request.param == "numpy" else None)
    return request.param


def _canvas(seed=0, h=H, w=W):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3),
                                               dtype=np.uint8)


def _both(jfn, tfn, *args, seed=0, **kw):
    a, b = _canvas(seed), _canvas(seed)
    jfn(a, *args, **kw)
    tfn(b, *args, **kw)
    np.testing.assert_array_equal(b, a)
    assert not np.array_equal(b, _canvas(seed))      # something was drawn
    return b


def _dets(cls, n=5, extras=False):
    rng = np.random.RandomState(n)
    out = []
    for i in range(n):
        x1, y1 = rng.uniform(-10, W - 40), rng.uniform(-5, H - 30)
        d = cls(float(x1), float(y1), float(x1 + rng.uniform(10, 80)),
                float(y1 + rng.uniform(10, 60)), float(rng.uniform()),
                int(rng.randint(0, 80)), ["car", "", "bus", None, "x"][i % 5],
                track_id=[None, 3, 12][i % 3],
                distance_m=[None, 25.5][i % 2],
                speed_kmh=[41.25, None, 7.0][i % 3])
        if extras:
            d.keypoints = np.concatenate(
                [rng.uniform(0, (W, H), (17, 2)),
                 rng.uniform(0, 1, (17, 1))], axis=1).astype(np.float32)
            d.rbox = np.array([W / 2 + 9 * i, H / 2, 50, 20, 0.3 * i],
                              np.float32)
            m = np.zeros((H, W), bool)
            m[10 + 5 * i:40 + 5 * i, 20 * i:20 * i + 50] = True
            d.mask = m
        out.append(d)
    out.append(cls(50.0, 50.0, 50.0, 80.0, 0.5, 1, "degenerate"))
    return out


@pytest.mark.parametrize("args", [(10, 12, 90, 70, (0, 255, 0), 2),
                                  (-8, -8, 30, 30, (9, 8, 7), 5),
                                  (150, 90, 260, 170, (255, 0, 255), 1),
                                  (20, 20, 20, 20, (1, 2, 3), 3)])
def test_draw_rect(jax_path, args):
    _both(jdraw.draw_rect, tdraw.draw_rect, *args)


@pytest.mark.parametrize("args", [(10, 12, 90, 70, (0, 255, 0)),
                                  (-8, -8, 30, 30, (9, 8, 7)),
                                  (150, 90, 260, 170, (255, 0, 255))])
def test_fill_rect(jax_path, args):
    _both(jdraw.fill_rect, tdraw.fill_rect, *args)


@pytest.mark.parametrize("text,org,scale,outline", [
    ("ID 7 | car 0.91", (5, 30), 0.6, None),
    ("FPS: 29.9", (-12, 8), 0.8, (0, 0, 0)),
    ("25.0 m / 41.3 km/h", (120, 118), 0.35, (255, 255, 255)),
    ("lower & UPPER ?!", (60, 70), 1.2, None)])
def test_put_text_and_text_size(jax_path, text, org, scale, outline):
    _both(jdraw.put_text, tdraw.put_text, text, org, (50, 220, 50), scale,
          outline)
    assert tdraw.text_size(text, scale) == jdraw.text_size(text, scale)
    assert tdraw.text_size("", scale) == jdraw.text_size("", scale)
    np.testing.assert_array_equal(tfont.render_text_mask(text, 2),
                                  jfont.render_text_mask(text, 2))
    assert tfont.GLYPH_H == jfont.GLYPH_H


@pytest.mark.parametrize("thickness,scale", [(2, 0.6), (1, 0.35), (4, 1.0)])
def test_draw_detections(jax_path, thickness, scale):
    a, b = _canvas(1), _canvas(1)
    jdraw.draw_detections(a, _dets(JDetection) + [None], thickness, scale)
    tdraw.draw_detections(b, _dets(Detection) + [None], thickness, scale)
    np.testing.assert_array_equal(b, a)
    a, b = _canvas(2), _canvas(2)
    jlegacy.draw_detections(a, _dets(JDetection), thickness, scale)
    tlegacy.draw_detections(b, _dets(Detection), thickness, scale)
    np.testing.assert_array_equal(b, a)
    assert tdraw.COLOR_TABLE == jdraw.COLOR_TABLE


def test_draw_masks_keypoints_rboxes_overlays(jax_path):
    jd, td = _dets(JDetection, extras=True), _dets(Detection, extras=True)
    for jfn, tfn in ((jdraw.draw_masks, tdraw.draw_masks),
                     (jdraw.draw_keypoints, tdraw.draw_keypoints),
                     (jdraw.draw_rboxes, tdraw.draw_rboxes)):
        a, b = _canvas(3), _canvas(3)
        jfn(a, jd)
        tfn(b, td)
        np.testing.assert_array_equal(b, a)
        assert not np.array_equal(b, _canvas(3))
    a, b = _canvas(4), _canvas(4)
    jdraw.draw_overlays(a, jd, lb_meta=(0.8, (0.0, 12.0)), thickness=1,
                        font_scale=0.35, mask_alpha=0.3)
    tdraw.draw_overlays(b, td, lb_meta=(0.8, (0.0, 12.0)), thickness=1,
                        font_scale=0.35, mask_alpha=0.3)
    np.testing.assert_array_equal(b, a)
    c = _canvas(4)
    tdraw.draw_overlays(c, [])
    np.testing.assert_array_equal(c, _canvas(4))
    assert tdraw.SKELETON == __import__(
        "roadvision_tpu.models.yolo.yolov8_pose",
        fromlist=["SKELETON"]).SKELETON


def test_draw_masks_pastes_prototype_masks_as_jax():
    """Prototype-resolution masks go through ``paste_masks``: the port's
    numpy copy against the JAX package's, and the blend on top."""
    from roadvision_tpu.ops import masks as jmasks
    rng = np.random.RandomState(5)
    protos = rng.uniform(0, 1, (3, 40, 64)).astype(np.float32)
    valid = np.array([True, False, True])
    meta = (0.32, (0.0, 12.0))
    for thresh in (0.5, None):
        want = jmasks.paste_masks(protos, valid, *meta, (H, W), thresh)
        got = paste_masks(protos, valid, *meta, (H, W), thresh)
        np.testing.assert_array_equal(got, want)
    jd, td = _dets(JDetection, 3), _dets(Detection, 3)
    for i in range(3):
        jd[i].mask = td[i].mask = protos[i]
    a, b = _canvas(6), _canvas(6)
    jdraw.draw_masks(a, jd, meta)
    tdraw.draw_masks(b, td, meta)
    np.testing.assert_array_equal(b, a)
    assert not np.array_equal(b, _canvas(6))


@pytest.mark.parametrize("p1,p2,thickness", [((5, 5), (190, 110), 1),
                                             ((-20, 60), (230, 40), 3),
                                             ((100, -5), (100, 140), 2)])
def test_draw_line(p1, p2, thickness):
    _both(jdraw.draw_line, tdraw.draw_line, p1, p2, (0, 200, 255), thickness)


def test_trail_renderer(jax_path):
    jt, tt = jdraw.TrailRenderer(length=4, stale_after=0.5), \
        tvis.TrailRenderer(length=4, stale_after=0.5)
    for f in range(8):
        boxes = [(10 + 9 * f, 20, 40 + 9 * f, 60, 1),
                 (150 - 6 * f, 30 + 4 * f, 190 - 6 * f, 90 + 4 * f, 2)]
        if f < 3:
            boxes.append((60, 60, 90, 100, 3))       # goes stale
        for trail, cls in ((jt, JDetection), (tt, Detection)):
            trail.update([cls(x1, y1, x2, y2, 0.9, 2, "car", track_id=tid)
                          for x1, y1, x2, y2, tid in boxes]
                         + [cls(0, 0, 5, 5, 0.5, 2, "car")], f * 0.2)
        a, b = _canvas(f), _canvas(f)
        jt.draw(a, thickness=2)
        tt.draw(b, thickness=2)
        np.testing.assert_array_equal(b, a)
    assert tt._hist.keys() == jt._hist.keys() == {1, 2}
    assert tt.length == 4


@pytest.mark.parametrize("layout,divider,fps,show", [
    ("h", 4, 29.97, True), ("v", 4, 12.5, True), ("h", 0, None, True),
    ("V", 7, 30.0, False)])
def test_make_canvas(jax_path, layout, divider, fps, show):
    raw, proc = _canvas(7), _canvas(8)
    kw = dict(layout=layout, divider_px=divider, label_raw="RAW",
              label_proc="PROC", fps=fps, show_fps=show)
    want = jdraw.make_canvas(raw, proc, **kw)
    got = tvis.make_canvas(raw, proc, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(raw, _canvas(7))   # inputs untouched


@pytest.mark.parametrize("n,fps", [(1, None), (3, 25.0), (4, 30.0)])
def test_tile_streams(jax_path, n, fps):
    frames = [_canvas(10 + i, 48, 64) for i in range(n)]
    labels = [f"CAM{i}" for i in range(n)]
    np.testing.assert_array_equal(
        tvis.tile_streams(frames, labels, divider_px=3, fps=fps),
        jdraw.tile_streams(frames, labels, divider_px=3, fps=fps))
    np.testing.assert_array_equal(tvis.tile_streams(frames),
                                  jdraw.tile_streams(frames))
