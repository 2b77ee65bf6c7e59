"""The port's native host ops (``roadvision_tpu_torch/runtime/native``)
against the JAX package's and against the port's numpy / PIL paths, on
the CPU.

The C++ sources are copies, so every draw must be byte-equal to the JAX
package's native op and to the numpy path, and the JPEG bytes of the two
encoders equal (the same source, the same libjpeg); the decoders give the
same pixels as each other and as PIL (JDCT_ISLOW). The loader builds at
the first call, never at import, into the port's build directory, under
a name hashed on source and flags, through a temporary file and
``os.replace``: concurrent first calls all load a whole library. The
tests skip only where ``g++`` is absent; a build error fails them.
"""
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from roadvision_tpu.io_video import writer as jwriter
from roadvision_tpu.runtime import native as jnative
from roadvision_tpu.vis import draw as jdraw
from roadvision_tpu_torch.detect.types import Detection
from roadvision_tpu_torch.io_video import mjpeg_avi, writer
from roadvision_tpu_torch.runtime import native
from roadvision_tpu_torch.vis import draw
from roadvision_tpu_torch.vis.font5x7 import render_text_mask

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native host ops cannot build")
    assert native.available(), native.build_errors
    return native


@pytest.fixture(scope="module")
def jpeg(lib):
    assert native.get_jpeg_lib() and native.get_jdec_lib(), \
        native.build_errors
    assert jnative.get_jpeg_lib() and jnative.get_jdec_lib()
    return lib


class numpy_path:
    """The port's draw module on its numpy path."""

    def __enter__(self):
        self.saved = draw._NATIVE
        draw._NATIVE = False

    def __exit__(self, *exc):
        draw._NATIVE = self.saved


def _frame(h=96, w=128, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("box", [(5, 7, 30, 20), (-5, -5, 300, 300),
                                 (40, 30, 10, 5)])
def test_fill_rect_equals_jax_and_numpy(lib, box):
    a, b, c = _frame(), _frame(), _frame()
    native.fill_rect(a, *box, (10, 20, 300))
    jnative.fill_rect(b, *box, (10, 20, 300))
    with numpy_path():
        draw.fill_rect(c, *box, (10, 20, 300 & 0xFF))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("t", [1, 2, 3, 5])
def test_draw_rect_equals_jax_and_numpy(lib, t):
    a, b, c = _frame(), _frame(), _frame()
    native.draw_rect(a, -3, 7, 120, 90, (200, 100, 50), t)
    jnative.draw_rect(b, -3, 7, 120, 90, (200, 100, 50), t)
    with numpy_path():
        draw.draw_rect(c, -3, 7, 120, 90, (200, 100, 50), t)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("at", [(3, 5), (-4, -3), (100, 90)])
def test_blit_mask_equals_jax_and_numpy(lib, at):
    mask = render_text_mask("ID 7 | CAR 0.93", 2)
    a, b, c = _frame(), _frame(), _frame()
    native.blit_mask(a, mask, *at, (255, 255, 255))
    jnative.blit_mask(b, mask, *at, (255, 255, 255))
    with numpy_path():
        draw._blit(c, mask, *at, (255, 255, 255))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("layout", ["h", "v"])
@pytest.mark.parametrize("divider", [0, 4])
def test_canvas_equals_jax_and_numpy(lib, layout, divider):
    raw, proc = _frame(64, 96, 1), _frame(64, 96, 2)
    got = draw.make_canvas(raw, proc, layout=layout, divider_px=divider,
                           fps=29.5)
    want = jdraw.make_canvas(raw, proc, layout=layout, divider_px=divider,
                             fps=29.5)
    with numpy_path():
        plain = draw.make_canvas(raw, proc, layout=layout,
                                 divider_px=divider, fps=29.5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(
        native.canvas(raw, proc, layout, divider),
        jnative.canvas(raw, proc, layout, divider))


def test_draw_detections_native_equals_jax_and_numpy(lib):
    from roadvision_tpu.detect.types import Detection as JDetection
    rows = [(5, 8, 130, 60, 0.9, 2, "car", 1, 12.0, 30.0),
            (-10, 40, 60, 140, 0.4, 7, "truck", 12, None, None),
            (200, 100, 250, 150, 0.7, 0, "person", None, 3.5, 0.0)]
    a, b, c = _frame(160, 256), _frame(160, 256), _frame(160, 256)
    draw.draw_detections(a, [Detection(*r[:7], track_id=r[7],
                                       distance_m=r[8], speed_kmh=r[9])
                             for r in rows])
    jdraw.draw_detections(b, [JDetection(*r[:7], track_id=r[7],
                                         distance_m=r[8], speed_kmh=r[9])
                              for r in rows])
    with numpy_path():
        draw.draw_detections(c, [Detection(*r[:7], track_id=r[7],
                                           distance_m=r[8], speed_kmh=r[9])
                                 for r in rows])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_non_uint8_and_strided_images_take_the_numpy_path(lib):
    a = np.zeros((40, 60, 3), np.float32)
    draw.fill_rect(a, 2, 3, 20, 30, (1, 2, 3))
    assert a[10, 10].tolist() == [1, 2, 3]
    view = _frame()[:, ::2]
    want = view.copy()
    with numpy_path():
        draw.draw_rect(want, 4, 4, 30, 30, (9, 9, 9), 2)
    draw.draw_rect(view, 4, 4, 30, 30, (9, 9, 9), 2)
    np.testing.assert_array_equal(view, want)
    with pytest.raises(ValueError):
        native.fill_rect(np.zeros((4, 4), np.uint8), 0, 0, 2, 2, (1, 1, 1))


@pytest.mark.parametrize("quality,fast", [(90, False), (85, True),
                                          (50, False)])
def test_jpeg_bytes_equal_jax(jpeg, quality, fast):
    frame = _frame(72, 104, 3)
    got = native.jpeg_encode_bgr(frame, quality, fast_dct=fast)
    want = jnative.jpeg_encode_bgr(frame, quality, fast_dct=fast)
    assert got is not None and got == want


def test_writer_encode_equals_jax_and_decodes_like_pil(jpeg):
    frame = _frame(64, 96, 4)
    data = writer.encode_jpeg_bgr(frame, 85)
    assert data == jwriter.encode_jpeg_bgr(frame, 85)
    # the native and the PIL decoders give the same pixels
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(mjpeg_avi.decode_jpeg_bgr(data),
                                  rgb[..., ::-1])
    np.testing.assert_array_equal(native.jpeg_decode_bgr(data),
                                  jnative.jpeg_decode_bgr(data))
    assert native.jpeg_decode_bgr(b"not a jpeg") is None


def test_image_dir_source_decodes_jpeg_natively(jpeg, tmp_path):
    from roadvision_tpu_torch.io_video import VideoSource
    frames = [_frame(48, 64, s) for s in range(3)]
    for i, f in enumerate(frames):
        (tmp_path / f"{i:03d}.jpg").write_bytes(
            native.jpeg_encode_bgr(f, 95, fast_dct=False))
    src = VideoSource(str(tmp_path), width=64, height=48)
    for i in range(3):
        fr = src.read()
        assert fr.ok
        np.testing.assert_array_equal(
            fr.image, jnative.jpeg_decode_bgr(
                (tmp_path / f"{i:03d}.jpg").read_bytes()))
    src.release()


def test_opt_out_and_build_failure_give_none(lib, monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "build_errors", {})
    monkeypatch.setenv("RVT_NATIVE", "0")
    assert native.get_lib() is None and native.get_jpeg_lib() is False
    assert native.build_errors["hostops"] == "RVT_NATIVE=0"
    # a source that does not compile: None and the compiler's reason
    monkeypatch.delenv("RVT_NATIVE")
    monkeypatch.setattr(native, "_libs", {})
    (tmp_path / "host_ops.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    from roadvision_tpu_torch.utils.cache import enable_compilation_cache
    from roadvision_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    enable_compilation_cache(tmp_path / "build")
    assert native.get_lib() is None and not native.available()
    assert native.build_errors["hostops"].startswith("g++ failed")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.fill_rect(_frame(), 0, 0, 2, 2, (1, 1, 1))


def test_built_at_first_call_under_the_build_dir(lib, tmp_path):
    """No library at import; four processes building at once all load a
    whole library, named by the hash, under native/ of the build dir."""
    head = ("import sys; from pathlib import Path;"
            "from roadvision_tpu_torch.utils.cache import "
            "enable_compilation_cache as e; e(sys.argv[1]);"
            "import roadvision_tpu_torch.vis.draw, "
            "roadvision_tpu_torch.io_video.writer;"
            "from roadvision_tpu_torch.runtime import native as n;")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")

    def start(code):
        return subprocess.Popen(
            [sys.executable, "-c", head + code, str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(ROOT))

    out = start("print((Path(sys.argv[1]) / 'native').exists())") \
        .communicate(timeout=120)
    assert out[0].split() == ["False"], out
    procs = [start("print(n.available(), n.lib_path('hostops').parent)")
             for _ in range(4)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(o[0].split() == ["True", str(tmp_path / "native")]
               for o in outs), outs
    built = sorted(p.name for p in (tmp_path / "native").iterdir())
    assert built == [native.lib_path("hostops").name], built
