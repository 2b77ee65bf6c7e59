"""The yardstick's counts against published and recorded figures: the
detectors' FLOPs at 640 × 640 (Ultralytics: YOLOv8n 8.7 GFLOPs; Lyu et
al.: RT-DETR-L 110 GFLOPs), and the kernels' least bytes and times as
the port's kernel table records them (``chip_smoke.py::bound``)."""
import pytest

from roadbench import yardstick

from .conftest import REPO


def test_yolov8n_flops():
    f = yardstick.forward_flops({"family": "yolov8"}, 640, 640,
                                str(REPO / "assets/yolov8n_synthetic_256.npz"))
    assert round(f / 1e9, 1) == 8.7


def test_rtdetr_l_flops():
    """The checkpoint's RepConv blocks are fused into one 3 × 3 conv; the
    published 110 GFLOPs count the training form, whose parallel 1 × 1
    branch adds 2·c²·HW a block: 12 blocks of 256 channels, three of each
    RepC3 at /8 (fpn1), /16 (fpn0, pan0) and /32 (pan1)."""
    ckpt = str(REPO / "assets/rtdetr_l_synthetic_256.npz")
    f = yardstick.forward_flops({"family": "rtdetr", "num_queries": 300},
                                640, 640, ckpt)
    branches = 3 * 2 * 256 * 256 * (80 * 80 + 2 * 40 * 40 + 20 * 20)
    assert round((f + branches) / 1e9) == 110


@pytest.mark.parametrize("fn,args,ms", [
    (yardstick.clahe_tile_luts_s, (8, 1080, 1920), 0.00499),
    (yardstick.clahe_apply_s, (8, 1080, 1920), 0.00996),
    (yardstick.median_k_s, (24, 1080, 1920), 0.0297),
    (yardstick.deform_sample_s, (8, 100, 54711), 0.00261),
])
def test_kernel_bounds_match_the_kernel_table(fn, args, ms):
    assert fn(*args) * 1e3 == pytest.approx(ms, rel=5e-3)
