"""Helpers for the port's parity tests: the same config, weights and
frames through ``roadvision_tpu``'s engine and ``roadvision_tpu_torch``'s
(CPU), and a field-by-field comparison of their ``Detection`` lists.

Weights reach both sides as one ``.npz`` written from a JAX parameter
tree, so both engines build their detector from the same file.
"""
from __future__ import annotations

import numpy as np


def jax_tree(params):
    """A JAX parameter tree → numpy leaves (what the port takes)."""
    import jax
    return jax.tree_util.tree_map(np.asarray, params)


def write_npz(params, path) -> str:
    from roadvision_tpu.models.yolo.weights import export_npz
    export_npz(params, path)
    return str(path)


def quantize_params_np(tree):
    """``quant.quantize_params`` of the JAX package, evaluated in numpy
    float32 as its eager call evaluates it (the eager call takes 10-25 s
    on this CPU; under ``jax.jit`` XLA computes some ``w_scale`` an ulp
    apart, which the int8 path then amplifies), with jnp leaves."""
    import jax.numpy as jnp
    if isinstance(tree, dict):
        if "w" in tree and "b" in tree and np.ndim(tree["w"]) == 4:
            w = np.asarray(tree["w"], np.float32)
            s = (np.maximum(np.abs(w).max(axis=(0, 1, 2)), np.float32(1e-12))
                 / np.float32(127.0)).astype(np.float32)
            return {"w_i8": jnp.asarray(
                        np.clip(np.round(w / s), -127, 127).astype(np.int8)),
                    "w_scale": jnp.asarray(s), "b": jnp.asarray(tree["b"])}
        return {k: quantize_params_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_params_np(v) for v in tree)
    return tree


def engine_cfg(model: str, chain: bool = False, tracking: bool = False,
               **detect):
    """A small engine config: ``model`` at imgsz 96 in float32, the
    CLAHE → median chain and SORT on request, no geometry."""
    det = {"enabled": True, "model": model, "imgsz": 96, "max_det": 12,
           "conf_thres": 1e-4, "iou_thres": 0.7, "classes_keep": [],
           "compute_dtype": "float32"}
    det.update(detect)
    pre = {"enabled": chain, "chain": [
        {"name": "CLAHEDehaze", "params": {"space": "YCrCb",
                                           "clip_limit": 2.0,
                                           "tile_grid": 4}},
        {"name": "MedianDerain", "params": {"ksize": 3}}]}
    return {"preprocess": pre, "detect": det,
            "tracking": {"enabled": tracking, "max_staleness": 1.2,
                         "min_hits": 1, "iou_threshold": 0.35,
                         "speed_window": 0.8},
            "geometry": {"enabled": False},
            "tpu": {"batch_size": 2, "compute_dtype": "float32"}}


def run_engines(cfg, frames: np.ndarray, ts: np.ndarray):
    """(port results, JAX results) of one ``process_batch``."""
    from roadvision_tpu.runtime.engine import PipelineEngine as JEngine
    from roadvision_tpu_torch.runtime import PipelineEngine as TEngine
    want = JEngine(cfg).process_batch(frames, ts)
    got = TEngine(cfg, device="cpu").process_batch(frames, ts)
    return got, want


def assert_same_results(got, want, box_tol: float, conf_tol: float,
                        extra_tol: float = 0.0) -> int:
    """Frames and processed frames bit-equal; per frame the same
    detections in the same order: class, name and track id equal, box
    and confidence within tolerance, and the task's side output (mask,
    keypoints or rbox) within ``extra_tol``. Returns the count."""
    assert len(got) == len(want)
    n = 0
    for f, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.proc, w.proc)
        assert len(g.detections) == len(w.detections), f
        for dg, dw in zip(g.detections, w.detections):
            assert (dg.cls_id, dg.cls_name, dg.track_id) == \
                (dw.cls_id, dw.cls_name, dw.track_id), f
            box = np.array([dg.x1, dg.y1, dg.x2, dg.y2]) \
                - np.array([dw.x1, dw.y1, dw.x2, dw.y2])
            assert np.abs(box).max() <= box_tol, (f, box)
            assert abs(dg.conf - dw.conf) <= conf_tol, f
            for field in ("mask", "keypoints", "rbox"):
                a, b = getattr(dg, field), getattr(dw, field)
                assert (a is None) == (b is None), field
                if a is not None:
                    assert np.asarray(a).shape == np.asarray(b).shape
                    err = np.abs(np.asarray(a) - np.asarray(b)).max()
                    assert err <= extra_tol, (field, err)
        n += len(g.detections)
    return n
