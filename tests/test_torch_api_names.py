"""Every public name of the JAX package has its counterpart in the port,
checked by ``ast`` with no import of either package.

For each module of ``roadvision_tpu/`` the port's module of the same
path (``track/sort_tpu.py`` → ``track/sort.py``, ``detect/*_jax.py`` →
``*_torch.py``) must define each public top-level name (a ``def``, a
``class``, an assignment or an entry of ``__all__``; the port may also
import it), and each public method of a class both define (the port may
hold it as an attribute set on ``self``). A name missing from the port
fails unless it is on :data:`DIFFERENCES`, the recorded design
differences (ROADMAP C4's "left out on purpose"), each with its reason.
"""
import ast
import fnmatch
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "roadvision_tpu", ROOT / "roadvision_tpu_torch"
RENAMED = {"track/sort_tpu.py": "track/sort.py",
           "detect/yolo_jax.py": "detect/yolo_torch.py",
           "detect/rtdetr_jax.py": "detect/rtdetr_torch.py"}

FUNCTIONAL = ("the functional JAX forwards and parameter-tree functions: "
              "the port's models are nn.Modules (weights.random_model, "
              "quant.QConv with observe / finish_calibration)")
# (module pattern, name pattern) -> why the port has no such name
DIFFERENCES = {
    ("models/*", "forward*"): FUNCTIONAL,
    ("models/*", "init_params*"): FUNCTIONAL,
    ("models/*", "*_forward"): FUNCTIONAL,
    ("models/yolo/*", "base_init"): FUNCTIONAL,
    ("models/yolo/*", "base_spec"): FUNCTIONAL,
    ("models/yolo/yolov8_*.py", "*_spec"): FUNCTIONAL,
    ("models/yolo/*", "count_params"): FUNCTIONAL,
    ("models/yolo/*", "decode_angle"): FUNCTIONAL,
    ("models/yolo/*", "SKELETON"): FUNCTIONAL,
    ("models/yolo/weights.py", "random_params"): FUNCTIONAL,
    ("models/yolo/train.py", "optax_sigmoid_bce"): FUNCTIONAL,
    ("models/yolo/quant.py", "*"): FUNCTIONAL,
    ("ops/tta.py", "tta_nms"): "YOLOTorch.candidates composes TTA with "
    "postprocess",
    ("parallel/*", "shard_pytree"): "the port has make_mesh and "
    "param_shardings (nn.Module parameters, not pytrees)",
    ("parallel/*", "make_sharded_*"): "the port batches streams on a card "
    "and cuts them into per-card groups (make_stream_step, "
    "runtime/multi_engine.py)",
    ("runtime/multi_engine.py", "mesh_from_config"): "the port has "
    "devices_from_config",
    ("ops/color.py", "*_u8"): "the HWC uint8 colour wrappers: the port "
    "has the planar functions",
    ("ops/*", "*_i32"): "the int32 planar names: the port's planar "
    "functions keep the input dtype (clahe_planar, median_planar)",
    ("ops/clahe.py", "clahe_u8"): "the HWC uint8 wrapper: the port has "
    "the planar function",
    ("ops/pallas_clahe.py", "*"): "the Pallas kernel is K2 in "
    "roadvision_tpu_torch/csrc/clahe.cu (ops/clahe.py::clahe_apply)",
    ("ops/pallas_median.py", "*"): "the Pallas kernel is K3 in "
    "roadvision_tpu_torch/csrc/median.cu (ops/median.py::median_planes)",
    ("detect/*", "YOLOJax"): "the port's detector is YOLOTorch",
    ("detect/*", "RTDETRJax"): "the port's detector is RTDETRTorch",
}


def _recorded(module: str, name: str) -> bool:
    return any(fnmatch.fnmatch(module, m) and fnmatch.fnmatch(name, n)
               for m, n in DIFFERENCES)


def _public(names):
    return {n for n in names if not n.startswith("_")}


def _module_names(path: Path, with_imports: bool):
    """(top-level public names, {class: public methods and attributes})."""
    tree = ast.parse(path.read_text())
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            members = set()
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(sub.name)
                elif isinstance(sub, ast.Attribute) \
                        and isinstance(sub.ctx, ast.Store) \
                        and isinstance(sub.value, ast.Name) \
                        and sub.value.id == "self":
                    members.add(sub.attr)
            classes[node.name] = _public(members) if with_imports else \
                _public(m.name for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names.update(e.value for e in node.value.elts)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return _public(names), classes


def _pairs():
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        yield rel, path, PORT_PKG / RENAMED.get(rel, rel)


def _missing():
    out = []
    for rel, jpath, tpath in _pairs():
        jnames, jclasses = _module_names(jpath, with_imports=False)
        if not tpath.exists():
            out += [(rel, n) for n in sorted(jnames)]
            continue
        tnames, tclasses = _module_names(tpath, with_imports=True)
        out += [(rel, n) for n in sorted(jnames - tnames)]
        for cls, members in jclasses.items():
            if cls in tclasses:
                out += [(rel, f"{cls}.{m}")
                        for m in sorted(members - tclasses[cls])]
    return out


def test_every_public_jax_name_has_a_port_counterpart():
    missing = [(m, n) for m, n in _missing() if not _recorded(m, n)]
    assert not missing, (
        "public names of roadvision_tpu the port lacks (add them, or "
        "record the design difference in DIFFERENCES with its reason): "
        f"{missing}")


@pytest.mark.parametrize("module,name", [
    ("runtime/engine.py", "PipelineEngine.build_raw_step"),
    ("track/sort_tpu.py", "make_sort_scan")])
def test_the_device_step_is_no_recorded_difference(module, name):
    """The port has the host-free device step: neither name is excused,
    and the port defines both."""
    assert not _recorded(module, name)
    assert (module, name) not in _missing()


def test_every_recorded_difference_is_still_needed():
    """Each entry of DIFFERENCES excuses a name the port really lacks."""
    missing = _missing()
    for (m, n), why in DIFFERENCES.items():
        assert why
        assert any(fnmatch.fnmatch(mod, m) and fnmatch.fnmatch(name, n)
                   for mod, name in missing), (m, n)


def test_package_exports_match():
    """The ``__all__`` of each package ``__init__`` of the JAX package is
    in the port's ``__init__`` of the same path, but recorded
    differences."""
    for rel, jpath, tpath in _pairs():
        if jpath.name != "__init__.py":
            continue
        jall = _all(jpath)
        tall = _all(tpath) if tpath.exists() else set()
        lost = [n for n in sorted(jall - tall) if not _recorded(rel, n)]
        assert not lost, (rel, lost)


def _all(path: Path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return {e.value for e in node.value.elts}
    return set()
