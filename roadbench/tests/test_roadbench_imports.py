"""What a run loads, and what the reference loads, compared by whole
top-level module names, each in a process of its own: a run loads
neither JAX nor the JAX package (``roadvision_tpu``, a prefix of the
port's name), and the reference loads nothing of the program either."""
import json
import subprocess
import sys

from .conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "roadvision_tpu"}


def _modules(code: str) -> set:
    proc = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_root):
    loaded = _modules(
        "import torch\nfrom pathlib import Path\n"
        "from roadbench.run import run_cell\n"
        f"run_cell('yolov8n.fleet16x8.dense', 3, 1.0, False, "
        f"device=torch.device('cpu'), root=Path({str(tiny_root)!r}))")
    assert "roadvision_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(
        "import torch\n"
        "from roadbench.reference import detect, preprocess, sort\n"
        "from roadbench.reference.params import load_npz\n"
        "p = load_npz('assets/yolov8n_synthetic_256.npz', "
        "torch.device('cpu'))\n"
        "x = preprocess.chain(torch.zeros(1, 64, 96, 3, dtype=torch.uint8), "
        "2.0, 8, 3)\n"
        "detect.candidates(x, {'family': 'yolov8', 'imgsz': 96}, p)\n")
    assert not loaded & (FORBIDDEN | {"roadvision_tpu_torch"})
