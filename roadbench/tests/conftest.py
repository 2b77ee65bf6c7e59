"""A benchmark root at a size a CPU test can hold: the repository's
``BENCHMARK.json`` and the benchmark's data files, with every traffic mix
cut to 96 × 160 frames of 6 vehicles over a 4-frame clip, every
detector to a 160-pixel input, every cell to 2 cameras of at most 2
frames and the judgement to 2 cameras and 4 frames. The code is the
repository's own."""
import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
# a rehearsal's window: several fleet batches even on a busy CPU, where a
# tiny RT-DETR-L batch can take over a second
WINDOW_S = 4.0


def shrink(root: Path) -> None:
    here = root / "roadbench"
    for p in (here / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        d.update(height=96, width=160, clip_frames=4, vehicles=6, streams=2,
                 batch=min(int(d["batch"]), 2))
        p.write_text(json.dumps(d))
    for p in (here / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d["model"]["imgsz"] = d["pipeline"]["detect"]["imgsz"] = 160
        d["check"].update(cameras=2, frames=4, block=2)
        p.write_text(json.dumps(d))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark's files, shrunk by :func:`shrink`; the
    checkpoints are the repository's."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for part in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "roadbench" / part,
                        tmp_path / "roadbench" / part)
    (tmp_path / "assets").symlink_to(REPO / "assets")
    shrink(tmp_path)
    return tmp_path


@pytest.fixture
def cpu():
    torch.manual_seed(0)
    return torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda", 0)
