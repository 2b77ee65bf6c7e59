"""Every cell of ``BENCHMARK.json``, rehearsed on the CPU at a tiny size
through the run's own code (``run.run_cell``; the command itself
refuses a machine without a card, which a test checks too), and a cell
added as new files only.

    python -m pytest roadbench/tests -q
"""
import json
import subprocess
import sys

import pytest

from roadbench import spec
from roadbench.run import run_cell

from .conftest import REPO, WINDOW_S

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsal(name, tiny_root, cpu):
    out = run_cell(name, 2 ** 31 + 11, WINDOW_S, False, device=cpu,
                   root=tiny_root)
    cell = spec.load_cell(name, tiny_root)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out["checks"]) == list(cell.config["check"]["limits"])


def test_same_seed_same_frames(cpu):
    from roadbench import frames
    a = frames.camera_pool(2 ** 33 + 5, 2, 3, 48, 80, 5, cpu)
    b = frames.camera_pool(2 ** 33 + 5, 2, 3, 48, 80, 5, cpu)
    c = frames.camera_pool(2 ** 33 + 6, 2, 3, 48, 80, 5, cpu)
    assert (a == b).all() and not (a == c).all()


@pytest.mark.parametrize("name", CELLS)
def test_stamps_jump_on_at_each_loop(name):
    """30 fps within a loop of the clip; at each loop the stamps jump by
    the cut, past the trackers' staleness, and never go back."""
    import numpy as np
    from roadbench import harness
    cell = spec.load_cell(name)
    t = cell.traffic
    ts = np.concatenate([harness.stamps(cell, n) for n in
                         range(3 * int(t["clip_frames"]) // cell.batch)],
                        axis=1)
    assert ts.shape == (cell.streams, 3 * int(t["clip_frames"]))
    step = np.diff(ts[0])
    cuts = np.flatnonzero(step > 1.5 / float(t["fps"]))
    assert list(cuts + 1) == [int(t["clip_frames"]),
                              2 * int(t["clip_frames"])]
    assert np.allclose(step[cuts], 1 / float(t["fps"]) + float(t["cut_s"]))
    stale = cell.config["pipeline"]["tracking"]["max_staleness"]
    assert (step[cuts] > stale).all() and (step > 0).all()


def test_cell_added_as_new_files(tiny_root, cpu):
    """A traffic mix and a BENCHMARK.json entry, and no edit of a file
    that is there: the harness finds and runs the cell."""
    here = tiny_root / "roadbench"
    mix = json.loads((here / "traffic" / "highway-dense-16x8.json")
                     .read_text())
    mix.update(vehicles=3, streams=2, batch=2)
    (here / "traffic" / "highway-sparse-2x2.json").write_text(
        json.dumps(mix))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "yolov8n.fleet2x2.sparse", "config": "yolov8n-640-bf16",
        "traffic": "highway-sparse-2x2", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "fleet_fps":
            m["workloads"].append("yolov8n.fleet2x2.sparse")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("yolov8n.fleet2x2.sparse", tiny_root)
    assert cell.traffic["vehicles"] == 3 and cell.streams == 2
    out = run_cell("yolov8n.fleet2x2.sparse", 7, 1.0, False, device=cpu,
                   root=tiny_root)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "fleet_fps"}


def test_command_refuses_a_machine_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "roadbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
