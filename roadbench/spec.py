"""A cell, found by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``: the loop, the cameras and frames a camera a
fleet batch, the scene). A new cell is new files and entries; no code
here names one."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    workload: Dict[str, Any]     # the BENCHMARK.json entry
    config: Dict[str, Any]       # configs/<config>.json
    traffic: Dict[str, Any]      # traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def streams(self) -> int:
        return int(self.traffic["streams"])

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])


def _reports(metric: Dict[str, Any], name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; a ``KeyError``
    names what is missing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next((c for c in bench["configs"]
                   if c["name"] == entry["config"]), None)
    if config is None:
        raise KeyError(f"no config {entry['config']!r} in BENCHMARK.json")
    here = root / "roadbench"

    def read(path: Path) -> Dict[str, Any]:
        return json.loads(path.read_text())

    return Cell(
        name=name, workload=entry,
        config=read(root / config["file"]),
        traffic=read(here / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def engine_config(cell: Cell, root: Path = ROOT) -> Dict[str, Any]:
    """The program's configuration dict for this cell: the configuration
    file's pipeline, its checkpoint path made absolute, the homography's
    image points (fractions of the frame) in the traffic's pixels, and
    the cell's frames a stream per fleet batch."""
    cfg = json.loads(json.dumps(cell.config["pipeline"]))
    h, w = int(cell.traffic["height"]), int(cell.traffic["width"])
    cfg["detect"]["model"] = str(root / cell.config["checkpoint"])
    proj = cfg["geometry"]["projector"]
    proj["image_points"] = [[fx * w, fy * h]
                            for fx, fy in proj.pop("image_points_frac")]
    cfg.setdefault("tpu", {})["batch_size"] = cell.batch
    return cfg
