"""On the card: each cell at its own size, a short window, is correct,
and the control (``run.py --control 1``) at the same size is not. Marked
``cuda``; each test skips where no CUDA device is present.

    python -m pytest roadbench/tests/test_roadbench_card.py -m cuda -q
"""
import json

import pytest

from roadbench.run import run_cell

from .conftest import REPO

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct(name, card):
    out = run_cell(name, 2 ** 31 + 101, 3.0, False, device=card)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["kind"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card):
    out = run_cell(name, 2 ** 31 + 103, 3.0, False, device=card,
                   control=True)
    assert out["correct"] is False, out["checks"]
