"""The judgement has to fail what is not correct. The control (the
precision below the configuration's in the program's place: the
program's own int8 detector and the reference tracker in bfloat16), and
the timed path broken underneath in each way a fleet cell can be: the
tracker's state handed back unchanged, half of the batch (the second
half of the cameras) left out, an answer altered where it is produced.
A cell runs on one card, so there is no exchange between cards to leave
out. All on the CPU, at the size of ``conftest.shrink``; the card tests
(``test_roadbench_card.py``) run the control at the cells' own size."""
import numpy as np
import pytest

from roadbench.reference import sort
from roadbench.run import run_cell

from .conftest import WINDOW_S

FLEET = "yolov8n.fleet16x8.dense"


def test_control_is_not_correct(tiny_root, cpu):
    out = run_cell(FLEET, 2 ** 31 + 3, WINDOW_S, False, device=cpu,
                   root=tiny_root, control=True)
    assert out["correct"] is False, out["checks"]


def test_reference_solve_gives_nan_for_a_singular_row():
    """The bfloat16 tracker's state can make a row's innovation singular
    or not finite: that row's gain is NaN, the other rows' as alone."""
    rng = np.random.default_rng(0)
    m = rng.normal(size=(4, 4, 4)).astype(np.float32)
    a = m @ np.swapaxes(m, -1, -2) + np.eye(4, dtype=np.float32)
    a[1] = 0.0
    a[2, 0, 0] = np.nan
    b = rng.normal(size=(4, 4, 7)).astype(np.float32)
    x = sort._solve(a, b)
    assert np.isnan(x[1]).all() and np.isnan(x[2]).all()
    for i in (0, 3):
        assert np.array_equal(x[i], np.linalg.solve(a[i], b[i]))


def _state_unchanged(step):
    def broken(states, frames, ts, *rest):
        outs, _ = step(states, frames, ts, *rest)
        return outs, states
    return broken


def _half_left_out(step):
    def broken(states, frames, ts, *rest):
        outs, new = step(states, frames, ts, *rest)
        valid = outs[3].clone()
        valid[valid.shape[0] // 2:] = False
        return (*outs[:3], valid, *outs[4:]), new
    return broken


def _answer_altered(step):
    def broken(states, frames, ts, *rest):
        outs, new = step(states, frames, ts, *rest)
        return (outs[0] + 4.0, *outs[1:]), new
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
def test_broken_timed_path_is_not_correct(fault, tiny_root, cpu,
                                          monkeypatch):
    from roadvision_tpu_torch.parallel import inference
    make = inference.make_stream_step

    def patched(engine, shape):
        step, init = make(engine, shape)
        return fault(step), init

    monkeypatch.setattr(inference, "make_stream_step", patched)
    out = run_cell(FLEET, 2 ** 31 + 5, WINDOW_S, False, device=cpu,
                   root=tiny_root)
    assert out["correct"] is False, out["checks"]
