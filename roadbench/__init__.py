"""The benchmark of ``roadvision_tpu_torch``: the camera fleet on one
card. ``BENCHMARK.json`` at the repository's root names the cells; this
package holds the harness (``run.py``), the frozen inputs and their
reference (``frames.py``, ``reference/``), the yardstick's arithmetic
(``yardstick.py``), the judgement (``check.py``) and, as data found by
name, the configurations, traffic mixes, cell shapes and per-layer
metric readers."""
