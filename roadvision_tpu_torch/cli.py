"""Entry points by name — the port of ``roadvision_tpu/cli.py``:

    python -m roadvision_tpu_torch.cli preview   (realtime pipeline + record)
    python -m roadvision_tpu_torch.cli detect    (offline detection)
    python -m roadvision_tpu_torch.cli track     (offline tracking, MOT output)
    python -m roadvision_tpu_torch.cli serve     (headless MJPEG live server)
    python -m roadvision_tpu_torch.cli train     (train / fine-tune a detector)
    python -m roadvision_tpu_torch.cli bench     (the port's benchmark)
    python -m roadvision_tpu_torch.cli analyze   (offline analytics report)

each the ``main`` of ``roadvision_tpu_torch.tools.<name>``. They are not
declared under ``[project.scripts]``: ``tests/test_cli.py`` holds every
script declared there to ``roadvision_tpu.cli``. Every entry takes
``--device cuda|cpu`` and runs on the card by default.
"""
from __future__ import annotations

import importlib
import sys
from typing import Optional


def _run(name: str, argv: Optional[list] = None) -> int:
    mod = importlib.import_module(f"roadvision_tpu_torch.tools.{name}")
    return int(mod.main(argv) or 0)


def preview(argv: Optional[list] = None) -> int:
    return _run("preview", argv)


def detect(argv: Optional[list] = None) -> int:
    return _run("detect", argv)


def track(argv: Optional[list] = None) -> int:
    return _run("track", argv)


def serve(argv: Optional[list] = None) -> int:
    return _run("serve", argv)


def bench(argv: Optional[list] = None) -> int:
    return _run("bench", argv)


def train(argv: Optional[list] = None) -> int:
    return _run("train", argv)


def analyze(argv: Optional[list] = None) -> int:
    return _run("analyze", argv)


if __name__ == "__main__":  # python -m roadvision_tpu_torch.cli <name> [args]
    cmds = {"preview": preview, "detect": detect, "track": track,
            "train": train, "serve": serve, "bench": bench,
            "analyze": analyze}
    if len(sys.argv) < 2 or sys.argv[1] not in cmds:
        raise SystemExit(f"usage: python -m roadvision_tpu_torch.cli "
                         f"{{{'|'.join(cmds)}}} [args...]")
    raise SystemExit(cmds[sys.argv[1]](sys.argv[2:]))
