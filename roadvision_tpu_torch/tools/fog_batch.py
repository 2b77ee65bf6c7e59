"""Batch fog augmentation — the port of ``tools/fog_batch.py``.

Every jpg / png / jpeg under ``--input`` (recursively), synthesized at
each requested level by a fresh synthesizer with the reference tool's
constructor overrides (``augment.fog.CLI_OVERRIDES``, global_veil 0.5),
written to ``<output>/<level>/<relative path>``. Decode and encode
through PIL; the synthesis runs on the card unless ``--device cpu``.

    python -m roadvision_tpu_torch.tools.fog_batch --input clear/ \
        --output fogged/ [--levels light,medium,heavy] [--limit N] \
        [--seed S] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np

from ..augment.fog import CLI_OVERRIDES, EnhancedFogSynthesizer
from ..utils.device import DeviceLike

_IMAGE_SUFFIXES = frozenset({".jpg", ".jpeg", ".png"})


def _imread_bgr(path: Path) -> Optional[np.ndarray]:
    from PIL import Image
    try:
        return np.asarray(Image.open(path).convert("RGB"))[..., ::-1].copy()
    except Exception:
        return None


def _imwrite_bgr(path: Path, bgr: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(path)


def _synthesize_all_levels(img, levels, seed, device):
    """A fresh synthesizer per level, as the reference tool constructs."""
    for lv in levels:
        synth = EnhancedFogSynthesizer(level=lv, seed=seed, device=device,
                                       **CLI_OVERRIDES)
        yield lv, synth.synthesize(img)[0]


def process_folder(inp, outp, levels=("light", "medium", "heavy"),
                   limit=None, seed=None, progress_every=25,
                   device: DeviceLike = None) -> int:
    """Fog every image under ``inp`` into ``outp``; returns the number
    of images done."""
    inp, outp = Path(inp), Path(outp)
    outp.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in inp.rglob("*")
                   if p.suffix.lower() in _IMAGE_SUFFIXES)
    files = files[:limit] if limit else files
    done = 0
    for p in files:
        img = _imread_bgr(p)
        if img is None:
            print(f"[fog_batch] unreadable image, skipping: {p}")
            continue
        rel = p.relative_to(inp)
        for lv, hazy in _synthesize_all_levels(img, levels, seed, device):
            dest = outp / lv / rel
            dest.parent.mkdir(parents=True, exist_ok=True)
            _imwrite_bgr(dest, hazy)
        done += 1
        if done % progress_every == 0:
            print(f"[fog_batch] {done}/{len(files)} images done "
                  f"(latest: {rel})")
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", required=True, help="clear road image dir")
    ap.add_argument("--output", required=True, help="fogged output dir")
    ap.add_argument("--levels", default="light,medium,heavy")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "CPU")
    args = ap.parse_args(argv)
    lv = [s.strip() for s in args.levels.split(",") if s.strip()]
    process_folder(args.input, args.output, lv, limit=(args.limit or None),
                   seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
