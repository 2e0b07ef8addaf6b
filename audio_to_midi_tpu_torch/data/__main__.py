"""Dataset smoke harness (reference audio_to_midi_dataset.py:514-566): iterate
batches with the full transform settings and print shapes and statistics.

Usage: python -m audio_to_midi_tpu_torch.data DATASET_DIR [--batches 5]
       [--batch-size 4] [--no-transforms]
"""

import argparse
from pathlib import Path

import numpy as np

from ..config import DEFAULT_CONFIG, TransformSettings
from . import loader


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset_dir")
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--no-transforms", action="store_true")
    args = p.parse_args(argv)

    cfg = DEFAULT_CONFIG
    num_frames = cfg.model.output_frames(cfg.data.samples_per_window)
    settings = None if args.no_transforms else TransformSettings()
    batches = loader.create_dataset_loader(
        Path(args.dataset_dir),
        batch_size=args.batch_size,
        num_workers=0,
        num_epochs=10**6,
        output_divisions=num_frames,
        transform_settings=settings,
    )
    with batches:
        for i, (events, audio) in zip(range(args.batches), batches):
            print(
                f"batch {i}: audio {audio.shape} {audio.dtype} "
                f"[{np.abs(audio).max():.3f} peak]  events {events.shape} "
                f"[{float(np.asarray(events, np.float32).mean()):.4f} mean]"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
