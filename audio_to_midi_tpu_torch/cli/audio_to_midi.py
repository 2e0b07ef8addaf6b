"""Command line: audio file -> MIDI file, through the PyTorch port.

Usage:
  python -m audio_to_midi_tpu_torch.cli.audio_to_midi <audio> <output.mid>
      --checkpoint DIR|FILE [--config JSON] [--overlap S] [--device cuda|cpu]
      [--stream]

``--checkpoint`` is a training checkpoint directory (its latest step, as
``cli/train_cli.py`` writes it) or a port checkpoint file (``.npz`` in the
JAX parameter layout, or a ``.pt`` state_dict).  The model runs in f32, the
checkpoint-parity mode.  ``--device`` defaults to ``cuda``; without a CUDA
device the command fails unless ``--device cpu`` is given.  ``--stream``
transcribes in chunks of windows (``infer.transcribe_file_streaming``):
bounded device memory for long audio, the copy of each chunk overlapped with
the model, the same MIDI as the batch path.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="audio_to_midi (PyTorch): convert a piano audio file to MIDI."
    )
    parser.add_argument("path", help="Audio file (wav or aif)")
    parser.add_argument("output", help="The output MIDI file")
    parser.add_argument("--checkpoint", required=True,
                        help="Training checkpoint directory, or a checkpoint file (.npz or .pt)")
    parser.add_argument("--config", default=None, help="Config JSON file")
    parser.add_argument(
        "--overlap", type=float, default=None,
        help="Seconds of window overlap (default: config infer.window_overlap, 0.5)",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="Device to run the model on (default: cuda)")
    parser.add_argument(
        "--stream", action="store_true",
        help="Chunked (streaming) transcription: copy/infer/stitch in window chunks -- "
        "bounded device memory for hour-long audio, the copy overlapped with the model, "
        "the same MIDI as batch mode",
    )
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    import torch

    from ..config import load_config
    from ..infer import (load_newest_checkpoint, load_params, transcribe_file,
                         transcribe_file_streaming)
    from ..ops.midi_io import write_midi_file

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")
    audio_file = Path(args.path)
    if not audio_file.exists():
        raise FileNotFoundError(f"The specified audio file {audio_file} does not exist!")

    cfg = load_config(args.config)
    overlap = args.overlap if args.overlap is not None else cfg.infer.window_overlap
    device = torch.device(args.device)
    if Path(args.checkpoint).is_dir():
        model, _state = load_newest_checkpoint(args.checkpoint, cfg, device, torch.float32)
    else:
        model = load_params(args.checkpoint, cfg, device, torch.float32)
    transcribe = transcribe_file_streaming if args.stream else transcribe_file
    stitched, duration_per_frame, events = transcribe(model, cfg, audio_file, overlap=overlap)
    print(f"Stitched probs shape: {stitched.shape}")
    print(f"Extracted {len(events)} events")
    print(f"Writing MIDI file to {args.output}")
    write_midi_file(events, duration_per_frame, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
