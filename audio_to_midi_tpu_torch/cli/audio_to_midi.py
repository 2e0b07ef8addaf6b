"""Command line: audio file -> MIDI file, through the PyTorch port.

Usage:
  python -m audio_to_midi_tpu_torch.cli.audio_to_midi <audio> <output.mid>
      --checkpoint FILE [--config JSON] [--overlap S] [--device cuda|cpu]

``--checkpoint`` is a port checkpoint (``.npz`` in the JAX parameter layout,
or a ``.pt`` state_dict).  The model runs in f32, the checkpoint-parity
mode.  ``--device`` defaults to ``cuda``; without a CUDA device the command
fails unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="audio_to_midi (PyTorch): convert a piano audio file to MIDI."
    )
    parser.add_argument("path", help="Audio file (wav or aif)")
    parser.add_argument("output", help="The output MIDI file")
    parser.add_argument("--checkpoint", required=True,
                        help="Port checkpoint file (.npz or .pt)")
    parser.add_argument("--config", default=None, help="Config JSON file")
    parser.add_argument(
        "--overlap", type=float, default=None,
        help="Seconds of window overlap (default: config infer.window_overlap, 0.5)",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="Device to run the model on (default: cuda)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..config import load_config
    from ..infer import load_params, transcribe_file
    from ..ops.midi_io import write_midi_file

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")
    audio_file = Path(args.path)
    if not audio_file.exists():
        raise FileNotFoundError(f"The specified audio file {audio_file} does not exist!")

    cfg = load_config(args.config)
    overlap = args.overlap if args.overlap is not None else cfg.infer.window_overlap
    model = load_params(args.checkpoint, cfg, torch.device(args.device), torch.float32)
    stitched, duration_per_frame, events = transcribe_file(
        model, cfg, audio_file, overlap=overlap
    )
    print(f"Stitched probs shape: {stitched.shape}")
    print(f"Extracted {len(events)} events")
    print(f"Writing MIDI file to {args.output}")
    write_midi_file(events, duration_per_frame, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
