"""Secondary inference command line (the reference's infer.py:303-362
surface), through the PyTorch port.

Usage:
  python -m audio_to_midi_tpu_torch.cli.infer_cli <input_file> [--midi OUT]
      [--validation] [--checkpoint DIR|FILE] [--overlap S] [--config JSON]
      [--device cuda|cpu]

Transcribes ``input_file`` and prints its frame count and events, writing
them to ``--midi`` when given; with ``--validation`` ``input_file`` is a
labelled directory and the command prints its ``Average loss:``.  The
checkpoint defaults to ``./audio_to_midi_checkpoints``; the overlap to the
config's ``infer.window_overlap`` when ``--config`` is given, else 0.25 s
as in the reference.  ``--plot`` waits for the port's
``utils/visualize.py`` and raises.  ``--device`` defaults to ``cuda``;
without a CUDA device the command fails unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Process audio file to generate MIDI data.")
    parser.add_argument("input_file", help="Path to the input audio file.")
    parser.add_argument("--midi", help="Path to the output MIDI file.", default=None)
    parser.add_argument("--validation", action="store_true",
                        help="Expect a directory and calculate the validation loss")
    parser.add_argument("--checkpoint", default=None,
                        help="Training checkpoint directory, or a checkpoint file (.npz or .pt)")
    parser.add_argument("--overlap", type=float, default=None,
                        help="Seconds of window overlap (default: infer.window_overlap from "
                        "--config if given, else 0.25 like the reference infer.py:339)")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--config", default=None, help="Config JSON file")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="Device to run the model on (default: cuda)")
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.plot:
        raise NotImplementedError("--plot needs utils/visualize.py, which the port does not "
                                  "have yet")

    import torch

    from ..config import load_config
    from ..infer import transcribe_file
    from ..models import model as model_lib
    from ..ops.midi_io import write_midi_file
    from .audio_to_midi import load_model

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")
    cfg = load_config(args.config)
    if args.overlap is not None:
        overlap = args.overlap
    elif args.config is not None:
        overlap = cfg.infer.window_overlap
    else:
        overlap = 0.25
    device = torch.device(args.device)
    model = load_model(Path(args.checkpoint or Path.cwd() / cfg.infer.checkpoint_dir), cfg,
                       device)

    if args.validation:
        from ..train.evaluate import compute_testset_loss_individual

        rope = model_lib.make_rope(cfg.model, device)
        num_frames = cfg.model.output_frames(cfg.data.samples_per_window)
        loss_map = compute_testset_loss_individual(
            model, cfg, Path(args.input_file), num_frames, rope, ensemble=False)
        losses = np.stack([v["loss"] for v in loss_map.values()])
        print("Average loss: ", float(np.mean(losses)))
        return 0

    stitched, dpf, events = transcribe_file(model, cfg, args.input_file, overlap=overlap)
    print(f"Frame count: {stitched.shape[0]}")
    print(f"Events: {events}")
    if args.midi:
        write_midi_file(events, dpf, args.midi)
        print(f"Wrote {args.midi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
