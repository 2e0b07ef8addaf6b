"""Command line: audio file -> MIDI file, or validation over a labelled
directory, through the PyTorch port.

Usage:
  python -m audio_to_midi_tpu_torch.cli.audio_to_midi <audio> <output.mid>
      [--checkpoint DIR|FILE] [--config JSON] [--overlap S] [--device cuda|cpu]
      [--stream]
  python -m audio_to_midi_tpu_torch.cli.audio_to_midi <dir> --validation
      [--individual] [--checkpoint DIR|FILE] [--config JSON] [--device cuda|cpu]

``--checkpoint`` is a training checkpoint directory (its latest step, as
``cli/train_cli.py`` writes it; default ``./audio_to_midi_checkpoints``,
the config's ``infer.checkpoint_dir``) or a port checkpoint file (``.npz``
in the JAX parameter layout, or a ``.pt`` state_dict).  The model runs in
f32, the checkpoint-parity mode.  ``--device`` defaults to ``cuda``;
without a CUDA device the command fails unless ``--device cpu`` is given.
``--stream`` transcribes in chunks of windows
(``infer.transcribe_file_streaming``): bounded device memory for long audio,
the copy of each chunk overlapped with the model, the same MIDI as the batch
path.  ``--validation`` evaluates the model on a labelled directory (WAV +
CSV pairs) and prints the loss, hit rate and eventized diff, or with
``--individual`` one line per sample, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="audio_to_midi (PyTorch): convert a piano audio file to MIDI."
    )
    parser.add_argument("path", help="Audio file (wav or aif), or directory for validation")
    parser.add_argument("output", nargs="?", help="The output MIDI file")
    parser.add_argument("--validation", action="store_true",
                        help="Evaluate the model on the provided validation set")
    parser.add_argument("--individual", action="store_true",
                        help="Report per-sample losses in the validation set")
    parser.add_argument("--checkpoint", default=None,
                        help="Training checkpoint directory, or a checkpoint file (.npz or .pt) "
                        "(default: ./audio_to_midi_checkpoints)")
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


def load_model(checkpoint: str | Path, cfg, device):
    """The f32 model of a checkpoint directory (its latest step) or file."""
    import torch

    from ..infer import load_newest_checkpoint, load_params

    if Path(checkpoint).is_dir():
        return load_newest_checkpoint(checkpoint, cfg, device, torch.float32)[0]
    return load_params(checkpoint, cfg, device, torch.float32)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.output is None and not args.validation:
        parser.error("the output MIDI file is required without --validation")

    import torch

    from ..config import load_config
    from ..infer import transcribe_file, transcribe_file_streaming
    from ..models import model as model_lib
    from ..ops.midi_io import write_midi_file

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")
    cfg = load_config(args.config)
    overlap = args.overlap if args.overlap is not None else cfg.infer.window_overlap
    device = torch.device(args.device)
    checkpoint = Path(args.checkpoint or Path.cwd() / cfg.infer.checkpoint_dir)

    if args.validation:
        from ..train.evaluate import compute_testset_loss, compute_testset_loss_individual

        model = load_model(checkpoint, cfg, device)
        rope = model_lib.make_rope(cfg.model, device)
        num_frames = cfg.model.output_frames(cfg.data.samples_per_window)
        if args.individual:
            loss_map = compute_testset_loss_individual(
                model, cfg, Path(args.path), num_frames, rope, ensemble=False)
            for sample_name, losses in loss_map.items():
                print(f"{sample_name}\t{losses['loss']}\t{losses['hit_rate']}\t"
                      f"{losses['eventized_diff']}\t{losses['phantom_note_diff']}\t"
                      f"{losses['missed_note_diff']}")
        else:
            loss, hit_rate, eventized_diff, _ = compute_testset_loss(
                model, cfg, Path(args.path), num_frames, rope, ensemble=False)
            print(f"Validation loss: {float(loss[0])}")
            print(f"Hit rate: {float(hit_rate[0])}")
            print(f"Eventized diff: {float(eventized_diff[0])}")
        return 0

    audio_file = Path(args.path)
    if not audio_file.exists():
        raise FileNotFoundError(f"The specified audio file {audio_file} does not exist!")
    model = load_model(checkpoint, cfg, device)
    transcribe = transcribe_file_streaming if args.stream else transcribe_file
    stitched, duration_per_frame, events = transcribe(model, cfg, audio_file, overlap=overlap)
    print(f"Stitched probs shape: {stitched.shape}")
    print(f"Extracted {len(events)} events")
    print(f"Writing MIDI file to {args.output}")
    write_midi_file(events, duration_per_frame, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
