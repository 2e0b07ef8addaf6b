#!/usr/bin/env python
"""Export a JAX checkpoint's parameters as the flat ``.npz`` that the
PyTorch port reads (``audio_to_midi_tpu_torch.convert.load_npz``).

Runs where JAX is installed; the port itself never imports JAX.  It restores
the newest (or ``--step``) orbax checkpoint through the JAX package's
``infer.load_newest_checkpoint`` (params cast to f32, ensemble member
``--member``) and writes one array per parameter path
(``cnn/stages/5/blocks/pw1/w``, ...):

    python tools/export_params_npz.py --checkpoint audio_to_midi_checkpoints \\
        --out params.npz [--config config.json] [--step N]
    python -m audio_to_midi_tpu_torch.cli.audio_to_midi song.wav out.mid \\
        --checkpoint params.npz
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", required=True, help="orbax checkpoint directory")
    parser.add_argument("--out", required=True, help="output .npz file")
    parser.add_argument("--config", default=None, help="config JSON (default: built-in)")
    parser.add_argument("--step", type=int, default=None, help="step (default: newest)")
    parser.add_argument("--member", type=int, default=0, help="ensemble member")
    parser.add_argument("--ensemble-size", type=int, default=1)
    args = parser.parse_args(argv)

    import jax

    from audio_to_midi_tpu.config import load_config
    from audio_to_midi_tpu.infer import load_newest_checkpoint
    from audio_to_midi_tpu_torch.convert import flatten_tree, save_npz

    cfg = load_config(args.config)
    params, _state = load_newest_checkpoint(
        args.checkpoint, cfg, ensemble_size=args.ensemble_size,
        ensemble_select=args.member, model_replication=False, step=args.step,
    )
    flat = flatten_tree(jax.device_get(params))
    save_npz(args.out, flat)
    total = sum(v.size for v in flat.values())
    print(f"wrote {len(flat)} arrays, {total:,} parameters to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
