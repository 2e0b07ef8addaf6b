"""Training command line (reference train.py main(), train.py:732-892), through
the PyTorch port.

Usage:
  python -m audio_to_midi_tpu_torch.cli.train_cli --dataset DIR
      [--testset NAME=DIR ...] [--checkpoint DIR] [--steps N] [--batch-size N]
      [--ensemble-size E] [--num-workers N] [--learning-rate LR]
      [--precision bf16|f16|f32] [--no-tensorboard] [--config JSON]
      [--device cuda|cpu] [--threaded-loader]
      [--coordinator-address HOST:PORT --num-processes N
      --process-id I [--dist-backend nccl|gloo]]

The JAX package's flags, with its defaults, and ``--device`` (default
``cuda``; without a CUDA device the command fails unless ``--device cpu``
is given).  Training resumes at the latest checkpoint + 1.
``--ensemble-size`` above 1 trains a population, its members in turn, and
evolves it after each evaluation when it has more than 2 members;
``TrainConfig.use_custom_init`` applies the init surgery to each member;
``--precision f16`` trains with loss scaling.  The batches come from the
grain pipeline (``data.loader.GrainLoader``, ``dataset_num_workers`` worker
processes), as the JAX CLI's do where grain is installed;
``--threaded-loader`` takes the threaded loader instead.

Several processes (the three multi-host flags, one process per rank, each
started with its ``--process-id``) join one process group
(``parallel.initialize_multihost``) over ``--dist-backend``: the port's
counterpart of the transport XLA picks itself, ``nccl`` by default with
``--device cuda`` and ``gloo`` with ``--device cpu`` (gloo also runs ranks
that share one card).  Rank r trains on ``cuda:{r % device_count}``.  The
ranks form the mesh of ``ensemble_size`` and ``model_parallel_size``
(``parallel.make_mesh``), each rank's loader yields ``batch_size // world``
windows from a stream of its own (seed + 7919 x rank), rank 0 builds the
CUDA kernels while the others wait, writes the checkpoints and the
TensorBoard summaries.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the audio-to-midi model (PyTorch).")
    p.add_argument("--dataset", required=True, help="Training dataset directory")
    p.add_argument("--testset", action="append", default=[],
                   help="name=dir validation sets (repeatable)")
    p.add_argument("--checkpoint", default="audio_to_midi_checkpoints")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--ensemble-size", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--precision", choices=["bf16", "f16", "f32"], default=None,
                   help="Compute dtype (default bf16; overrides --config when given)")
    p.add_argument("--no-tensorboard", action="store_true")
    p.add_argument("--config", default=None, help="Config JSON file")
    p.add_argument("--coordinator-address", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="Collectives' backend of a multi-process run (default: nccl with "
                        "--device cuda, gloo with --device cpu)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="Device to train on (default: cuda)")
    p.add_argument("--threaded-loader", action="store_true",
                   help="Feed from the threaded loader instead of the grain pipeline")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    import torch

    from ..config import PrecisionConfig, load_config
    from ..data.loader import create_dataset_loader
    from ..metrics import configure_tensorboard
    from ..models import model as model_lib
    from ..parallel.mesh import (DATA_AXIS, build_kernels_once, initialize_multihost,
                                 make_mesh, place_model, rank_device, world)
    from ..train import checkpoint as ckpt
    from ..train import loop
    from ..train.init_surgery import apply_init_surgery_
    from ..train.optim import schedule, setup_optimizers

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to train on the CPU")
    backend = args.dist_backend or ("nccl" if args.device == "cuda" else "gloo")
    initialize_multihost(args.coordinator_address, args.num_processes, args.process_id,
                         backend=backend)
    rank, world_size = world()

    cfg = load_config(args.config)
    overrides = {}
    if args.steps is not None:
        overrides["num_steps"] = args.steps
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.ensemble_size is not None:
        overrides["ensemble_size"] = args.ensemble_size
    if args.num_workers is not None:
        overrides["dataset_num_workers"] = args.num_workers
    if args.learning_rate is not None:
        overrides["base_learning_rate"] = args.learning_rate
    train_cfg = dataclasses.replace(cfg.train, **overrides)
    # --precision wins over --config when given; with neither, bf16.
    if args.precision is not None or args.config is None:
        cfg = dataclasses.replace(cfg, train=train_cfg,
                                  precision=PrecisionConfig(compute_dtype=args.precision or "bf16"))
    else:
        cfg = dataclasses.replace(cfg, train=train_cfg)

    device = torch.device(args.device)
    mesh = None
    if world_size > 1:
        device = rank_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        mesh = make_mesh(cfg.train.ensemble_size, model_size=cfg.train.model_parallel_size)
        if device.type == "cuda":
            build_kernels_once(mesh)
    data_extent = mesh.extent(DATA_AXIS) if mesh is not None else 1
    minibatch = min(cfg.train.minibatch_size_per_device * data_extent, cfg.train.batch_size)
    logging.info("Training on %d device(s), batch %d, minibatch %d", world_size,
                 cfg.train.batch_size, minibatch)

    summary_writer = None if args.no_tensorboard or rank > 0 else configure_tensorboard()
    if summary_writer is not None:
        hparams = dict(cfg.model.metadata())
        hparams["train/batch_size"] = cfg.train.batch_size
        hparams["train/total_steps"] = cfg.train.num_steps
        hparams["train/warmup_steps"] = cfg.train.warmup_steps
        hparams = {k: (str(v) if isinstance(v, (list, tuple)) else v) for k, v in hparams.items()}
        summary_writer.add_hparams(hparams, {})

    rope = model_lib.make_rope(cfg.model, device)
    model, state = model_lib.init_ensemble(torch.Generator().manual_seed(1), cfg.model,
                                           cfg.train.ensemble_size)
    if cfg.train.use_custom_init:
        # Reference train.py:573-644 (its call disabled at :792).  JAX splits
        # PRNGKey(2) over the members.
        members = model if cfg.train.ensemble_size > 1 else [model]
        generators = model_lib.member_generators(torch.Generator().manual_seed(2), len(members))
        for member, generator in zip(members, generators):
            apply_init_surgery_(member, cfg.model.num_transformer_heads, generator)

    manager = ckpt.create_checkpoint_manager(
        Path(args.checkpoint), cfg, max_to_keep=cfg.train.checkpoints_to_keep,
        save_interval_steps=cfg.train.checkpoint_every)
    ckpt.check_metadata(manager, cfg)
    restored = ckpt.restore_checkpoint(manager, model, state)
    if restored is not None:
        model, state, restored_step = restored
        logging.info("Restored checkpoint at step %d", restored_step)
    if mesh is not None:
        # This rank's member on an ensemble axis, its shards under TP.
        model = place_model(model, mesh, cfg.model.num_transformer_heads)
        logging.info("rank %d of %d on %s: mesh %s", rank, world_size, device, mesh.shape)
    model = model.to(device).train()
    optimizer = setup_optimizers(model, cfg.model, cfg.train, mesh)

    num_frames = cfg.model.output_frames(cfg.data.samples_per_window)
    if cfg.train.batch_size % world_size:
        raise ValueError(f"batch_size {cfg.train.batch_size} does not divide over "
                         f"{world_size} processes")
    data_loader = create_dataset_loader(
        Path(args.dataset),
        # Each rank's local shard, from a stream of its own.
        batch_size=cfg.train.batch_size // world_size,
        num_workers=cfg.train.dataset_num_workers,
        num_epochs=100_000,
        sample_rate=cfg.data.sample_rate,
        duration=cfg.data.model_audio_length,
        output_divisions=num_frames,
        # With augmentation on the device the loader feeds raw windows.
        transform_settings=None if cfg.train.augment_on_device else cfg.transforms,
        # The JAX package's seeds (42, 0xBEEF) on rank 0.
        seed=42 + 7919 * rank,
        use_grain=not args.threaded_loader,
        threaded_seed=0xBEEF + 7919 * rank,
    )
    testset_dirs = {}
    for spec in args.testset:
        name, _, d = spec.partition("=")
        testset_dirs[name] = Path(d)

    try:
        loop.train(cfg, model, state, optimizer, data_loader, manager, schedule(cfg.train), rope,
                   num_frames, testset_dirs=testset_dirs, summary_writer=summary_writer,
                   mesh=mesh)
    finally:
        data_loader.close()
        if summary_writer is not None:
            summary_writer.close()
        if world_size > 1:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
