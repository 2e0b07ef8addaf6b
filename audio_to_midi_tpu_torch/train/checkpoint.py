"""Checkpoints with config metadata, without orbax.

Counterpart of ``audio_to_midi_tpu/train/checkpoint.py``.  Reference
semantics (train.py:799-831, infer.py:172-236): a manager that keeps
``max_to_keep`` checkpoints and saves every ``save_interval_steps`` steps,
the model and data-prep config stored as metadata for drift detection, a
restore of the latest step with a warning on a metadata mismatch, and a
resume at ``latest_step() + 1``.  As in the JAX package, a checkpoint holds
the parameters and the model state, not the optimizer.  On a mesh of
ranks rank 0 writes the gathered full layout (:func:`save_checkpoint`
with ``mesh=``) and every rank restores it whole, then takes its part
(``parallel.place_model``).

Layout: ``<dir>/metadata.json`` and one directory per step,
``<dir>/<step>/`` with ``params.npz`` (the flat JAX parameter layout that
``convert.save_npz`` writes and ``infer.load_params`` reads), ``state.json``
and ``metadata.json``.  An ``Ensemble``'s ``params.npz`` holds each leaf
with its leading ``(E,)`` axis, as the JAX package stores a population; one
member's holds it without that axis.  A step is written under a temporary
name and moved into place, so a reader never sees half a checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Any, Optional

import torch

from ..config import Config
from ..convert import load_npz, load_params_, params_to_jax, save_npz

PARAMS_FILE = "params.npz"
STATE_FILE = "state.json"
METADATA_FILE = "metadata.json"


_ON_DISK = object()  # should_save: read the newest step from the disk


class CheckpointManager:
    """Steps under one directory, the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str | Path, metadata: Optional[dict] = None,
                 max_to_keep: int = 3, save_interval_steps: int = 20):
        self.directory = Path(directory).resolve()
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._metadata = metadata

    def all_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit() and (p / PARAMS_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int, latest=_ON_DISK) -> bool:
        """Whether ``step`` is due: a multiple of ``save_interval_steps``
        past ``latest``, the newest step saved (default: read from the
        disk)."""
        if latest is _ON_DISK:
            latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0

    def metadata(self) -> Optional[dict]:
        """The stored metadata, or None."""
        path = self.directory / METADATA_FILE
        return json.loads(path.read_text()) if path.exists() else None

    def save(self, step: int, flat_params: dict, state: dict) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        if self._metadata is not None and not (self.directory / METADATA_FILE).exists():
            _write_json(self.directory / METADATA_FILE, self._metadata)
        tmp = self.directory / f".{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        save_npz(tmp / PARAMS_FILE, flat_params)
        (tmp / STATE_FILE).write_text(json.dumps(state))
        if self._metadata is not None:
            _write_json(tmp / METADATA_FILE, self._metadata)
        final = self.directory / str(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def restore(self, step: int) -> tuple[dict, dict]:
        d = self.directory / str(step)
        return load_npz(d / PARAMS_FILE), json.loads((d / STATE_FILE).read_text())


def _write_json(path: Path, value: Any) -> None:
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    tmp.write_text(json.dumps(value, indent=2))
    os.replace(tmp, path)


def create_checkpoint_manager(checkpoint_dir: str | Path, config: Optional[Config] = None,
                              max_to_keep: int = 3,
                              save_interval_steps: int = 20) -> CheckpointManager:
    return CheckpointManager(checkpoint_dir,
                             config.metadata() if config is not None else None,
                             max_to_keep=max_to_keep, save_interval_steps=save_interval_steps)


def save_checkpoint(manager: CheckpointManager, step: int, model: torch.nn.Module, state: dict,
                    force: bool = False, *, mesh=None, latest=_ON_DISK) -> bool:
    """Save ``model``'s parameters and ``state`` at ``step`` every
    ``save_interval_steps`` steps past ``latest``, the newest step saved (by
    default read from the disk), or when ``force``; True when saved.

    On a ``mesh`` of ranks (a collective: every rank calls it at every step)
    every rank takes part in gathering the full layout (``(E,)``-leading for
    a population); rank 0 writes it and the others wait at a barrier.  The
    caller passes the ``latest`` it tracks, so that no rank decides from a
    disk that rank 0 may be writing."""
    from ..parallel.mesh import gather_params

    if not force and not manager.should_save(step, latest):
        return False
    flat = params_to_jax(model) if mesh is None else gather_params(model, mesh)
    if mesh is None or mesh.rank == 0:
        manager.save(step, flat, state or {})
    if mesh is not None:
        mesh.barrier()
    return True


def check_metadata(manager: CheckpointManager, config: Config) -> bool:
    """Warn on config drift (reference train.py:816-819)."""
    stored = manager.metadata()
    current = json.loads(json.dumps(config.metadata()))
    if stored and stored != current:
        warnings.warn(f"Checkpoint metadata mismatch:\n  stored:  {stored}\n  current: {current}")
        return False
    return True


def restore_checkpoint(manager: CheckpointManager, model: torch.nn.Module,
                       state: Optional[dict] = None, step: Optional[int] = None):
    """Load the parameters at ``step`` (or the latest) into ``model`` (a
    ``Model`` or an ``Ensemble``, whose size the checkpoint must have) in
    place.  Returns (model, state, step), or None when there is none."""
    step = step if step is not None else manager.latest_step()
    if step is None:
        return None
    flat, stored_state = manager.restore(step)
    load_params_(model, flat)
    return model, stored_state if stored_state else (state or {}), step


def restore_raw(checkpoint_dir: str | Path, step: Optional[int] = None) -> tuple[dict, int]:
    """A checkpoint's flat parameter dict at ``step`` (or the latest),
    without a model to hold it: for the weight tools, where the stored
    layout is not known in advance."""
    manager = CheckpointManager(checkpoint_dir)
    step = step if step is not None else manager.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
    return manager.restore(step)[0], step

