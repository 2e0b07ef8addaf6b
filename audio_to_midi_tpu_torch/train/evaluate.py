"""Test-set evaluation: per-sample loss, hit rate and eventized diff.

Counterpart of ``audio_to_midi_tpu/train/evaluate.py``.  Reference semantics (train.py:75-209): every sample of the test-set
directory is split into its windows (cache skipped) and run through the
model in f32; per sample the window losses are averaged and the window
probabilities are CONCATENATED (not crossfade-stitched, train.py:150)
before ``metrics.detailed_event_loss``, which runs on the model's device.
The results keep the JAX package's leading member axis: with ``ensemble``
an ``Ensemble``'s members are evaluated in turn, (E,) results; one
``Model`` gives (1,).  The figures wait for the port's
``utils/visualize.py``: the figure list is empty.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..config import Config
from ..data import loader
from ..infer import _parity_precision
from ..metrics import detailed_event_loss
from ..models import model as model_lib
from ..models.model import Ensemble
from ..models.rope import RopeFreqs
from .loss import sigmoid_bce_sum

# Bounded by count and by bytes (a long test set can be GBs): test sets
# above the per-entry budget are reloaded on every evaluation.
_TESTSET_CACHE: dict[tuple, list] = {}
_TESTSET_CACHE_MAX_ENTRIES = 4
_TESTSET_CACHE_ENTRY_BUDGET = 2 * 1024**3  # bytes
_MAX_WINDOWS_PER_BATCH = 64


def _load_test_set_uncached(testset_dir: str, num_frames: int, sample_rate: int,
                            duration: float):
    batches = []
    for name in loader.load_sample_names(testset_dir):
        audio, events, _ = loader.load_events_and_audio(
            testset_dir, [name], sample_rate, duration, num_frames, skip_cache=True)
        batches.append((name, np.stack(audio), np.stack(events)))
    return batches


def load_test_set(testset_dir: str | Path, num_frames: int, cfg: Config):
    """[(name, audio (W, 2, N) f32, labels (W, F, K) f32)] per sample."""
    key = (str(testset_dir), num_frames, cfg.data.sample_rate, cfg.data.model_audio_length)
    if key in _TESTSET_CACHE:
        return _TESTSET_CACHE[key]
    batches = _load_test_set_uncached(*key)
    if sum(a.nbytes + e.nbytes for _, a, e in batches) <= _TESTSET_CACHE_ENTRY_BUDGET:
        while len(_TESTSET_CACHE) >= _TESTSET_CACHE_MAX_ENTRIES:
            _TESTSET_CACHE.pop(next(iter(_TESTSET_CACHE)))
        _TESTSET_CACHE[key] = batches
    return batches


@torch.no_grad()
def _infer_windows(model, cfg: Config, audio: torch.Tensor, labels: torch.Tensor,
                   rope: RopeFreqs) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (probs, per-window losses), f32, on the model's device."""
    logits, probs = model_lib.forward(model, cfg.model, audio, rope)
    return probs.float(), sigmoid_bce_sum(logits.float(), labels.float())


def _members(model, ensemble: bool) -> list[model_lib.Model]:
    if isinstance(model, Ensemble):
        if not ensemble:
            raise ValueError("ensemble=False takes one Model, not an Ensemble: select a member")
        return list(model)
    return [model]


def compute_testset_loss_individual(
    model: model_lib.Model | Ensemble,
    cfg: Config,
    testset_dir: str | Path,
    num_model_output_frames: int,
    rope: RopeFreqs,
    ensemble: bool = True,
) -> dict[str, dict[str, Any]]:
    """Per sample: loss, hit_rate, eventized_diff, phantom_note_diff,
    missed_note_diff (each of shape (E,), (1,) for one ``Model``) and
    visualizations ([])."""
    members = _members(model, ensemble)
    batches = load_test_set(testset_dir, num_model_output_frames, cfg)
    param = next(model.parameters())
    loss_map: dict[str, dict[str, Any]] = {}
    with _parity_precision(torch.float32):
        for name, audio, labels in batches:
            expected = torch.from_numpy(labels.reshape(-1, labels.shape[-1])).to(param.device)
            fields: dict[str, list[float]] = {k: [] for k in (
                "loss", "hit_rate", "eventized_diff", "phantom_note_diff", "missed_note_diff")}
            for member in members:
                probs_chunks, loss_chunks = [], []
                for lo in range(0, audio.shape[0], _MAX_WINDOWS_PER_BATCH):
                    a = torch.from_numpy(audio[lo: lo + _MAX_WINDOWS_PER_BATCH]).to(param.device)
                    lab = torch.from_numpy(labels[lo: lo + _MAX_WINDOWS_PER_BATCH]).to(
                        param.device)
                    p, l = _infer_windows(member, cfg, a.to(param.dtype), lab, rope)
                    probs_chunks.append(p)
                    loss_chunks.append(l)
                probs = torch.cat(probs_chunks)
                detail = detailed_event_loss(probs.reshape(-1, probs.shape[-1]), expected)
                fields["loss"].append(float(torch.cat(loss_chunks).mean()))
                fields["hit_rate"].append(detail.hit_rate)
                fields["eventized_diff"].append(detail.full_diff)
                fields["phantom_note_diff"].append(detail.phantom_notes_diff)
                fields["missed_note_diff"].append(detail.missed_notes_diff)
            loss_map[name] = {k: np.array(v) for k, v in fields.items()}
            loss_map[name]["visualizations"] = []
    return loss_map


def compute_testset_loss(
    model: model_lib.Model | Ensemble,
    cfg: Config,
    testset_dir: str | Path,
    num_model_output_frames: int,
    rope: RopeFreqs,
    ensemble: bool = True,
):
    """Averages over samples -> (loss (E,), hit_rate (E,), eventized (E,),
    figs); (1,) each for one ``Model``."""
    per_sample = compute_testset_loss_individual(
        model, cfg, testset_dir, num_model_output_frames, rope, ensemble)
    n = len(per_sample)
    loss = sum(v["loss"] for v in per_sample.values()) / n
    hit = sum(v["hit_rate"] for v in per_sample.values()) / n
    eventized = sum(v["eventized_diff"] for v in per_sample.values()) / n
    return loss, hit, eventized, []
