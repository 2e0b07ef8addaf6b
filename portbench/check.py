"""The output check of a serving cell: the program's answers against the
plain reference on a sample of the recordings it finished.

For each sampled recording the reference runs the whole chain from the same
raw audio and weights: frontend, forward (in float32, TF32 off), stitch.
A configuration compares the numbers its ``check`` names, each against its
limit:

* ``prob_gap``: the widest gap between the program's stitched probabilities
  and the reference's, over every frame and key of the sample (infinite
  where the frame counts differ);
* ``prob_gap_mean``: the mean of that gap over every frame and key of the
  sample, steadier from seed to seed than the widest;
* ``event_mismatch``: how many sampled recordings have a note list that
  differs from the reference eventizer's on the program's own probabilities.
  An event is an exact answer, so its limit is 0.

A recording whose call raised counts in ``failed`` and makes the run not
correct.

A run and ``calibrate.py`` take the same path: :func:`sample` picks the
finished recordings to check, and :func:`readings` runs the reference on
them and compares.  The control enters only there, as the reference at the
configuration's ``control`` precision in the program's place.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from .generate import seed_ints
from .reference import eventize as ref_eventize
from .reference import frontend as ref_frontend
from .reference import stitch as ref_stitch
from .reference.model import Reference
from .reference.train import DrawMismatch, Trainer


def reference_stitched(reference: Reference, samples: torch.Tensor, src_rate: int,
                       dst_rate: int, window_s: float, overlap_s: float) -> torch.Tensor:
    """Raw (2, N) audio on the device -> (frames, vocab) float32 stitched
    probabilities, by the reference alone."""
    windows = ref_frontend.prepare(samples, src_rate, dst_rate, round(window_s * dst_rate),
                                   round(overlap_s * dst_rate))
    with torch.no_grad():
        probs = reference.probs(windows)
    return ref_stitch.stitch(probs, overlap_s, window_s)


def sample(outputs: dict, seed: int, size: int) -> tuple[list, list]:
    """``outputs``: index -> (request, stitched probabilities, notes) of
    finished requests.  Draws ``size`` of them from the seed, a longest one
    first, and returns (requests, [(stitched numpy, notes)]) of those."""
    if not outputs:
        return [], []
    rng = np.random.default_rng(seed_ints(seed, 1, salt=5)[0])
    longest = max(req.seconds for req, _, _ in outputs.values())
    top = [k for k, (req, _, _) in outputs.items() if req.seconds == longest]
    first = int(rng.choice(top))
    rest = [k for k in outputs if k != first]
    picked = rng.choice(rest, size=min(size - 1, len(rest)), replace=False) if rest else []
    keys = [first, *(int(k) for k in picked)]
    return ([outputs[k][0] for k in keys],
            [(outputs[k][1].float().cpu().numpy(), outputs[k][2]) for k in keys])


def _stitched(params: dict, config: dict, mix: dict, audio: dict, requests: list,
              device, precision: str) -> list:
    reference = Reference(params, config["model"], precision)
    return [reference_stitched(
        reference, torch.from_numpy(audio[r.set, r.rung]).to(device), mix["src_rate"],
        config["data"]["sample_rate"], config["data"]["window_s"], mix["overlap_s"]
    ).cpu().numpy() for r in requests]


def readings(program: list, requests: list, params: dict, config: dict, mix: dict,
             audio: dict, device, control: bool = False) -> dict:
    """The numbers of the check: ``{"program": compare(...)}``, and with
    ``control`` also ``"control"``: the same numbers of the reference at the
    configuration's ``control`` precision, put in the program's place, its
    notes by the reference eventizer.  ``audio``: (set, rung) -> the raw
    recording both sides were given."""
    expected = _stitched(params, config, mix, audio, requests, device, "f32")
    out = {"program": compare(program, expected)}
    if control:
        lower = _stitched(params, config, mix, audio, requests, device, config["control"])
        out["control"] = compare([(s, ref_eventize.events(s)) for s in lower], expected)
    return out


def compare(program: list, expected: list) -> dict:
    """``program``: (stitched numpy, events) per sampled recording;
    ``expected``: the reference's stitched numpy for the same recordings."""
    gap, total, cells, mismatch = 0.0, 0.0, 0, 0
    for (stitched, events), ref in zip(program, expected):
        if stitched.shape != ref.shape:
            gap = total = math.inf
        else:
            diff = np.abs(stitched.astype(np.float64) - ref)
            widest = float(diff.max())
            gap = math.inf if math.isnan(widest) else max(gap, widest)
            total += float(diff.sum())
            cells += diff.size
        if list(events) != ref_eventize.events(stitched):
            mismatch += 1
    mean = total / cells if cells and not math.isnan(total) else math.inf
    return {"prob_gap": gap, "prob_gap_mean": mean, "event_mismatch": mismatch}


def judge(values: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}), every number against its limit."""
    checks = {name: {"value": values[name], "limit": limits[name]} for name in limits}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


# -- training ---------------------------------------------------------------
#
# A training cell compares, against the plain reference's steps from the
# same weights on the same rows and dropout draws:
#
# * ``loss_gap``: the widest relative gap of a checked step's loss;
# * ``grad_norm_gap``: the first gradient as the optimizer took it, by the
#   worst leaf: |norm(program) - norm(reference)| over the larger of the
#   reference's norm of that leaf and of the median leaf;
# * ``change_norm_gap``: the parameters' change over the checked steps,
#   likewise, over the leaves whose reference gradient is at least a
#   thousandth of the median leaf's (the others move by round-off alone).


def _worst(program: dict, reference: dict, names: list) -> float:
    median = statistics.median(reference[n] for n in names)
    gaps = [abs(program[n] - reference[n]) / max(reference[n], median) for n in names]
    worst = max(gaps)
    return math.inf if math.isnan(worst) else worst


def train_compare(program: dict, reference: dict) -> dict:
    """``program``, ``reference``: {"loss": [per step], "grad_norms":
    {leaf: norm}, "change_norms": {leaf: norm}}."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], reference["loss"]))
    grads = reference["grad_norms"]
    median = statistics.median(grads.values())
    moving = [n for n in grads if grads[n] >= 1e-3 * median]
    return {"loss_gap": math.inf if math.isnan(loss) else loss,
            "grad_norm_gap": _worst(program["grad_norms"], grads, list(grads)),
            "change_norm_gap": _worst(program["change_norms"], reference["change_norms"],
                                      moving)}


def train_steps(initial: dict, rows: list, draws: list, config: dict, mix: dict, device,
                precision: str = "f32", keep_rows: float = 1.0) -> dict:
    """The plain reference's steps over ``rows`` (per step: audio, labels)
    with ``draws`` (per step, per minibatch), in the observations
    ``train_compare`` takes."""
    trainer = Trainer(initial, config["model"], mix["optimizer"], device, precision,
                      block=mix["reference_block"], keep_rows=keep_rows)
    loss, grad_norms = [], None
    for (audio, labels), step_draws in zip(rows, draws):
        value, grads = trainer.step(audio, labels, step_draws)
        loss.append(value)
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
    after = trainer.params()
    change = {k: float((after[k].cpu() - initial[k].cpu()).norm()) for k in after}
    return {"loss": loss, "grad_norms": grad_norms, "change_norms": change}


def train_readings(program: dict, rows: list, draws: list, initial: dict, config: dict,
                   mix: dict, device, control: bool = False) -> dict:
    """``{"program": train_compare(...)}`` against the f32 reference, and
    with ``control`` also ``"control"`` (the reference at the
    configuration's ``control`` precision in the program's place) and
    ``"half_batch"`` (the f32 reference with each minibatch's second half
    left out, the mean taken over the rest).  Draws that do not fit the
    rows the program trained on fail every number."""
    try:
        expected = train_steps(initial, rows, draws, config, mix, device)
    except DrawMismatch:
        return {"program": dict.fromkeys(("loss_gap", "grad_norm_gap", "change_norm_gap"),
                                         math.inf)}
    out = {"program": train_compare(program, expected)}
    if control:
        out["control"] = train_compare(
            train_steps(initial, rows, draws, config, mix, device, config["control"]), expected)
        out["half_batch"] = train_compare(
            train_steps(initial, rows, draws, config, mix, device, keep_rows=0.5), expected)
    return out
