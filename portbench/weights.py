"""Random weights from the seed, made on the device in a few large calls and
handed alike to the program and to the reference.

By name, in the port's state-dict layout: a weight ``*.w`` and its bias
``*.b`` are uniform in +-1/sqrt(fan_in) (fan_in: ``in`` of a linear (in,
out), ``K * C_in/groups`` of a conv WIO); a LayerNorm scale is uniform in
[0.75, 1.25] and its bias in [-0.1, 0.1]; a ConvNeXt layer scale ``gamma``
is uniform in [0.25, 1].  The port initializes gamma to 1e-6, which leaves
the blocks unseen at the output; trained models carry large ones, and the
check has to see every block.

Random weights leave the note density to the seed: the decoder's biases
decide how often a key's probability crosses the eventizer's thresholds.
:func:`set_note_density` therefore shifts them, once in set-up, so that
the plain reference eventizes a probe of the traffic's audio at the
traffic's own rate of notes.  Every seed then hands the eventizer about the
same work.  For training, :func:`set_label_prior` puts them at the log-odds
of the share of cells that notes cover, where a trained model's biases
start.
"""

from __future__ import annotations

import math

import torch

from .generate import seed_ints

DECODER_BIAS = "decoder.out.b"


def _fan_in(shape) -> int:
    if len(shape) == 3:        # conv WIO
        return shape[0] * shape[1]
    return shape[0]            # linear (in, out)


def _range(name: str, shapes: dict) -> tuple[float, float]:
    if name.endswith(".w"):
        r = 1.0 / math.sqrt(_fan_in(shapes[name]))
        return -r, r
    if name.endswith(".b"):
        r = 1.0 / math.sqrt(_fan_in(shapes[name[:-1] + "w"]))
        return -r, r
    if name.endswith(".scale"):
        return 0.75, 1.25
    if name.endswith(".bias"):
        return -0.1, 0.1
    if name.endswith(".gamma"):
        return 0.25, 1.0
    raise ValueError(f"no distribution for parameter {name!r}")


def make(shapes: dict[str, tuple[int, ...]], seed: int, device: torch.device) -> dict:
    """name -> float32 tensor on ``device``, views of one flat buffer."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    bounds = torch.tensor([_range(n, shapes) for n in names], dtype=torch.float32)
    counts = torch.tensor(sizes, dtype=torch.int64)
    lo = bounds[:, 0].to(device).repeat_interleave(counts.to(device))
    hi = bounds[:, 1].to(device).repeat_interleave(counts.to(device))
    gen = torch.Generator(device=device).manual_seed(seed_ints(seed, 1, salt=4)[0])
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat = lo + (hi - lo) * flat
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(sizes))}


def set_note_density(params: dict, model_cfg: dict, windows: torch.Tensor, overlap_s: float,
                     window_s: float, notes_per_s: float, probe_s: float) -> dict:
    """Shift ``params``' decoder biases in place: each key's by the median
    of its logits over the probe ``windows`` (W, 2, N), all of them by one
    more amount, bisected so that the reference's eventizer finds
    ``notes_per_s`` notes a second in the probe's ``probe_s`` seconds.
    Returns what was found, for the log."""
    from .reference import eventize as ref_eventize
    from .reference import stitch as ref_stitch
    from .reference.model import Reference

    with torch.no_grad():
        logits = Reference(params, model_cfg).logits(windows)
    centre = logits.flatten(0, 1).median(dim=0).values
    target = notes_per_s * probe_s

    def notes(shift: float) -> int:
        probs = torch.sigmoid(logits - centre + shift)
        return len(ref_eventize.events(ref_stitch.stitch(probs, overlap_s, window_s).cpu().numpy()))

    lo, hi = -16.0, 0.0
    if notes(hi) > target:
        for _ in range(12):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if notes(mid) < target else (lo, mid)
    shift = hi
    params[DECODER_BIAS] += shift - centre
    return {"shift": shift, "probe_notes": notes(shift), "target": target}


def set_label_prior(params: dict, prior: float) -> None:
    """The decoder biases at the log-odds of ``prior``, the share of (frame,
    key) cells that a note covers in the training data.  Biases near 0 give
    every cell a loss of about log 2, so that every row costs about the same
    and a step that left half of its rows out would read like a sound one."""
    params[DECODER_BIAS].fill_(math.log(prior / (1.0 - prior)))
