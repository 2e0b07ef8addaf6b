"""The one traffic generator: reads a mix's data file (``traffic/<name>.json``)
and turns a seed into the requests and the audio they carry.

A serving mix is a ladder of recording lengths (``ladder_s``).  Every cycle
sends each rung once, in an order the seed shuffles, so every seed sends
the same multiset of lengths.  The audio of a recording is a slice, at an
offset the seed draws, of one seeded master recording.  The master is made
on the device: a note every ``note_every_s`` seconds, each a decaying sine
at a piano pitch with a seeded key and stereo pan, summed over its first
``note_tail_s`` seconds, then scaled to a peak of ``peak``.
``distinct_sets`` sets of slices are cut, and cycle c plays set c mod that
count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def seed_ints(seed: int, count: int, salt: int = 0) -> list[int]:
    """``count`` 63-bit integers derived from any whole-number ``seed``."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), salt]).generate_state(
        2 * count, np.uint32)
    return [int(state[2 * i]) << 31 ^ int(state[2 * i + 1]) for i in range(count)]


def windows_for(seconds: float, dst_rate: int, window_s: float, overlap_s: float) -> int:
    """Model windows of a recording of ``seconds`` (the serving frontend's
    count: at least one, every ``window - overlap`` samples)."""
    window = round(window_s * dst_rate)
    overlap = round(overlap_s * dst_rate)
    n = math.ceil(seconds * dst_rate)
    return max(1, math.ceil((n - overlap) / (window - overlap)))


@dataclass(frozen=True)
class Request:
    index: int      # position in the run's sequence
    rung: int       # index into the ladder
    seconds: float
    set: int        # which set of slices carries its audio


class Ladder:
    """The order of a serving mix's requests under one seed."""

    def __init__(self, mix: dict, seed: int):
        self.lengths = [float(s) for s in mix["ladder_s"]]
        self.sets = int(mix["distinct_sets"])
        self._rng = np.random.default_rng(seed_ints(seed, 1, salt=1)[0])
        self._orders: list[list[int]] = []
        self.offsets_s = np.random.default_rng(seed_ints(seed, 1, salt=2)[0]).uniform(
            0.0, 1.0, (self.sets, len(self.lengths)))

    def cycle(self, c: int) -> list[int]:
        while len(self._orders) <= c:
            self._orders.append([int(i) for i in self._rng.permutation(len(self.lengths))])
        return self._orders[c]

    def request(self, index: int) -> Request:
        c, pos = divmod(index, len(self.lengths))
        rung = self.cycle(c)[pos]
        return Request(index, rung, self.lengths[rung], c % self.sets)

    def offset(self, set_index: int, rung: int, master_s: float) -> float:
        """Start of a slice, in seconds: uniform over where it fits."""
        return float(self.offsets_s[set_index, rung]) * (master_s - self.lengths[rung])


def master(mix: dict, seed: int, device: torch.device) -> torch.Tensor:
    """(2, master_s * src_rate) float32 on ``device``."""
    rate = int(mix["src_rate"])
    n = int(mix["master_s"] * rate)
    every = round(mix["note_every_s"] * rate)
    tail = math.ceil(mix["note_tail_s"] / mix["note_every_s"])
    notes = -(-n // every)
    gen = torch.Generator(device=device).manual_seed(seed_ints(seed, 1, salt=3)[0])
    lo, hi = mix["keys"]
    keys = torch.randint(lo, hi, (notes,), generator=gen, device=device)
    freq = 440.0 * torch.pow(2.0, (keys.double() + 21 - 69) / 12)
    pan = torch.empty(notes, device=device).uniform_(*mix["pan"], generator=gen)
    sample = torch.arange(n, device=device)
    slot = sample // every
    out = torch.zeros((2, n), dtype=torch.float32, device=device)
    for back in range(tail):
        note = slot - back
        live = note >= 0
        note = note.clamp(min=0)
        since = ((sample - note * every).double() / rate)
        tone = (torch.exp(-mix["decay"] * since) * torch.sin(2 * math.pi * freq[note] * since)
                ).float() * live
        out[0] += pan[note] * tone
        out[1] += (1 - pan[note]) * tone
    return out * (mix["peak"] / out.abs().max())
