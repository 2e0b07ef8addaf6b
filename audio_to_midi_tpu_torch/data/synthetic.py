"""Synthetic piano-ish dataset generation (tests + benchmarks): the JAX
package's ``data/synthetic.py``, which writes the same files for a seed.

The reference has no test assets; we synthesize decaying-harmonic "piano"
notes from known MIDI events, write WAV + CSV pairs in the reference dataset
layout, and use them for end-to-end tests (known notes -> transcription) and
benchmarking without shipping audio.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import SAMPLE_RATE
from .audio_io import write_wav
from .labels import write_events_csv


def midi_key_frequency(key: int) -> float:
    return 440.0 * 2.0 ** ((key - 69) / 12.0)


def synth_note(
    key: int,
    duration_s: float,
    sample_rate: int = SAMPLE_RATE,
    velocity: float = 0.7,
    decay: float = 3.0,
    harmonics: tuple[tuple[int, float], ...] = (
        (1, 1.0), (2, 0.5), (3, 0.25), (4, 0.125)
    ),
    inharmonicity: float = 0.0,
    attack_s: float = 0.0,
    tremolo: tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """Decaying harmonic stack with a sharp attack — crude piano.

    ``decay``/``harmonics`` vary the timbre (generalization experiments);
    the defaults are the original fixed voice.  The extra controls change
    the generator STRUCTURE, not just its parameter ranges — used to build
    a disjoint synthesis *family* for cross-family generalization tests:
      * ``inharmonicity`` B: partial h sounds at h*f0*sqrt(1 + B*h^2)
        (stiff-string stretching, real pianos B ~ 1e-4..1e-3);
      * ``attack_s``: slow linear attack replacing the percussive
        1-exp(-200 t) onset;
      * ``tremolo`` (depth, hz): amplitude modulation.
    """
    n = int(duration_s * sample_rate)
    t = np.arange(n, dtype=np.float32) / sample_rate
    f0 = midi_key_frequency(key)
    x = np.zeros(n, np.float32)
    for h, amp in harmonics:
        f = f0 * h * float(np.sqrt(1.0 + inharmonicity * h * h))
        if f < sample_rate / 2:
            x += amp * np.sin(2 * np.pi * f * t, dtype=np.float32)
    if attack_s > 0:
        attack = np.clip(t / attack_s, 0.0, 1.0)
    else:
        attack = 1 - np.exp(-200.0 * t)
    env = np.exp(-decay * t) * attack
    depth, hz = tremolo
    if depth > 0 and hz > 0:
        env = env * (1.0 - depth * 0.5 * (1 - np.cos(2 * np.pi * hz * t)))
    return (velocity * x * env).astype(np.float32)


def synth_performance(
    events: list[tuple[float, float, int, float]],
    total_s: float,
    sample_rate: int = SAMPLE_RATE,
    seed: int = 0,
    stereo_spread: float = 0.2,
    decay: float = 3.0,
    harmonics: tuple[tuple[int, float], ...] = (
        (1, 1.0), (2, 0.5), (3, 0.25), (4, 0.125)
    ),
    **note_kwargs,
) -> np.ndarray:
    """events: (onset_s, duration_s, midi_key, velocity 0..1) -> (2, N)."""
    rng = np.random.default_rng(seed)
    n = int(total_s * sample_rate)
    left = np.zeros(n, np.float32)
    right = np.zeros(n, np.float32)
    for onset, dur, key, vel in events:
        note = synth_note(
            key, dur, sample_rate, vel, decay=decay, harmonics=harmonics,
            **note_kwargs,
        )
        start = int(onset * sample_rate)
        stop = min(n, start + note.shape[0])
        if stop <= start:
            continue
        pan = 0.5 + stereo_spread * (rng.random() - 0.5)
        left[start:stop] += note[: stop - start] * (1 - pan)
        right[start:stop] += note[: stop - start] * pan
    peak = max(np.max(np.abs(left)), np.max(np.abs(right)), 1e-6)
    scale = 0.8 / peak
    return np.stack([left * scale, right * scale])


def random_events(
    total_s: float, num_notes: int, seed: int = 0, chord_prob: float = 0.0
) -> list[tuple[float, float, int, float]]:
    """Random note events; ``chord_prob`` adds a consonant companion note at
    the same onset with probability per note (harder polyphonic data)."""
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(num_notes):
        onset = float(rng.uniform(0.0, max(total_s - 0.5, 0.1)))
        dur = float(rng.uniform(0.2, 1.5))
        key = int(rng.integers(36, 96))  # C2..C7
        vel = float(rng.uniform(0.4, 1.0))
        events.append((onset, min(dur, total_s - onset), key, vel))
        if chord_prob > 0 and rng.random() < chord_prob:
            interval = int(rng.choice([3, 4, 5, 7, 12]))
            key2 = min(key + interval, 95)
            events.append((onset, min(dur, total_s - onset), key2, vel * 0.9))
    events.sort()
    return events


def _family_voice(family: str, rng: np.random.Generator) -> dict:
    """Per-sample timbre draw for a synthesis FAMILY.

    The two families are structurally disjoint generators, not just
    different parameter ranges (VERDICT r03: cross-family generalization
    evidence needs holdout timbres a trained model never saw the likes of):

      * "percussive" — the original generator: percussive 1-exp(-200 t)
        attack, harmonic partials, 5 harmonics, decay U(1.5, 5), rolloff
        U(0.3, 0.7).
      * "sustained" — slow-attack (U(10, 60) ms), INHARMONIC partials
        (stiff-string B ~ U(2e-4, 1.5e-3)), brighter and deeper stacks
        (8 partials, rolloff U(0.55, 0.85)), faster decay U(0.6, 1.3),
        tremolo depth U(0.1, 0.4) at U(4, 7) Hz.
    """
    if family == "percussive":
        # Draw order matches the original variety path exactly (decay, then
        # rolloff) so seeded datasets reproduce across rounds.
        decay = float(rng.uniform(1.5, 5.0))
        rolloff = float(rng.uniform(0.3, 0.7))
        return dict(
            decay=decay,
            harmonics=tuple((h, rolloff ** (h - 1)) for h in range(1, 6)),
        )
    if family == "sustained":
        rolloff = float(rng.uniform(0.55, 0.85))
        return dict(
            decay=float(rng.uniform(0.6, 1.3)),
            harmonics=tuple((h, rolloff ** (h - 1)) for h in range(1, 9)),
            inharmonicity=float(rng.uniform(2e-4, 1.5e-3)),
            attack_s=float(rng.uniform(0.01, 0.06)),
            tremolo=(float(rng.uniform(0.1, 0.4)), float(rng.uniform(4.0, 7.0))),
        )
    raise ValueError(f"unknown synthesis family {family!r}")


def _resolve_family(family: str, index: int) -> str:
    """Map a requested family name to the concrete per-sample generator.

    "mixed" (the corpus-coverage twin of the cross-family transfer
    experiment) alternates deterministically by sample index, so every
    corpus — however small — is exactly 50/50 and a mixed dataset's
    even/odd samples are byte-identical to the corresponding pure-family
    datasets (the family choice consumes no rng draw)."""
    if family == "mixed":
        return "percussive" if index % 2 == 0 else "sustained"
    return family


def make_synthetic_dataset(
    out_dir: str | Path,
    num_samples: int = 4,
    duration_s: float = 6.0,
    notes_per_sample: int = 12,
    sample_rate: int = SAMPLE_RATE,
    seed: int = 0,
    variety: bool = False,
    family: str | None = None,
) -> list[str]:
    """Write <name>.wav + <name>.csv pairs in the reference dataset layout.

    ``variety=True`` randomizes timbre per sample (decay, harmonic rolloff)
    and adds chords — the generalization-experiment mode; False keeps the
    original fixed voice (test fixtures).  ``family`` (implies variety)
    draws each sample's voice from a named structurally-disjoint generator
    (:func:`_family_voice`) for cross-family holdout experiments."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(num_samples):
        name = f"sample_{i:03d}"
        s = seed * 1000 + i
        voice: dict = {}
        if family is not None:
            rng = np.random.default_rng(s + 7_777_777)
            voice = _family_voice(_resolve_family(family, i), rng)
            chord_prob = float(rng.uniform(0.1, 0.5))
        elif variety:
            rng = np.random.default_rng(s + 7_777_777)
            voice = _family_voice("percussive", rng)
            chord_prob = float(rng.uniform(0.1, 0.5))
        else:
            chord_prob = 0.0
        events = random_events(
            duration_s, notes_per_sample, seed=s, chord_prob=chord_prob
        )
        audio = synth_performance(
            events, duration_s, sample_rate, seed=s, **voice
        )
        write_wav(out_dir / f"{name}.wav", audio, sample_rate)
        write_events_csv(out_dir / f"{name}.csv", events)
        names.append(name)
    return names
