"""Train-time augmentations on the model's device.

Counterpart of ``audio_to_midi_tpu/data/augment_device.py``: the nine
transforms of the reference (python.rs:566-932) in its order -- pan,
channel switch, cut-mix, rotate, random erasing, mixup, gain, noise, label
smoothing -- and the three timbre extensions (EQ, dynamics warp, AM
jitter), off by default.  Semantics, as in JAX: each transform applies
``int(p * batch)`` times to items drawn uniformly with replacement, in
order, and repeated draws of an item compound.

The random streams cannot match JAX's threefry, so what carries over is the
distributions and the semantics.  The design keeps the host from waiting on
the card and the launches few:

  * :func:`draw` takes every random number of a batch up front from an
    explicit CPU ``torch.Generator`` -- item indices, spans, gains, filters
    -- and the noise from a device generator seeded by it.  The host knows
    every index without reading the card; the per-application numbers go
    to the device in one copy of each dtype.
  * The applications of a transform are scheduled in *waves*: an
    application joins the first wave after the last one that wrote an item
    it reads, and not before a wave that read the item it writes.  A wave
    gathers its items, computes, and scatters, so each application reads
    what it would have read in the sequential order, and the result is the
    sequential one bit for bit.  For the eight per-item transforms a wave
    is a round: wave r applies every item's r-th draw; cut-mix and mixup,
    which read a second item, keep their order through the same rule.
  * :func:`augment_sequential` applies the same draws one application at a
    time, in order: the plain version the waves are held against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TransformSettings

_PAN_EPS = 0.01
_MIN_CUT = 0.01
_MIN_ERASE, _MAX_ERASE = 0.01, 0.10
_EQ_TAPS = 128
_HOP = 256

def num_applications(prob: float, batch: int) -> int:
    return int(prob * batch)


def _probabilities(settings: TransformSettings) -> dict[str, float]:
    """Each transform's probability, in the order they apply."""
    pan = (settings.channel_switch_probability
           if settings.parity_pan_uses_channel_switch_probability
           else settings.pan_probability)
    return {
        "pan": pan, "channel_switch": settings.channel_switch_probability,
        "cut_mix": settings.cut_probability, "rotate": settings.rotate_probability,
        "random_erasing": settings.random_erasing_probability,
        "mixup": settings.mixup_probability, "gain": settings.gain_probability,
        "noise": settings.noise_probability, "eq": settings.eq_probability,
        "dynamics_warp": settings.dynamics_warp_probability,
        "am_jitter": settings.am_jitter_probability,
    }


def waves(writes: np.ndarray, reads: np.ndarray | None) -> np.ndarray:
    """The wave of each application: after every earlier write of an item
    it reads (its own ``writes[i]`` and ``reads[i]``), and not before an
    earlier read of the item it writes (a wave reads before it writes)."""
    wave = np.zeros(len(writes), np.int64)
    last_write: dict[int, int] = {}
    last_read: dict[int, int] = {}
    for i, a in enumerate(writes.tolist()):
        srcs = (a,) if reads is None else (a, int(reads[i]))
        w = last_read.get(a, 0)
        for r in srcs:
            if r in last_write:
                w = max(w, last_write[r] + 1)
        wave[i] = w
        last_write[a] = w
        for r in srcs:
            last_read[r] = max(last_read.get(r, 0), w)
    return wave


@dataclass
class Stage:
    """One transform's draws.  Device tensors are in wave order: wave ``w``
    is rows ``bounds[w]:bounds[w + 1]``; ``row[i]`` is the row of
    application ``i`` (the sequential order)."""

    name: str
    writes: np.ndarray                        # (n,) the item each application writes
    reads: np.ndarray | None                  # (n,) the second item it reads
    host: dict[str, np.ndarray | torch.Tensor] = field(default_factory=dict)
    dev: dict[str, torch.Tensor] = field(default_factory=dict)
    bounds: np.ndarray | None = None
    row: np.ndarray | None = None

    @property
    def n(self) -> int:
        return len(self.writes)


@dataclass
class Draws:
    """Every random number of one augmented batch."""

    stages: list[Stage]
    label_smoothing_alpha: float


def _uniform(n: int, g: torch.Generator, lo=0.0, hi=1.0) -> torch.Tensor:
    """JAX's ``uniform(minval, maxval)``: lo + u * (hi - lo), in f32."""
    return lo + torch.rand(n, generator=g) * (hi - lo)


def _eq_filters(coef: torch.Tensor) -> torch.Tensor:
    """(n, 4) cepstral coefficients -> (n, 128) FIR taps, reversed so that
    ``y[t] = sum_j x_pad[t + j] * taps[j]`` is JAX's ``convolve(x, h)``."""
    orders = torch.arange(1, 5, dtype=torch.float32)
    freqs = torch.linspace(0.0, 1.0, _EQ_TAPS // 2 + 1)
    log_mag = (coef[:, :, None] * torch.cos(math.pi * orders[:, None] * freqs[None, :])).sum(1)
    h = torch.fft.irfft(torch.exp(log_mag).to(torch.complex64), _EQ_TAPS)
    return torch.roll(h, _EQ_TAPS // 2, dims=1).flip(1).contiguous()


def draw(settings: TransformSettings, batch: int, num_samples: int, num_frames: int,
         generator: torch.Generator, device: torch.device | str) -> Draws:
    """Draw every random number of one batch from the CPU ``generator``,
    the noise on ``device`` from a generator seeded by it, and send the rest
    to ``device`` in one copy per dtype."""
    device = torch.device(device)
    g = generator
    n_samples, n_frames = num_samples, num_frames
    stages = []
    for name, prob in _probabilities(settings).items():
        n = num_applications(prob, batch)
        if n <= 0:
            continue
        writes = torch.randint(0, batch, (n,), generator=g).numpy()
        reads = (torch.randint(0, batch, (n,), generator=g).numpy()
                 if name in ("cut_mix", "mixup") else None)
        host: dict = {}
        if name == "pan":
            host["pf"] = torch.rand(n, generator=g)
        elif name == "cut_mix":
            cs = _uniform(n, g, 0.0, 1.0 - _MIN_CUT)
            cl = _MIN_CUT + torch.rand(n, generator=g) * ((1.0 - cs) - _MIN_CUT)
            host["lo"], host["hi"] = (cs * n_samples).long(), ((cs + cl) * n_samples).long()
            host["flo"], host["fhi"] = (cs * n_frames).long(), ((cs + cl) * n_frames).long()
        elif name == "rotate":
            roll = torch.rand(n, generator=g)
            host["shift"], host["fshift"] = (roll * n_samples).long(), (roll * n_frames).long()
        elif name == "random_erasing":
            es = _uniform(n, g, 0.0, 1.0 - _MIN_ERASE)
            el = _MIN_ERASE + torch.rand(n, generator=g) * (
                torch.clamp(1.0 - es, max=_MAX_ERASE) - _MIN_ERASE)
            host["lo"], host["hi"] = (es * n_samples).long(), ((es + el) * n_samples).long()
        elif name == "mixup":
            # Beta(2, 2) is the law of the median of three uniforms.
            host["lam"] = torch.rand(n, 3, generator=g).median(dim=1).values
        elif name == "gain":
            host["gain"] = torch.clamp(1.0 + 0.25 * torch.randn(n, generator=g), 0.5, 1.5)
        elif name == "noise":
            host["sigma"] = _uniform(n, g, 0.0, 0.25)
            seed = int(torch.randint(0, 2 ** 62, (), generator=g))
            noise_gen = torch.Generator(device=device).manual_seed(seed)
            host["z"] = torch.randn((n, 2, n_samples), generator=noise_gen, device=device)
        elif name == "eq":
            orders = torch.arange(1, 5, dtype=torch.float32)
            host["taps"] = _eq_filters(torch.randn(n, 4, generator=g) * settings.eq_strength
                                       / orders)
        elif name == "dynamics_warp":
            host["gamma"] = _uniform(n, g, 0.6, 1.5)
        elif name == "am_jitter":
            host["depth"] = _uniform(n, g, 0.0, 0.4)
            host["cycles"] = _uniform(n, g, 10.0, 40.0)
            host["phase"] = _uniform(n, g, 0.0, 2.0 * math.pi)
        stages.append(Stage(name, writes, reads, host))
    _pack(stages, device)
    return Draws(stages, settings.label_smoothing_alpha)


def _pack(stages: list[Stage], device: torch.device) -> None:
    """Order each stage's rows by wave and move them to ``device``: one copy
    for the int64 rows, one for the float32 rows (the noise is there
    already)."""
    ints, floats = [], []
    for st in stages:
        wave = waves(st.writes, st.reads)
        order = np.argsort(wave, kind="stable")
        st.row = np.empty_like(order)
        st.row[order] = np.arange(st.n)
        st.bounds = np.searchsorted(wave[order], np.arange(int(wave.max()) + 2))
        order_t = torch.from_numpy(order)
        st.host["write"] = torch.from_numpy(st.writes)
        if st.reads is not None:
            st.host["read"] = torch.from_numpy(st.reads)
        for key, value in st.host.items():
            if key == "z":
                continue
            value = value[order_t]
            (ints if value.dtype == torch.int64 else floats).append((st, key, value))
    for group, dtype in ((ints, torch.int64), (floats, torch.float32)):
        if not group:
            continue
        flat = torch.cat([v.reshape(-1).to(dtype) for _, _, v in group])
        if device.type == "cuda":
            flat = flat.pin_memory().to(device, non_blocking=True)
        else:
            flat = flat.to(device)
        offset = 0
        for st, key, value in group:
            st.dev[key] = flat[offset: offset + value.numel()].view(value.shape)
            offset += value.numel()
    for st in stages:
        if "z" in st.host:  # i.i.d. rows: row r is the noise of the r-th row's application
            st.dev["z"] = st.host.pop("z")


# ---------------------------------------------------------------------------
# The transforms, on a wave's rows [s, e) at once
# ---------------------------------------------------------------------------


def _span(n: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(k, n) mask of [lo, hi) per row."""
    ar = torch.arange(n, device=lo.device)
    return (ar >= lo[:, None]) & (ar < hi[:, None])


def _pan_gains(pf: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.clamp(2.0 * (1.0 - pf), max=1.0),
                        torch.clamp(2.0 * pf, max=1.0)], -1)


def _silent(item: torch.Tensor) -> torch.Tensor:
    """(..., 2, N) -> (...): either channel below the pan's threshold."""
    quiet = (item.abs() < _PAN_EPS).all(-1)
    return quiet[..., 0] | quiet[..., 1]


def _roll_index(shift: torch.Tensor, n: int) -> torch.Tensor:
    """(k,) shifts -> (k, n) source positions of ``roll(x, shift)``."""
    return torch.remainder(torch.arange(n, device=shift.device) - shift[:, None], n)


def _eq(item: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """FIR over (k, 2, N) items with (k, 128) taps, one tap at a time (a
    fixed order of sums per sample, whatever k)."""
    n = item.shape[-1]
    x = F.pad(item, (_EQ_TAPS // 2, _EQ_TAPS // 2 - 1))
    y = x[..., 0:n] * taps[:, 0, None, None]
    for j in range(1, _EQ_TAPS):
        y = y + x[..., j: j + n] * taps[:, j, None, None]
    return y


def _dynamics(item: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    k, _, n = item.shape
    nw = n // _HOP
    seg = item[:, :, : nw * _HOP].reshape(k, 2, nw, _HOP)
    rms = torch.sqrt(torch.mean(seg ** 2, dim=-1) + 1e-8)
    scale = (rms / (rms.amax(-1, keepdim=True) + 1e-8)) ** (gamma[:, None, None] - 1.0)
    scale = scale.repeat_interleave(_HOP, dim=-1)
    scale = torch.cat([scale, scale[..., -1:].expand(k, 2, n - nw * _HOP)], -1)
    return item * scale


def _am_envelope(depth, cycles, phase, n: int) -> torch.Tensor:
    """(k,) draws -> (k, N) envelopes, t in units of the window."""
    t = torch.arange(n, dtype=torch.float32, device=depth.device) / float(n)
    arg = 2 * math.pi * cycles[:, None] * t[None, :] + phase[:, None]
    return 1.0 - depth[:, None] * 0.5 * (1.0 - torch.cos(arg))


def _apply(st: Stage, audio: torch.Tensor, labels: torch.Tensor, s: int, e: int) -> None:
    """Apply rows [s, e) of ``st`` (distinct written items) at once."""
    d = {key: value[s:e] for key, value in st.dev.items()}
    idx = d["write"]
    n, f = audio.shape[-1], labels.shape[1]
    name = st.name
    if name == "cut_mix":
        src = d["read"]
        am = _span(n, d["lo"], d["hi"])[:, None, :]
        fm = _span(f, d["flo"], d["fhi"])[:, :, None]
        new_audio = torch.where(am, audio[src], audio[idx])
        new_labels = torch.where(fm, labels[src], labels[idx])
        audio[idx] = new_audio
        labels[idx] = new_labels
        return
    if name == "mixup":
        src = d["read"]
        lam = d["lam"][:, None, None]
        new_audio = lam * audio[idx] + (1.0 - lam) * audio[src]
        new_labels = torch.maximum(labels[idx], labels[src])
        audio[idx] = new_audio
        labels[idx] = new_labels
        return
    if name == "rotate":
        item = audio[idx]
        rows = labels[idx]
        src = _roll_index(d["shift"], n)[:, None, :].expand_as(item)
        fsrc = _roll_index(d["fshift"], f)[:, :, None].expand_as(rows)
        audio[idx] = torch.gather(item, 2, src)
        labels[idx] = torch.gather(rows, 1, fsrc)
        return
    item = audio[idx]
    if name == "pan":
        new = torch.where(_silent(item)[:, None, None], item,
                          item * _pan_gains(d["pf"])[:, :, None])
    elif name == "channel_switch":
        new = item.flip(1)
    elif name == "random_erasing":
        new = torch.where(_span(n, d["lo"], d["hi"])[:, None, :], 0.0, item)
    elif name == "gain":
        new = item * d["gain"][:, None, None]
    elif name == "noise":
        new = item + d["sigma"][:, None, None] * d["z"]
    elif name == "eq":
        new = _eq(item, d["taps"])
    elif name == "dynamics_warp":
        new = _dynamics(item, d["gamma"])
    elif name == "am_jitter":
        new = item * _am_envelope(d["depth"], d["cycles"], d["phase"], n)[:, None, :]
    else:
        raise ValueError(f"unknown transform {name!r}")
    audio[idx] = new


def augment_(audio: torch.Tensor, labels: torch.Tensor, draws: Draws) -> None:
    """Apply ``draws`` in place on (B, 2, N) audio and (B, F, K) labels,
    float32 on the draws' device, one wave at a time."""
    for st in draws.stages:
        for w in range(len(st.bounds) - 1):
            _apply(st, audio, labels, int(st.bounds[w]), int(st.bounds[w + 1]))
    if draws.label_smoothing_alpha > 0:
        alpha = draws.label_smoothing_alpha
        labels.clamp_(alpha, 1.0 - alpha)


def augment_sequential(audio: torch.Tensor, labels: torch.Tensor, draws: Draws) -> None:
    """The plain version of :func:`augment_`: the same draws, one
    application at a time, in the order they were drawn, on one item
    (``audio[a]``, (2, N)) at a time."""
    n, f = audio.shape[-1], labels.shape[1]
    for st in draws.stages:
        for i in range(st.n):
            j = int(st.row[i])
            d = {key: value[j] for key, value in st.dev.items()}
            a = int(st.writes[i])
            item = audio[a]
            if st.name == "pan":
                gains = torch.stack([torch.clamp(2.0 * (1.0 - d["pf"]), max=1.0),
                                     torch.clamp(2.0 * d["pf"], max=1.0)])
                quiet = (item.abs() < _PAN_EPS).all(-1)
                audio[a] = torch.where(quiet[0] | quiet[1], item, item * gains[:, None])
            elif st.name == "channel_switch":
                audio[a] = item.flip(0)
            elif st.name == "cut_mix":
                b = int(st.reads[i])
                lo, hi, flo, fhi = (int(st.host[key][i]) for key in ("lo", "hi", "flo", "fhi"))
                audio[a, :, lo:hi] = audio[b, :, lo:hi].clone()
                labels[a, flo:fhi] = labels[b, flo:fhi].clone()
            elif st.name == "rotate":
                audio[a] = torch.roll(item, int(st.host["shift"][i]), dims=1)
                labels[a] = torch.roll(labels[a], int(st.host["fshift"][i]), dims=0)
            elif st.name == "random_erasing":
                audio[a, :, int(st.host["lo"][i]): int(st.host["hi"][i])] = 0.0
            elif st.name == "mixup":
                b = int(st.reads[i])
                lam = d["lam"]
                new = lam * audio[a] + (1.0 - lam) * audio[b]
                labels[a] = torch.maximum(labels[a], labels[b])
                audio[a] = new
            elif st.name == "gain":
                audio[a] = item * d["gain"]
            elif st.name == "noise":
                audio[a] = item + d["sigma"] * d["z"]
            elif st.name == "eq":
                audio[a] = _eq(item[None], d["taps"][None])[0]
            elif st.name == "dynamics_warp":
                audio[a] = _dynamics(item[None], d["gamma"][None])[0]
            elif st.name == "am_jitter":
                env = _am_envelope(d["depth"][None], d["cycles"][None], d["phase"][None], n)
                audio[a] = item * env
    if draws.label_smoothing_alpha > 0:
        alpha = draws.label_smoothing_alpha
        labels.clamp_(alpha, 1.0 - alpha)


def transform_for_training_device(audio: torch.Tensor, labels: torch.Tensor,
                                  settings: TransformSettings,
                                  generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 2, N) audio and (B, F, K) labels -> augmented float32 copies on
    their device, the draws from the CPU ``generator``."""
    audio = audio.to(torch.float32, copy=True)
    labels = labels.to(torch.float32, copy=True)
    b, _, n = audio.shape
    draws = draw(settings, b, n, labels.shape[1], generator, audio.device)
    augment_(audio, labels, draws)
    return audio, labels
