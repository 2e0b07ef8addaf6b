"""Top-level audio -> MIDI transcription model.

Counterpart of ``audio_to_midi_tpu/models/model.py``: the 7-stage ConvNeXt
CNN over raw stereo audio, the alternating local/global transformer, and a
LayerNorm + Linear + sigmoid decoder.  With the default config,
(B, 2, 80000) stereo 5 s at 16 kHz -> (B, 250, 256) -> (B, 250, 90).

The parameters live in :class:`Model`; ``forward`` is a function of the
model, the config, the audio and the RoPE tables, as in the JAX package.
A population (the JAX package's leading ``(E,)`` axis on every leaf) is an
:class:`Ensemble` of ``Model``s, each run in turn.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import torch
from torch import nn

from ..config import ModelConfig
from . import nn as a2m_nn
from .convnext import CNN, cnn_forward
from .rope import RopeFreqs, precompute_frequencies
from .transformer import TransformerStack, transformer_stack


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.norm = a2m_nn.LayerNorm(cfg.transformer_hidden_dim)
        self.out = a2m_nn.Linear(cfg.transformer_hidden_dim, cfg.output_vocab, generator)


class Model(nn.Module):
    """All parameters, laid out as the JAX tree (see ``convert.py``).

    ``generator`` draws the initial weights at the JAX package's scales."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cnn = CNN(cfg, generator)
        self.transformer = TransformerStack(cfg, generator)
        self.decoder = Decoder(cfg, generator)


def init(generator: torch.Generator, cfg: ModelConfig) -> tuple[Model, dict]:
    """A model drawn from ``generator`` at the JAX package's scales (weights
    and biases uniform in +-1/sqrt(fan_in), LayerNorm scales ones and biases
    zeros), in the JAX parameter tree (``convert.py``), and its (empty)
    state: JAX's ``init``."""
    return Model(cfg, generator), {}


class Ensemble(nn.Module):
    """A population of ``Model``s: member i holds what the JAX package keeps
    at index i of every leaf's leading ``(E,)`` axis."""

    def __init__(self, members: Iterable[Model]):
        super().__init__()
        self.members = nn.ModuleList(members)

    def __len__(self) -> int:
        return len(self.members)

    def __getitem__(self, index: int) -> Model:
        return self.members[index]

    def __iter__(self) -> Iterator[Model]:
        return iter(self.members)


def member_generators(generator: torch.Generator, count: int) -> list[torch.Generator]:
    """``count`` generators on ``generator``'s device, each seeded with the
    next draw of ``generator``: the port's ``jax.random.split(key, count)``."""
    seeds = torch.randint(0, 2 ** 62, (count,), generator=generator, device=generator.device)
    return [torch.Generator(device=generator.device).manual_seed(int(s)) for s in seeds.tolist()]


def init_ensemble(generator: torch.Generator, cfg: ModelConfig,
                  ensemble_size: int = 1) -> tuple[Model | Ensemble, dict]:
    """JAX's ``init_ensemble``: ``ensemble_size`` members, each drawn from a
    generator of its own seeded from ``generator``.  One member is
    :func:`init`'s ``Model`` itself, with no population around it."""
    if ensemble_size == 1:
        return init(generator, cfg)
    return Ensemble(Model(cfg, g) for g in member_generators(generator, ensemble_size)), {}


def make_rope(cfg: ModelConfig, device: torch.device | str = "cpu") -> RopeFreqs:
    return precompute_frequencies(
        cfg.attention_size, cfg.rope_max_positions, cfg.rope_theta, device=device
    )


def decoder(x: torch.Tensor, p: Decoder) -> tuple[torch.Tensor, torch.Tensor]:
    """LN -> Linear -> sigmoid."""
    out = a2m_nn.layer_norm(x, p.norm.scale, p.norm.bias)
    logits = a2m_nn.linear(out, p.out.w, p.out.b)
    return logits, torch.sigmoid(logits)


def forward(
    model: Model, cfg: ModelConfig, audio: torch.Tensor, rope: RopeFreqs, *,
    enable_dropout: bool = False, generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """audio: (B, 2, num_samples) -> (logits, probs), each (B, frames, 90).

    ``enable_dropout`` turns on attention-weight dropout and feed-forward
    dropout at ``cfg.transformer_dropout_rate`` and, with
    ``cfg.enable_cnn_stochastic_depth`` (off in the reference's
    configuration), CNN stochastic depth.  All of them draw from
    ``generator``, which must live on the audio's device; the same generator
    state gives the same forward, bit for bit.  With a rate of 0 it is the
    serving forward under autograd, as in the JAX package, where a zero rate
    keeps the dropout-free kernels in training, and needs no generator."""
    x = audio.transpose(1, 2)  # (B, L, 2): NWC
    h = cnn_forward(x, model.cnn, cfg, generator=generator, enable_dropout=enable_dropout)
    h = transformer_stack(h, model.transformer, rope, cfg, generator=generator,
                          enable_dropout=enable_dropout)
    return decoder(h, model.decoder)


def predict(model: Model, cfg: ModelConfig, samples: torch.Tensor,
            rope: RopeFreqs) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-sample inference: samples (2, num_samples) -> (logits, probs),
    each (frames, 90)."""
    logits, probs = forward(model, cfg, samples[None], rope)
    return logits[0], probs[0]


def compute_model_output_frames(model: Model, cfg: ModelConfig, num_samples: int) -> int:
    """The frame count read off the logits of one zero window through the
    model (reference train.py:64-73).  ``ModelConfig.output_frames``
    computes the same number statically; this exists to verify it."""
    param = next(model.parameters())
    rope = make_rope(cfg, param.device)
    samples = torch.zeros((1, 2, num_samples), dtype=param.dtype, device=param.device)
    with torch.no_grad():
        logits, _ = forward(model, cfg, samples, rope)
    return int(logits.shape[1])


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def cast_params(model: Model, dtype: torch.dtype) -> Model:
    """Cast every floating parameter in place; returns the model."""
    return model.to(dtype)
