"""Top-level audio -> MIDI transcription model.

Counterpart of ``audio_to_midi_tpu/models/model.py``: the 7-stage ConvNeXt
CNN over raw stereo audio, the alternating local/global transformer, and a
LayerNorm + Linear + sigmoid decoder.  With the default config,
(B, 2, 80000) stereo 5 s at 16 kHz -> (B, 250, 256) -> (B, 250, 90).

The parameters live in :class:`Model`; ``forward`` is a function of the
model, the config, the audio and the RoPE tables, as in the JAX package.
"""

from __future__ import annotations

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
    model: Model, cfg: ModelConfig, audio: torch.Tensor, rope: RopeFreqs
) -> tuple[torch.Tensor, torch.Tensor]:
    """audio: (B, 2, num_samples) -> (logits, probs), each (B, frames, 90)."""
    x = audio.transpose(1, 2)  # (B, L, 2): NWC
    h = cnn_forward(x, model.cnn)
    h = transformer_stack(h, model.transformer, rope, cfg)
    return decoder(h, model.decoder)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def cast_params(model: Model, dtype: torch.dtype) -> Model:
    """Cast every floating parameter in place; returns the model."""
    return model.to(dtype)
