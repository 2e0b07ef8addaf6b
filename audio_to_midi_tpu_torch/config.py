"""Typed configuration of the PyTorch port.

Mirrors the serving-relevant sections of ``audio_to_midi_tpu.config``
(``model``, ``data``, ``precision``, ``infer``) with dtypes kept as the
strings ``"f32"``/``"bf16"``/``"f16"``.  :func:`config_from_json` reads the
JSON that the JAX package's ``config_to_json`` writes; the sections the port
does not use yet (``train``, ``transforms``) are ignored.

Scheduling knobs that only mean something to XLA on a TPU
(``*_scan_unroll``, ``*_remat``, ``fast_dropout_rng``, ``cnn_impl``,
``cnn_bwd_kernel``) are kept as no-op fields so that configs round-trip.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

MIDI_EVENT_VOCAB_SIZE = 90          # piano keys 88 + 2 (A0..C8 biased by -21)
MODEL_AUDIO_LENGTH = 5.0            # seconds per model window
NUM_VELOCITY_CATEGORIES = 10
FREQUENCY_CUTOFF = 8_000
SAMPLE_RATE = 2 * FREQUENCY_CUTOFF  # 16 kHz

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


@dataclass(frozen=True)
class DataConfig:
    midi_vocab_size: int = MIDI_EVENT_VOCAB_SIZE
    model_audio_length: float = MODEL_AUDIO_LENGTH
    num_velocity_categories: int = NUM_VELOCITY_CATEGORIES
    frequency_cutoff: int = FREQUENCY_CUTOFF

    @property
    def sample_rate(self) -> int:
        return 2 * self.frequency_cutoff

    @property
    def samples_per_window(self) -> int:
        return int(self.sample_rate * self.model_audio_length)


@dataclass(frozen=True)
class ModelConfig:
    dims: tuple[int, ...] = tuple(4 * (2 ** i) for i in range(7))
    depths: tuple[int, ...] = (3, 3, 3, 3, 3, 21, 3)
    cnn_hidden_expansion: float = 2.0

    num_transformer_layers: int = 8      # alternating (local, global) pairs
    num_transformer_heads: int = 4
    attention_size: int = 64             # per-head dim
    compressed_attention_q_size: int = 64
    compressed_attention_kv_size: int = 64
    transformer_dropout_rate: float = 0.1
    transformer_hidden_expansion: float = 2.0
    local_context_window: int = 16
    sdd_rate: float = 0.1
    enable_cnn_stochastic_depth: bool = False

    rope_max_positions: int = 300
    rope_theta: float = 10_000.0

    # "pallas": both attention cores run as the port's CUDA kernels
    # (ops/attention_kernels.py) on CUDA tensors, and as their plain
    # versions on CPU tensors.  "xla": the plain PyTorch versions on any
    # device -- the counterpart of the JAX package's einsum route.  The other
    # JAX values name kernels that are not ported yet and raise.
    attention_impl: str = "pallas"

    # No-op here: XLA scheduling knobs of the JAX package, kept so that
    # configs round-trip.
    cnn_remat: bool = True
    transformer_remat: bool = False
    transformer_scan_unroll: int = 8
    cnn_scan_unroll: int = 21
    fast_dropout_rng: bool = True
    cnn_impl: str = "pallas"
    cnn_bwd_kernel: bool = True

    output_vocab: int = MIDI_EVENT_VOCAB_SIZE

    @property
    def transformer_hidden_dim(self) -> int:
        return self.dims[-1]

    @property
    def transformer_intermediate_size(self) -> int:
        return int(self.transformer_hidden_dim * self.transformer_hidden_expansion)

    @property
    def cnn_hidden_dims(self) -> tuple[int, ...]:
        return tuple(int(d * self.cnn_hidden_expansion) for d in self.dims)

    @property
    def total_downsample(self) -> int:
        # stem /5, then /2 per later stage
        return 5 * 2 ** (len(self.dims) - 1)

    def output_frames(self, num_samples: int) -> int:
        return num_samples // self.total_downsample


@dataclass(frozen=True)
class PrecisionConfig:
    """Params live in ``param_dtype``; the forward runs in ``compute_dtype``."""

    param_dtype: str = "f32"
    compute_dtype: str = "bf16"


@dataclass(frozen=True)
class InferConfig:
    window_overlap: float = 0.5   # seconds of overlap between 5 s windows
    checkpoint_dir: str = "audio_to_midi_checkpoints"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    infer: InferConfig = field(default_factory=InferConfig)


DEFAULT_CONFIG = Config()

_SECTIONS = {
    "model": ModelConfig,
    "data": DataConfig,
    "precision": PrecisionConfig,
    "infer": InferConfig,
}


def config_to_json(cfg: Config) -> str:
    """The port's sections in the JAX package's JSON layout."""
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def config_from_json(text: str) -> Config:
    """Read a JSON config (the port's or the JAX package's).  Missing fields
    keep their defaults; sections and fields the port does not know are
    ignored."""
    raw = json.loads(text)
    sections: dict[str, Any] = {}
    for name, cls in _SECTIONS.items():
        data = raw.get(name, {})
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in data.items()
            if k in known
        }
        sections[name] = cls(**kwargs)
    for name in ("param_dtype", "compute_dtype"):
        value = getattr(sections["precision"], name)
        if value not in DTYPES:
            raise ValueError(f"precision.{name} must be one of {sorted(DTYPES)}, got {value!r}")
    return Config(**sections)


def load_config(path: str | Path | None) -> Config:
    """Config for an entry point: ``path`` (JSON) or the defaults."""
    if path is None:
        return DEFAULT_CONFIG
    return config_from_json(Path(path).read_text())
