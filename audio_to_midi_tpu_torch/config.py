"""Typed configuration of the PyTorch port.

Mirrors the sections of ``audio_to_midi_tpu.config`` (``model``, ``data``,
``precision``, ``train``, ``infer``, ``transforms``) with dtypes kept as the
strings ``"f32"``/``"bf16"``/``"f16"``.  :func:`config_from_json` reads the
JSON that the JAX package's ``config_to_json`` writes, and
:func:`config_to_json` writes it; :func:`config_from_metadata` rebuilds a
``Config`` from a checkpoint's metadata.

Scheduling knobs that only mean something to XLA on a TPU
(``*_scan_unroll``, ``*_remat``, ``fast_dropout_rng``,
``fused_flat_optimizer``) are kept as no-op fields so that configs
round-trip.  ``model_parallel_size`` is the tensor-parallel degree of a
multi-process run (``parallel/``).  ``cnn_impl`` and ``cnn_bwd_kernel`` select code, as
in the JAX package: which ConvNeXt stages go to the fused stage kernels
(``models/convnext.stage_route``).
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

    def metadata(self) -> dict[str, Any]:
        # The JAX package's key names, which follow the reference's.
        return {
            "midi_voccab_size": self.midi_vocab_size,
            "max_event_timestamp": self.model_audio_length,
            "num_velocity_categories": self.num_velocity_categories,
        }


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
    # device -- the counterpart of the JAX package's einsum route.
    # "pallas_block" (the attention block, kernel 11), "pallas_fused" (the
    # attention sublayers, kernel 18) and "pallas_pair" (a whole pair,
    # kernel 17) run ops/fused_layer_kernels.py where the JAX package runs
    # those kernels, and the plain cores elsewhere (dropout, f16, geometries
    # the gates refuse).  "pallas_rw" runs as "pallas" but for the
    # dropout-free two-phase local route, which takes the reduced-width
    # kernel 6 (ops/attention_kernels.local_two_phase_rw).
    attention_impl: str = "pallas"

    # No-op here: XLA scheduling knobs of the JAX package, kept so that
    # configs round-trip (autograd saves every block's activations, the fused
    # stage backward every block's input; at minibatch 32 they fit the card
    # many times over).
    cnn_remat: bool = True
    transformer_remat: bool = False
    transformer_scan_unroll: int = 8
    cnn_scan_unroll: int = 21
    fast_dropout_rng: bool = True
    # "pallas": stages whose geometry the stage-backward kernel takes (5 and 6
    # of the default dims) run the block loop forward and, with
    # cnn_bwd_kernel, that kernel backward.  "pallas_stage": the fused stage
    # forward kernel where it takes the stage (4, 5, 6), differentiated by
    # autograd through the block loop.  "xla": the block loop everywhere.
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

    def metadata(self) -> dict[str, Any]:
        """The checkpoint metadata of the JAX package's ``ModelConfig``."""
        return {
            "dims": list(self.dims),
            "depths": list(self.depths),
            "cnn_hidden_expansion": self.cnn_hidden_expansion,
            "num_transformer_layers": self.num_transformer_layers,
            "num_transformer_heads": self.num_transformer_heads,
            "attention_size": self.attention_size,
            "compressed_attention_q_size": self.compressed_attention_q_size,
            "compressed_attention_kv_size": self.compressed_attention_kv_size,
            "transformer_dropout_rate": self.transformer_dropout_rate,
            "transformer_hidden_expansion": self.transformer_hidden_expansion,
            "sdd_rate": self.sdd_rate,
        }


@dataclass(frozen=True)
class PrecisionConfig:
    """Params live in ``param_dtype``; the forward runs in ``compute_dtype``."""

    param_dtype: str = "f32"
    compute_dtype: str = "bf16"

    @property
    def needs_loss_scaling(self) -> bool:
        return self.compute_dtype == "f16"


@dataclass(frozen=True)
class TransformSettings:
    """The train-time augmentations' probabilities (the JAX package's
    ``TransformSettings``): each transform runs ``int(p * batch)`` times."""

    pan_probability: float = 0.8
    channel_switch_probability: float = 0.5
    cut_probability: float = 0.4
    rotate_probability: float = 0.9
    random_erasing_probability: float = 0.3
    mixup_probability: float = 0.6
    gain_probability: float = 0.8
    noise_probability: float = 0.8
    label_smoothing_alpha: float = 0.005
    # The reference passes channel_switch_probability to the pan transform;
    # True reproduces that, False uses pan_probability.
    parity_pan_uses_channel_switch_probability: bool = False
    # The timbre extensions (device path only, off by default).
    eq_probability: float = 0.0
    eq_strength: float = 0.4
    dynamics_warp_probability: float = 0.0
    am_jitter_probability: float = 0.0

    def as_tuple(self) -> tuple:
        """The nine reference probabilities, in the native plane's order."""
        return (
            self.pan_probability,
            self.channel_switch_probability,
            self.cut_probability,
            self.rotate_probability,
            self.random_erasing_probability,
            self.mixup_probability,
            self.gain_probability,
            self.noise_probability,
            self.label_smoothing_alpha,
        )


@dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field."""

    batch_size: int = 64
    minibatch_size_per_device: int = 32     # gradient-accumulation minibatch
    num_steps: int = 200_000
    warmup_steps: int = 1000
    base_learning_rate: float = 1e-4
    layer_lr_decay: float = 0.7             # CNN layer-wise LR decay
    weight_decay: float = 0.005
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-3                  # the reference's value, intentional
    global_norm_clip: float = 1.0
    ensemble_size: int = 1                  # members of the population
    model_parallel_size: int = 1            # tensor-parallel ranks ("model" axis)
    checkpoint_every: int = 20
    checkpoints_to_keep: int = 3
    testset_loss_every: int = 20
    print_every: int = 10
    dataset_num_workers: int = 3
    recovery_snapshot_every: int = 100
    loss_scale_increase_threshold: float = 10_000.0
    seed: int = 1234
    # No-op for good: a TPU launch-count knob.  The port's optimizer updates
    # every parameter with a few multi-tensor (torch._foreach_*) calls.
    fused_flat_optimizer: bool = False
    use_custom_init: bool = False           # train/init_surgery.py at init
    # The transforms run on the model's device (data/augment_device.py) and
    # the loader feeds raw windows.
    augment_on_device: bool = True
    # Windows in the device-resident pool (data/device_ring.py), rounded up
    # to a multiple of batch_size; 0 feeds a host batch per step.
    input_ring_capacity: int = 1024
    input_ring_refresh_period: int = 1
    input_ring_reuse_warn_factor: float = 64.0


@dataclass(frozen=True)
class InferConfig:
    window_overlap: float = 0.5   # seconds of overlap between 5 s windows
    checkpoint_dir: str = "audio_to_midi_checkpoints"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    # None: no augmentation at all.
    transforms: TransformSettings | None = field(default_factory=TransformSettings)

    def metadata(self) -> dict[str, Any]:
        """Checkpoint metadata, the JAX package's layout."""
        return {"model": self.model.metadata(), "data_prep": self.data.metadata()}


DEFAULT_CONFIG = Config()

_SECTIONS = {
    "model": ModelConfig,
    "data": DataConfig,
    "precision": PrecisionConfig,
    "train": TrainConfig,
    "infer": InferConfig,
    "transforms": TransformSettings,
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
        if data is None and name == "transforms":
            sections[name] = None
            continue
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


def config_from_metadata(meta: dict[str, Any]) -> Config:
    """Rebuild a Config from checkpoint metadata, the inverse of
    :meth:`Config.metadata`: the keys and defaults of the JAX package's
    ``config_from_metadata`` (the misspelt ``"midi_voccab_size"`` among
    them); every field they do not name keeps its default."""
    m = meta.get("model", {})
    d = meta.get("data_prep", {})
    model = ModelConfig(
        dims=tuple(m.get("dims", ModelConfig.dims)),
        depths=tuple(m.get("depths", ModelConfig.depths)),
        cnn_hidden_expansion=m.get("cnn_hidden_expansion", 2.0),
        num_transformer_layers=m.get("num_transformer_layers", 8),
        num_transformer_heads=m.get("num_transformer_heads", 4),
        attention_size=m.get("attention_size", 64),
        compressed_attention_q_size=m.get("compressed_attention_q_size", 64),
        compressed_attention_kv_size=m.get("compressed_attention_kv_size", 64),
        transformer_dropout_rate=m.get("transformer_dropout_rate", 0.1),
        transformer_hidden_expansion=m.get("transformer_hidden_expansion", 2.0),
        sdd_rate=m.get("sdd_rate", 0.1),
    )
    data = DataConfig(
        midi_vocab_size=d.get("midi_voccab_size", MIDI_EVENT_VOCAB_SIZE),
        model_audio_length=d.get("max_event_timestamp", MODEL_AUDIO_LENGTH),
        num_velocity_categories=d.get("num_velocity_categories", NUM_VELOCITY_CATEGORIES),
    )
    return Config(model=model, data=data)
