"""Model export: a ``torch.export`` program (``.pt2``), and CoreML / TFLite
where their converters are installed.

Counterpart of ``audio_to_midi_tpu/export.py``, which exports
``model.predict`` on a (2, samples_per_window) example through
``jax.export`` as StableHLO.  The port has no StableHLO emitter: its
portable form is the ``ExportedProgram`` of the same function, saved with
``torch.export.save`` (``--format pt2``, which stands in for JAX's
``stablehlo``).  On the card the program holds the attention kernels (and,
on their routes, the fused-layer and stage kernels) as the custom operators
``torch.ops.a2m.*`` that ``ops/`` registers, so a loaded program launches the
same kernels as the eager model.  A process that loads a program imports the
port first (:func:`load_program` does), which registers them.

CoreML and TFLite cannot run those operators: they convert the program
traced on the CPU with ``attention_impl`` and ``cnn_impl`` set to ``"xla"``,
the plain formulations, as the JAX package hands the converter what it
traces on a CPU host.

Usage: python -m audio_to_midi_tpu_torch.export [--checkpoint DIR|FILE]
       [--config JSON] [--format pt2|coreml|tflite] [--output PATH]
       [--device cuda|cpu]
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from pathlib import Path

import torch
from torch import nn

from .config import DEFAULT_CONFIG, Config, ModelConfig
from .infer import _parity_precision
from .models import model as model_lib
from .models.rope import RopeFreqs

log = logging.getLogger(__name__)


class _PredictFn(nn.Module):
    """``model_lib.predict`` with the RoPE tables as arguments."""

    def __init__(self, model: model_lib.Model, cfg: ModelConfig):
        super().__init__()
        self.model = model
        self.cfg = cfg

    def forward(self, samples, cos, sin):
        return model_lib.predict(self.model, self.cfg, samples, RopeFreqs(cos, sin))


class _Program(nn.Module):
    """What ``torch.export`` traces: samples (2, N) -> (logits, probs).

    The model is not a submodule of this one.  Its transformer pairs hold a
    submodule named ``global``, a Python keyword, and the code that
    ``ExportedProgram.module()`` generates reads parameters by their dotted
    names.  The parameters are listed here under indices and swapped into
    the model by ``functional_call``; the RoPE tables go in as constants."""

    def __init__(self, model: model_lib.Model, cfg: ModelConfig, rope: RopeFreqs):
        super().__init__()
        fn = _PredictFn(model, cfg)
        self.__dict__["fn"] = fn
        named = list(fn.named_parameters())
        self.names = [name for name, _ in named]
        self.params = nn.ParameterList(p for _, p in named)
        self.cos, self.sin = rope.cos, rope.sin

    def forward(self, samples):
        return torch.func.functional_call(self.fn, dict(zip(self.names, self.params)),
                                          (samples, self.cos, self.sin))


def _on_device(model: model_lib.Model, device) -> model_lib.Model:
    """``model`` itself on ``device``, or a copy moved there."""
    device = torch.device(device)
    param = next(model.parameters())
    if param.device.type == device.type:
        return model
    return copy.deepcopy(model).to(device)


def export_program(
    model: model_lib.Model,
    cfg: Config = DEFAULT_CONFIG,
    example_dtype: torch.dtype = torch.float16,
    output_file: str | Path | None = None,
    device: str | torch.device = "cuda",
) -> torch.export.ExportedProgram:
    """``predict`` on a (2, samples_per_window) example of ``example_dtype``
    on ``device`` (the model is copied there if it lies elsewhere), as an
    ``ExportedProgram``; written to ``output_file`` (``.pt2``) when given.

    The input's dtype sets the compute dtype, as in the JAX package: every
    parameter is cast to it at use.  The default f16 (JAX's) reaches no
    kernel, since no kernel takes f16; an f32 or bf16 example on the card
    traces the kernels of the model's routes as ``torch.ops.a2m.*`` nodes."""
    model = _on_device(model, device)
    rope = model_lib.make_rope(cfg.model, device)
    example = torch.zeros((2, cfg.data.samples_per_window), dtype=example_dtype, device=device)
    with torch.no_grad():
        program = torch.export.export(_Program(model, cfg.model, rope).eval(), (example,))
    if output_file is not None:
        torch.export.save(program, str(output_file))
        log.info("Wrote the exported program to %s", output_file)
    return program


def load_program(path: str | Path) -> torch.export.ExportedProgram:
    """A program :func:`export_program` wrote, with the kernels' operators
    registered."""
    from .ops import attention_kernels, convnext_kernels, fused_layer_kernels  # noqa: F401

    return torch.export.load(str(path))


def run_program(program: torch.export.ExportedProgram, samples: torch.Tensor):
    """(logits, probs) of ``samples`` (2, N) through ``program``, under the
    precision the eager model serves in (``infer._parity_precision`` of the
    parameters' dtype: TF32 off for f32).  The graph carries no
    ``torch.backends`` flag, so without it an f32 program would not give the
    eager model's bits."""
    dtype = next(iter(program.state_dict.values())).dtype
    with _parity_precision(dtype), torch.no_grad():
        return program.module()(samples)


def kernel_nodes(program: torch.export.ExportedProgram) -> dict[str, int]:
    """The ``a2m::*`` operator nodes of ``program``'s graph, by operator."""
    counts: dict[str, int] = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("a2m."):
            name = str(node.target).split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def _plain_routes(cfg: Config) -> Config:
    """``cfg`` with the plain formulations on every route: what a converter
    that cannot run the kernels' operators takes."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attention_impl="xla", cnn_impl="xla"))


def export_model_to_coreml(model: model_lib.Model, cfg: Config = DEFAULT_CONFIG,
                           output_file: str | Path = "Audio2Midi.mlpackage"):
    """CoreML export: the program traced on the CPU on the plain routes,
    through ``coremltools`` with the JAX package's settings -- its
    ``add_fp16_cast`` and ``const_elimination`` passes removed (precision and
    run-failure workarounds), iOS 18, the input renamed ``samples`` and the
    outputs ``logits`` and ``probs``.  Needs ``coremltools``."""
    try:
        import coremltools as ct
    except ImportError as e:
        raise ImportError(
            f"CoreML export requires coremltools (missing: {e.name}); use export_program "
            "for the .pt2 program") from e

    program = export_program(model, _plain_routes(cfg), device="cpu")
    pass_pipeline = ct.PassPipeline()
    pass_pipeline.remove_passes(["common::add_fp16_cast"])
    pass_pipeline.remove_passes(["common::const_elimination"])
    coreml_model = ct.convert(
        program,
        source="pytorch",
        minimum_deployment_target=ct.target.iOS18,
        pass_pipeline=pass_pipeline,
    )
    spec = coreml_model.get_spec()
    for input_description, new_name in zip(coreml_model.input_description, ["samples"]):
        ct.utils.rename_feature(spec, input_description, new_name)
    for output_description, new_name in zip(coreml_model.output_description,
                                            ["logits", "probs"]):
        ct.utils.rename_feature(spec, output_description, new_name)
    coreml_model = ct.models.model.MLModel(spec, weights_dir=coreml_model.weights_dir)
    coreml_model.save(str(output_file))
    return coreml_model


def export_tflite(model: model_lib.Model, cfg: Config = DEFAULT_CONFIG,
                  output_file: str | Path = "audio2midi.tflite"):
    """TFLite export through ``ai_edge_torch``: ``predict`` on the CPU on the
    plain routes, on an f32 (2, samples_per_window) input as the JAX
    package's TF signature has it.  Needs ``ai_edge_torch``."""
    try:
        import ai_edge_torch
    except ImportError as e:
        raise ImportError("TFLite export requires ai_edge_torch") from e

    cfg = _plain_routes(cfg)
    model = _on_device(model, "cpu")
    rope = model_lib.make_rope(cfg.model)
    example = torch.zeros((2, cfg.data.samples_per_window), dtype=torch.float32)
    edge_model = ai_edge_torch.convert(_Program(model, cfg.model, rope).eval(), (example,))
    edge_model.export(str(output_file))
    return output_file


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Export the model.")
    parser.add_argument("--checkpoint", default="audio_to_midi_checkpoints",
                        help="Training checkpoint directory, or a checkpoint file (.npz or .pt)")
    parser.add_argument("--format", choices=["pt2", "coreml", "tflite"], default="pt2",
                        help="pt2: the torch.export program (the port's stand-in for JAX's "
                             "StableHLO)")
    parser.add_argument("--output", default=None)
    parser.add_argument("--config", default=None, help="Config JSON file")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="Device the pt2 program is traced on (default: cuda)")
    args = parser.parse_args(argv)

    from .cli.audio_to_midi import load_model
    from .config import load_config

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to export on the CPU")
    cfg = load_config(args.config)
    model = load_model(args.checkpoint, cfg, torch.device(args.device))
    if args.format == "pt2":
        export_program(model, cfg, output_file=args.output or "audio2midi.pt2",
                       device=args.device)
    elif args.format == "coreml":
        export_model_to_coreml(model, cfg, args.output or "Audio2Midi.mlpackage")
    else:
        export_tflite(model, cfg, args.output or "audio2midi.tflite")
    print("Export complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
