"""``export.py``: the port's ``predict`` as a ``torch.export`` program.

Exported on the CPU at the small geometry of ``tests/test_torch_primitives``
(one pair, P = 256, 2 heads x 16), saved, and loaded in a fresh process
that imports the port: the program's outputs equal eager ``predict``'s bit
for bit, and JAX ``predict``'s on the same weights and samples within the
stated tolerance, at f32 and at the JAX package's default f16.  The kernels'
custom operators pass ``torch.library.opcheck`` on the CPU (their plain
implementations and fake implementations).  The CoreML and TFLite glue runs
against mocked ``coremltools`` / ``ai_edge_torch``, asserting what
``tests/test_export_mocked.py`` asserts for the JAX package, and ``main``
writes a ``.pt2``."""

import json
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import convert, export
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from audio_to_midi_tpu_torch.ops import convnext_kernels as ck
from audio_to_midi_tpu_torch.ops import fused_layer_kernels as flk
from tests.test_torch_primitives import SMALL_CFG, SMALL_JAX_CFG, jax_params, port_model

torch.set_num_threads(2)

# Against JAX: f32 sums taken in another order (1e-5, as the model tests);
# f16: 2 ulps of the probabilities' top binade (2^-11 each), as
# tests/test_torch_f16.py holds the f16 model.
JAX_TOL = {torch.float32: 1e-5, torch.float16: 2 * 2.0 ** -11}
JAX_DTYPES = {torch.float32: jnp.float32, torch.float16: jnp.float16}


@pytest.fixture(scope="module")
def weights():
    flat = jax_params(11)
    return flat, port_model(flat)


@pytest.fixture(scope="module")
def programs(weights, tmp_path_factory):
    """The f32 program exported by ``export_program`` and the default (f16)
    one by ``main`` from a checkpoint file, both on the CPU and saved; the
    samples; and the outputs of the programs loaded in a fresh process."""
    flat, model = weights
    root = tmp_path_factory.mktemp("export")
    samples = np.random.default_rng(12).standard_normal(
        (2, SMALL_CFG.data.samples_per_window)).astype(np.float32) * 0.5
    np.save(root / "samples.npy", samples)
    out = {torch.float32: export.export_program(model, SMALL_CFG, example_dtype=torch.float32,
                                                output_file=root / "float32.pt2", device="cpu")}
    convert.save_npz(root / "params.npz", flat)
    (root / "config.json").write_text(pt_config.config_to_json(SMALL_CFG))
    assert export.main(["--checkpoint", str(root / "params.npz"), "--config",
                        str(root / "config.json"), "--device", "cpu",
                        "--output", str(root / "float16.pt2")]) == 0
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np, torch
        from audio_to_midi_tpu_torch import export
        samples = torch.from_numpy(np.load({str(root / "samples.npy")!r}))
        nodes = {{}}
        for name, dtype in (("float32", torch.float32), ("float16", torch.float16)):
            program = export.load_program({str(root)!r} + "/" + name + ".pt2")
            nodes[name] = export.kernel_nodes(program)
            logits, probs = export.run_program(program, samples.to(dtype))
            np.save({str(root)!r} + "/" + name + "_logits.npy", logits.float().numpy())
            np.save({str(root)!r} + "/" + name + "_probs.npy", probs.float().numpy())
        print(json.dumps(nodes))
        assert "jax" not in sys.modules
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    return root, samples, out, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_loaded_program_is_eager_predict_bit_for_bit_and_jax_within_tolerance(
        weights, programs, dtype):
    _, model = weights
    root, samples, _, nodes = programs
    name = str(dtype).split(".")[-1]
    # f32 reaches the kernels' operators (one local, one global layer); f16
    # reaches none, as no kernel takes f16.
    assert nodes[name] == ({"local_two_phase_fwd": 1, "global_attention_fwd": 1}
                           if dtype == torch.float32 else {})
    x = torch.from_numpy(samples).to(dtype)
    with torch.no_grad():
        eager = pt_model.predict(model, SMALL_CFG.model, x, pt_model.make_rope(SMALL_CFG.model))
    for i, part in enumerate(("logits", "probs")):
        got = np.load(root / f"{name}_{part}.npy")
        np.testing.assert_array_equal(got, eager[i].float().numpy(), err_msg=part)
    params, _ = jax_model.init(jax.random.PRNGKey(11), SMALL_JAX_CFG)  # jax_params(11)'s tree
    _, ref = jax_model.predict(params, SMALL_JAX_CFG, jnp.asarray(samples, JAX_DTYPES[dtype]),
                               jax_model.make_rope(SMALL_JAX_CFG))
    np.testing.assert_allclose(np.load(root / f"{name}_probs.npy"),
                               np.asarray(ref, np.float32), rtol=0, atol=JAX_TOL[dtype])


def test_program_keeps_the_model_out_of_its_submodules(weights, programs):
    """The unlifted program runs (no ``.global.`` attribute in its code) and
    lists the model's parameters as parameters."""
    _, model = weights
    program = programs[2][torch.float32]
    # main wrote the f16 program: JAX's default example dtype.
    f16 = export.load_program(programs[0] / "float16.pt2")
    assert next(iter(f16.state_dict.values())).dtype == torch.float32
    (node,) = [n for n in f16.graph.nodes if n.op == "placeholder" and n.name == "samples"]
    assert node.meta["val"].dtype == torch.float16
    specs = program.graph_signature.input_specs
    params = [s for s in specs if s.kind.name == "PARAMETER"]
    assert len(params) == len(list(model.parameters()))
    assert ".global." not in program.module().code


def _global_args():
    q, k, v = (torch.randn(2, 32, 2 * 16) for _ in range(3))
    return (q, k, v, None, None, 2, 0, 30, 0)


def _local_args(rw: bool):
    ts = [torch.randn(2, 32, 2 * 16) for _ in range(5)]
    return (*ts, None, None, None, 2, 16, 0, rw)


def _sublayer_args(window: int):
    d, h, hd, ckv = 32, 2, 16, 8
    xp = torch.randn(1, 32, d)
    weights = [torch.randn(2, d), torch.randn(d, h * hd), torch.randn(d, ckv),
               torch.randn(ckv, h * hd), torch.randn(ckv, h * hd), torch.randn(h * hd, d)]
    tables = [torch.randn(32, hd // 2) for _ in range(4 if window else 2)]
    return (xp, weights, tables, h, 28, 2, window)


def _pair_args():
    xp, local, tables, *_ = _sublayer_args(16)
    d, inter = xp.shape[-1], 24
    ffn = [torch.randn(2, d), torch.randn(d, 2 * inter), torch.randn(1, 2 * inter),
           torch.randn(inter, d), torch.randn(1, d)]
    weights = local + ffn + [t.clone() for t in local] + [t.clone() for t in ffn]
    return (xp, weights, tables + [torch.randn(32, 8) for _ in range(2)], 2, 28, 2, 16)


def _block_args(window: int):
    d, h, hd, ckv = 32, 2, 16, 8
    ws = [torch.randn(d, h * hd), torch.randn(d, ckv), torch.randn(ckv, h * hd),
          torch.randn(ckv, h * hd), torch.randn(h * hd, d)]
    rows = 48 if window else 32
    return (torch.randn(1, 32, d), *ws, torch.randn(rows, hd // 2), torch.randn(rows, hd // 2),
            h, 30, window)


def _stage_args():
    depth, c, hidden = 2, 16, 32
    shapes = ((depth, 7, c), (depth, 1, c), (depth, 2, c), (depth, c, hidden), (depth, 1, hidden),
              (depth, hidden, c), (depth, 1, c), (depth, 1, c))
    return (torch.randn(2, 24, c), [torch.randn(*s) * 0.2 for s in shapes])


OPS = {
    "global": (torch.ops.a2m.global_attention_fwd.default, _global_args),
    "local": (torch.ops.a2m.local_two_phase_fwd.default, lambda: _local_args(False)),
    "local rw": (torch.ops.a2m.local_two_phase_fwd.default, lambda: _local_args(True)),
    "block local": (torch.ops.a2m.attention_block_fwd.default, lambda: _block_args(16)),
    "block global": (torch.ops.a2m.attention_block_fwd.default, lambda: _block_args(0)),
    "sublayer local": (torch.ops.a2m.fused_sublayer_fwd.default, lambda: _sublayer_args(16)),
    "sublayer global": (torch.ops.a2m.fused_sublayer_fwd.default, lambda: _sublayer_args(0)),
    "pair": (torch.ops.a2m.transformer_pair_fwd.default, _pair_args),
    "stage": (torch.ops.a2m.convnext_stage_fwd.default, _stage_args),
}


@pytest.mark.parametrize("case", list(OPS))
def test_kernel_operators_pass_opcheck_on_the_cpu(case):
    """Schema, fake implementation (shape, dtype, strides) against the CPU
    implementation, and the operator under AOT dispatch.  The CPU
    implementation is the kernel's plain version, and counts nothing."""
    op, make = OPS[case]
    torch.manual_seed(0)
    args = make()
    before = [fn.launches for fn in ak.KERNELS + flk.KERNELS + ck.KERNELS]
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor",
                                                "test_aot_dispatch_dynamic"))
    assert [fn.launches for fn in ak.KERNELS + flk.KERNELS + ck.KERNELS] == before


def _fake_coremltools(calls):
    class FakePipeline:
        def __init__(self):
            self.removed = []
            calls["pipeline"] = self

        def remove_passes(self, names):
            self.removed.extend(names)

    class FakeModel:
        weights_dir = "/tmp/w"
        input_description = ["input_0"]
        output_description = ["out_0", "out_1"]

        def get_spec(self):
            return object()

        def save(self, path):
            calls["saved"] = path

    model = FakeModel()

    def convert_(program, source=None, minimum_deployment_target=None, pass_pipeline=None):
        calls.update(program=program, source=source, target=minimum_deployment_target,
                     pipeline_given=pass_pipeline)
        return model

    ct = types.ModuleType("coremltools")
    ct.PassPipeline = FakePipeline
    ct.target = types.SimpleNamespace(iOS18="iOS18")
    ct.convert = convert_
    ct.utils = types.SimpleNamespace(
        rename_feature=lambda spec, old, new: calls.setdefault("renames", []).append((old, new)))
    ct.models = types.SimpleNamespace(
        model=types.SimpleNamespace(MLModel=lambda spec, weights_dir=None: model))
    return ct


def test_coreml_conversion_glue(weights, tmp_path, monkeypatch):
    _, model = weights
    calls = {}
    monkeypatch.setitem(sys.modules, "coremltools", _fake_coremltools(calls))
    out = tmp_path / "Audio2Midi.mlpackage"
    export.export_model_to_coreml(model, SMALL_CFG, out)
    # JAX export.py:75-76: both passes removed, from the pipeline handed over.
    assert calls["pipeline"].removed == ["common::add_fp16_cast", "common::const_elimination"]
    assert calls["pipeline_given"] is calls["pipeline"]
    assert calls["target"] == "iOS18" and calls["source"] == "pytorch"
    # The program traced on the CPU on the plain routes: no kernel operator.
    assert isinstance(calls["program"], torch.export.ExportedProgram)
    assert export.kernel_nodes(calls["program"]) == {}
    assert ("input_0", "samples") in calls["renames"]
    assert ("out_0", "logits") in calls["renames"]
    assert ("out_1", "probs") in calls["renames"]
    assert calls["saved"] == str(out)


def test_tflite_conversion_glue(weights, tmp_path, monkeypatch):
    _, model = weights
    calls = {}

    class Edge:
        def export(self, path):
            calls["saved"] = path

    def convert_(module, args):
        calls["module"], calls["args"] = module, args
        return Edge()

    monkeypatch.setitem(sys.modules, "ai_edge_torch", types.SimpleNamespace(convert=convert_))
    out = tmp_path / "m.tflite"
    assert export.export_tflite(model, SMALL_CFG, out) == out
    (example,) = calls["args"]
    assert example.dtype == torch.float32 and tuple(example.shape) == (
        2, SMALL_CFG.data.samples_per_window)
    logits, probs = calls["module"](example)
    assert tuple(probs.shape) == (250, 90) and calls["saved"] == str(out)


def test_converters_name_their_missing_packages(weights, monkeypatch):
    _, model = weights
    monkeypatch.setitem(sys.modules, "coremltools", None)
    monkeypatch.setitem(sys.modules, "ai_edge_torch", None)
    with pytest.raises(ImportError, match="CoreML export requires coremltools"):
        export.export_model_to_coreml(model, SMALL_CFG)
    with pytest.raises(ImportError, match="TFLite export requires ai_edge_torch"):
        export.export_tflite(model, SMALL_CFG)
