"""f16 in the port's attention vs the JAX package (Fault 3), and the bf16
rounding of the local layer.

The JAX package gates every attention-kernel route with ``mosaic_dtype_ok``:
under f16 (the ``--precision f16`` loss-scaling policy) its attention takes
the einsum route -- logits in the dtype, fp32 softmax cast back, exact-rate
dropout -- and its local layers the windowed (B, W, 16, 16) route, for every
``attention_impl``.  The port must do the same: no kernel wrapper is called
in f16, and the layers and the model agree with JAX's f16.

Inputs from numpy with a seed, weights from the JAX init through the
converter, the JAX kernels in interpret mode.  Tolerance in f16 and bf16: 2
ulps of the output's top binade (f16: 10 mantissa bits, bf16: 7): both sides
round the same operations in the same dtype, and an fp32 sum taken in
another order flips a rounding by one ulp.  The model in f16: 2 f16 ulps of
the probabilities' top binade.
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.models import attention as jax_attention
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import attention as pt_attention
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.models import nn as pt_nn
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from audio_to_midi_tpu_torch.ops import convnext_kernels as ck
from audio_to_midi_tpu_torch.ops import fused_layer_kernels as flk
from audio_to_midi_tpu_torch.train import loss as pt_loss
from tests.test_torch_attention import _attention_pair
from tests.test_torch_primitives import SMALL_CFG, SMALL_JAX_CFG, port_model, to_np

torch.set_num_threads(2)

MANTISSA = {torch.float16: 10, torch.bfloat16: 7}  # explicit mantissa bits
JAX_DTYPE = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}
LAYERS = {"global": (pt_attention.self_attention, jax_attention.self_attention),
          "local": (pt_attention.local_self_attention, jax_attention.local_self_attention)}


def ulps(out, ref, dtype: torch.dtype) -> float:
    """Max abs difference in ulps of ``dtype`` at the binade of ref's largest
    magnitude."""
    a, b = to_np(out), to_np(ref)
    top = 2.0 ** math.floor(math.log2(max(float(np.abs(b).max()), 2.0 ** -100)))
    return float(np.abs(a - b).max()) / (top * 2.0 ** -MANTISSA[dtype])


def layer_pair(layer: str, impl: str, seq_len: int, dtype: torch.dtype, seed: int = 1):
    """(the port's layer output, JAX's) on one seeded input in ``dtype``."""
    p, module = _attention_pair(seed)
    x = np.random.default_rng(seq_len).standard_normal((2, seq_len, 32)).astype(np.float32)
    jcfg = dataclasses.replace(SMALL_JAX_CFG, attention_impl=impl)
    cfg = dataclasses.replace(SMALL_CFG.model, attention_impl=impl)
    pt_fn, jax_fn = LAYERS[layer]
    ref = jax_fn(jnp.asarray(x, JAX_DTYPE[dtype]), p, jax_model.make_rope(jcfg), jcfg)
    with torch.no_grad():
        out = pt_fn(torch.from_numpy(x).to(dtype), module, pt_model.make_rope(cfg), cfg)
    return out, ref


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of every kernel wrapper of the port."""
    calls = {}
    for module in (ak, ck, flk):
        for fn in module.KERNELS:
            real = getattr(module, fn.__name__)
            calls[fn.__name__] = 0

            def wrapped(*args, _real=real, _name=fn.__name__, **kwargs):
                calls[_name] += 1
                return _real(*args, **kwargs)
            monkeypatch.setattr(module, fn.__name__, wrapped)
    return calls


# --- Fault 3: f16 takes the einsum routes -------------------------------------


# global S = 250; local 250 -> padded 256 and 46 -> 48 (the two-phase route
# in f32 and bf16), 50 -> 56 (the flattened route in f32 and bf16).
@pytest.mark.parametrize("impl", ["pallas", "pallas_rw", "xla"])
@pytest.mark.parametrize("layer,seq_len", [("global", 250), ("local", 250), ("local", 46),
                                           ("local", 50)])
def test_f16_layers_match_jax_and_call_no_kernel(kernel_calls, impl, layer, seq_len):
    out, ref = layer_pair(layer, impl, seq_len, torch.float16)
    assert out.dtype == torch.float16 and torch.isfinite(out).all()
    assert ulps(out, ref, torch.float16) <= 2
    assert kernel_calls == dict.fromkeys(kernel_calls, 0)


def test_f16_dropout_drops_at_the_exact_rate(monkeypatch, kernel_calls):
    """Under f16 "pallas" drops every attention weight with nn.dropout at
    keep 0.9 and scales the kept ones by 1/0.9, as the JAX einsum route:
    never the kernels' 230/256.  ~8 M weights put the two shares ~15 sigma
    apart."""
    seen = []
    real = pt_nn.dropout

    def spy(x, *args, **kwargs):
        out = real(x, *args, **kwargs)
        seen.append((x, out))
        return out
    monkeypatch.setattr(pt_nn, "dropout", spy)
    _, module = _attention_pair(4)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((64, 250, 32))
                         .astype(np.float32)).half()
    with torch.no_grad():
        pt_attention.self_attention(x, module, pt_model.make_rope(SMALL_CFG.model),
                                    SMALL_CFG.model, generator=torch.Generator().manual_seed(5),
                                    enable_dropout=True)
    (weights, dropped), = seen
    assert weights.dtype == torch.float16 and weights.numel() >= 8_000_000
    kept = dropped != 0
    share = kept.double().mean().item()
    assert abs(share - 0.9) <= 5 * math.sqrt(0.9 * 0.1 / weights.numel())
    assert torch.equal(dropped[kept], weights[kept] / 0.9)
    assert kernel_calls == dict.fromkeys(kernel_calls, 0)


@pytest.fixture(scope="module")
def small_model():
    tree = jax_model.init(jax.random.PRNGKey(0), SMALL_JAX_CFG)[0]
    return tree, port_model(convert.flatten_tree(jax.device_get(tree)))


def test_f16_dropout_step_calls_no_kernel(small_model, kernel_calls):
    """A training minibatch in f16 with dropout 0.1, forward and backward:
    every attention drops at the exact rate, and no kernel wrapper runs."""
    _, model = small_model
    rng = np.random.default_rng(2)
    audio = torch.from_numpy(rng.standard_normal((1, 2, 80_000)).astype(np.float32) * 0.5)
    labels = torch.from_numpy((rng.random((1, 250, 90)) < 0.05).astype(np.float32))
    cfg = SMALL_CFG.model
    assert cfg.transformer_dropout_rate == 0.1
    for p in model.parameters():
        p.grad = None
    loss = pt_loss.batch_loss(model.train(), cfg, audio, labels, pt_model.make_rope(cfg), 1.0,
                              torch.float16, generator=torch.Generator().manual_seed(3))
    loss.backward()
    model.eval()
    assert torch.isfinite(loss)
    assert all(p.grad is not None for p in model.parameters())
    for p in model.parameters():
        p.grad = None
    assert kernel_calls == dict.fromkeys(kernel_calls, 0)


@pytest.mark.parametrize("impl", ["pallas", "pallas_rw"])
def test_f16_model_matches_jax(small_model, impl):
    tree, model = small_model
    jcfg = dataclasses.replace(SMALL_JAX_CFG, attention_impl=impl)
    cfg = dataclasses.replace(SMALL_CFG.model, attention_impl=impl)
    audio = np.random.default_rng(1).standard_normal((2, 2, 80_000)).astype(np.float32) * 0.5
    forward = jax.jit(lambda p, a: jax_model.forward(
        jax_model.cast_params(p, jnp.float16), jcfg, a, jax_model.make_rope(jcfg)))
    _, ref = forward(tree, jnp.asarray(audio, jnp.float16))
    with torch.no_grad():
        f16 = pt_model.cast_params(copy.deepcopy(model), torch.float16)
        _, probs = pt_model.forward(f16, cfg, torch.from_numpy(audio).half(),
                                    pt_model.make_rope(cfg))
    assert probs.dtype == torch.float16 and probs.shape == (2, 250, 90)
    assert ulps(probs, ref, torch.float16) <= 2


# --- the bf16 rounding of the local layer (ROADMAP §3, measured) ---------------


# The port's "xla" local layer takes the two-phase formulation (padded % 16
# == 0) and averages in fp32, the JAX "xla" layer the windowed one in the
# dtype; "pallas" takes the two-phase kernels on both sides.
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seq_len", [46, 250])
def test_bf16_local_layer_is_within_two_ulps_of_jax(impl, seq_len):
    out, ref = layer_pair("local", impl, seq_len, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert ulps(out, ref, torch.bfloat16) <= 2
