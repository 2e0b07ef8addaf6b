"""``attention_impl="pallas_rw"`` in the port vs the JAX package: kernel 6
(``ak.local_two_phase_rw``, the reduced-width two-phase local attention)
against ``fused_local_two_phase_rw`` and the wide jnp mirror, its gradients,
the layer, the model and the parameter gradients, and the routing.

On the CPU the wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_pallas_rw.py does, at its
geometries ((B, P) in {(2, 64), (1, 256)}, 2 heads x 8; gradients at P 32).
Inputs come from numpy with a seed.  Tolerances: f32 rtol 1e-4 / atol 1e-5
(tests/test_torch_primitives.close); the model as tests/test_torch_model.py,
the parameter gradients as tests/test_torch_train.py; bf16 2 ulps of the
output's top binade (a rounding flipped by an fp32 sum in another order
moves an output by one).  tests/test_torch_kernels.py holds the CUDA kernel
against the plain version on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.models import attention as jax_attention
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.ops import pallas_attention as pa
from audio_to_midi_tpu.train import loss as jax_loss
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import attention as pt_attention
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.models import nn as pt_nn
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from audio_to_midi_tpu_torch.train import loss as pt_loss
from tests.test_torch_attention import _attention_pair
from tests.test_torch_attention_variants import DTYPES, arrays, ulps
from tests.test_torch_primitives import SMALL_CFG, SMALL_JAX_CFG, close, port_model
from tests.test_torch_train import (
    JAX_MODEL_CFG, assert_trees_close, batch, flat_grads, jax_cfg, port_config,
)

torch.set_num_threads(2)

RW_JAX = dataclasses.replace(SMALL_JAX_CFG, attention_impl="pallas_rw")
RW = dataclasses.replace(SMALL_CFG.model, attention_impl="pallas_rw")


def assert_matches(out, ref, name: str):
    if name == "f32":
        close(out, ref)
    else:
        assert out.dtype == torch.bfloat16 and ulps(out, ref) <= 2


# --- kernel 6 ---------------------------------------------------------------


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("b,p", [(2, 64), (1, 256)])
def test_local_two_phase_rw_matches_pallas_and_the_wide_reference(b, p, name):
    dt, jdt = DTYPES[name]
    ts = arrays(b * p, 5, b, p, 2 * 8)
    jargs = [jnp.asarray(x, jdt) for x in ts]
    out = ak.local_two_phase_rw(*(torch.from_numpy(x).to(dt) for x in ts), 2, 16)
    assert out.shape == (b, p, 16)
    assert_matches(out, pa.fused_local_two_phase_rw(*jargs, 2, 16), name)
    assert_matches(out, pa._two_phase_reference(*jargs, num_heads=2, window=16), name)


def test_local_two_phase_rw_gradients_match_jax():
    """The five input gradients of sum(out ** 2): kernel 7 on both sides."""
    ts = arrays(32, 5, 1, 32, 2 * 8)
    loss = lambda *a: jnp.sum(pa.fused_local_two_phase_rw(*a, 2, 16) ** 2)
    ref = jax.grad(loss, argnums=tuple(range(5)))(*(jnp.asarray(x) for x in ts))
    leaves = [torch.from_numpy(x).requires_grad_() for x in ts]
    out = ak.local_two_phase_rw(*leaves, 2, 16)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.square().sum(), leaves)
    for g, r in zip(grads, ref):
        close(g, r)


def test_the_plain_version_zeroes_the_wrapped_window():
    """Phase B's last rolled window wraps rows [P - 8, P) and [0, 8); its
    output lands on the edge rows, which keep phase A alone."""
    qa, ka, qb, kb, v = (torch.from_numpy(x) for x in arrays(7, 5, 1, 32, 16))
    out = ak.local_two_phase_rw_plain(qa, ka, qb, kb, v, 1, 16)
    alone = ak.local_two_phase_rw_plain(qa, ka, torch.zeros_like(qb), kb, v, 1, 16)
    edges = [*range(8), *range(24, 32)]
    torch.testing.assert_close(out[:, edges], alone[:, edges], rtol=0, atol=0)
    assert not torch.equal(out[:, 8:24], alone[:, 8:24])


# --- the layer, the model, the parameter gradients ---------------------------


# 46 -> padded 48 (three windows, odd), 250 -> 256: the two-phase route.
@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("seq_len", [46, 250])
def test_local_layer_matches_jax(seq_len, name):
    dt, jdt = DTYPES[name]
    p, module = _attention_pair(1)
    (x,) = arrays(seq_len, 1, 2, seq_len, 32)
    ref = jax_attention.local_self_attention(jnp.asarray(x, jdt), p,
                                             jax_model.make_rope(RW_JAX), RW_JAX)
    with torch.no_grad():
        out = pt_attention.local_self_attention(torch.from_numpy(x).to(dt), module,
                                                pt_model.make_rope(RW), RW)
    assert_matches(out, ref, name)


def test_model_forward_matches_jax():
    tree = jax_model.init(jax.random.PRNGKey(0), SMALL_JAX_CFG)[0]
    model = port_model(convert.flatten_tree(jax.device_get(tree)))
    (audio,) = arrays(1, 1, 2, 2, 80_000)
    audio *= 0.5
    forward = jax.jit(lambda p, a: jax_model.forward(p, RW_JAX, a, jax_model.make_rope(RW_JAX)))
    ref_logits, ref_probs = forward(tree, jnp.asarray(audio))
    with torch.no_grad():
        logits, probs = pt_model.forward(model, RW, torch.from_numpy(audio),
                                         pt_model.make_rope(RW))
    assert probs.shape == (2, 250, 90)
    close(probs, ref_probs, rtol=0, atol=1e-4)
    close(logits, ref_logits, rtol=1e-3, atol=1e-4)


def test_parameter_gradients_of_a_dropout_free_minibatch_match_jax():
    """8 000 samples -> 25 frames -> padded 32: kernel 6 forward, kernel 7
    backward on both sides, kernel 1 and its backward for the global layer."""
    jcfg = dataclasses.replace(JAX_MODEL_CFG, attention_impl="pallas_rw")
    cfg = port_config(dataclasses.replace(jax_cfg(), model=jcfg))
    tree = jax_model.init(jax.random.PRNGKey(0), jcfg)[0]
    audio, labels = batch(8_000, (2,), 8_000)
    loss_fn = lambda p, a, lab: jax_loss.batch_loss(p, jcfg, a, lab, jax_model.make_rope(jcfg),
                                                    jnp.float32(1.0), jax.random.PRNGKey(1),
                                                    jnp.float32)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(tree, jnp.asarray(audio),
                                                              jnp.asarray(labels))
    model = port_model(convert.flatten_tree(jax.device_get(tree)), cfg)
    loss = pt_loss.batch_loss(model, cfg.model, torch.from_numpy(audio),
                              torch.from_numpy(labels), pt_model.make_rope(cfg.model), 1.0,
                              torch.float32)
    loss.backward()
    close(loss, ref_loss, rtol=1e-5, atol=0)
    assert_trees_close(flat_grads(model), ref_grads, rtol=5e-3, atol_of_scale=5e-4)


# --- routing -----------------------------------------------------------------


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls of every attention-core wrapper and of the
    exact-rate ``nn.dropout``."""
    names = ("local_two_phase_rw", "local_two_phase", "global_attention",
             "global_attention_dropout", "local_two_phase_dropout")
    calls = dict.fromkeys((*names, "exact"), 0)

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[key] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    for name in names:
        spy(ak, name, name)
    spy(pt_nn, "dropout", "exact")
    return calls


def _run(fn, seq_len, cfg, dropout=False):
    _, module = _attention_pair(4)
    (x,) = arrays(seq_len, 1, 1, seq_len, 32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = fn(torch.from_numpy(x), module, pt_model.make_rope(cfg), cfg, generator=gen,
                 enable_dropout=dropout)
    assert torch.isfinite(out).all()
    return out


def test_the_dropout_free_two_phase_route_takes_kernel_6(routes):
    _run(pt_attention.local_self_attention, 250, RW)
    assert routes == dict.fromkeys(routes, 0) | dict(local_two_phase_rw=1)


def test_the_global_and_flattened_routes_take_kernel_1(routes):
    _run(pt_attention.self_attention, 250, RW)
    _run(pt_attention.local_self_attention, 50, RW)  # padded 56: 56 % 16 == 8
    assert routes == dict.fromkeys(routes, 0) | dict(global_attention=2)


def test_under_dropout_the_seeded_kernels_and_not_kernel_6(routes):
    _run(pt_attention.self_attention, 250, RW, dropout=True)
    _run(pt_attention.local_self_attention, 250, RW, dropout=True)
    assert routes == dict.fromkeys(routes, 0) | dict(global_attention_dropout=1,
                                                     local_two_phase_dropout=1)
