"""The port's attention kernels and attention modules vs the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as
tests/test_pallas_attention.py does.  Tolerance (f32): rtol 1e-4 / atol
1e-5 -- fp32 softmax and sums in another order, O(1) values.
tests/test_torch_kernels.py holds the CUDA kernels against these plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.models import attention as jax_attention
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.ops import pallas_attention as pa
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import attention as pt_attention
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_primitives import SMALL_CFG, SMALL_JAX_CFG, close, rand

torch.set_num_threads(2)


def qkv(seed: int, *shape, n: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rand(rng, *shape) for _ in range(n)]


# --- kernel 1: global attention -------------------------------------------


@pytest.mark.parametrize("s,block", [(250, 0), (37, 0), (496, 16)])
def test_global_attention_plain_matches_pallas(s, block):
    q, k, v = qkv(s + block, 2, s, 2 * 16)
    ref = pa.fused_attention_nhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, block)
    out = ak.global_attention(*map(torch.from_numpy, (q, k, v)), 2, block)
    close(out, ref)


@pytest.mark.parametrize("s", [37, 250])
def test_global_attention_valid_len_masks_the_padding(s):
    """valid_len < S: the TPU kernel pads S to a multiple of 128 and masks
    the padded columns; the port takes the padded tensors and valid_len."""
    q, k, v = qkv(s, 2, s, 2 * 16)
    ref = pa.fused_attention_nhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, 0)
    s_pad = -(-s // 128) * 128
    pad = lambda x: torch.from_numpy(np.pad(x, ((0, 0), (0, s_pad - s), (0, 0))))
    out = ak.global_attention(pad(q), pad(k), pad(v), 2, 0, valid_len=s)
    close(out[:, :s], ref)


# --- kernel 2: two-phase local attention ----------------------------------


def test_local_two_phase_plain_matches_pallas_and_reference():
    qa, ka, qb, kb, v = qkv(11, 2, 256, 2 * 16, n=5)
    jargs = [jnp.asarray(x) for x in (qa, ka, qb, kb, v)]
    out = ak.local_two_phase(*map(torch.from_numpy, (qa, ka, qb, kb, v)), 2, 16)
    close(out, pa.fused_local_two_phase(*jargs, 2, 16))
    close(out, pa._two_phase_reference(*jargs, num_heads=2, window=16))


# --- modules --------------------------------------------------------------


def _attention_pair(seed: int):
    p = jax_attention.init_self_attention(jax.random.PRNGKey(seed), SMALL_JAX_CFG)
    flat = convert.flatten_tree(jax.device_get(p))
    module = pt_attention.SelfAttention(SMALL_CFG.model)
    module.load_state_dict({k.replace("/", "."): torch.tensor(v) for k, v in flat.items()})
    return p, module


@pytest.mark.parametrize("seq_len", [250, 37])
def test_self_attention_matches_jax(seq_len):
    p, module = _attention_pair(0)
    x = rand(np.random.default_rng(seq_len), 2, seq_len, 32)
    ref = jax_attention.self_attention(jnp.asarray(x), p, jax_model.make_rope(SMALL_JAX_CFG),
                                       SMALL_JAX_CFG)
    with torch.no_grad():
        out = pt_attention.self_attention(torch.from_numpy(x), module,
                                          pt_model.make_rope(SMALL_CFG.model), SMALL_CFG.model)
    close(out, ref)


# 250 -> padded 256 (two-phase route); 50 -> padded 56, 56 % 16 != 0
# (flattened-window route through kernel 1 with block=16); 17 -> 24.
@pytest.mark.parametrize("seq_len", [250, 50, 17])
def test_local_self_attention_matches_jax(seq_len):
    p, module = _attention_pair(1)
    x = rand(np.random.default_rng(seq_len), 2, seq_len, 32)
    ref = jax_attention.local_self_attention(
        jnp.asarray(x), p, jax_model.make_rope(SMALL_JAX_CFG), SMALL_JAX_CFG)
    with torch.no_grad():
        out = pt_attention.local_self_attention(
            torch.from_numpy(x), module, pt_model.make_rope(SMALL_CFG.model), SMALL_CFG.model)
    close(out, ref)


def test_local_attention_routes_like_jax():
    assert pt_attention._local_padding(250, 16) == jax_attention._local_padding(250, 16) == (3, 3)
    assert pt_attention._local_padding(50, 16) == (3, 3)  # padded 56: flattened route


@pytest.mark.parametrize("seq_len", [4, 8])
def test_local_attention_rejects_too_short_sequences(seq_len):
    _, module = _attention_pair(2)
    x = torch.zeros(1, seq_len, 32)
    with pytest.raises(ValueError, match="seq_len > window//2"):
        pt_attention.local_self_attention(x, module, pt_model.make_rope(SMALL_CFG.model),
                                          SMALL_CFG.model)


def test_unported_attention_impl_raises():
    import dataclasses

    _, module = _attention_pair(3)
    cfg = dataclasses.replace(SMALL_CFG.model, attention_impl="pallas_pair")
    with pytest.raises(NotImplementedError):
        pt_attention.self_attention(torch.zeros(1, 20, 32), module,
                                    pt_model.make_rope(cfg), cfg)
