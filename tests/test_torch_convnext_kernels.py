"""The port's ConvNeXt stage kernels (plain versions, on the CPU) vs the JAX
package's Pallas kernels 20 and 19 in interpret mode.  The routing of
``cnn_forward`` through them, and a training step, are in
tests/test_torch_convnext_routing.py.

Inputs and weights are made with numpy from a seed and given to both sides;
bf16 values are the fp32 ones rounded by each framework (round to nearest
even in both).  Gamma is drawn O(1), not the 1e-6 of init, so the branch and
its gradients count.

Tolerances.  Kernel 20: its plain version rounds where the Pallas kernel
rounds, so bf16 results differ only where an fp32 sum taken in another order
flips a rounding: every output within 2 bf16 ulps of its leaf's top binade
(the readings are 0 to 1), against the 3 % of the JAX package's own test,
which compares with autograd of the blocks.  f32: 1e-5 of the leaf's largest
magnitude.  Kernel 19, f32: rtol 2e-5 / atol 2e-6, the JAX package's own for
this kernel; bf16: 1 ulp of the output's top binade.  Against ``jax.grad``
of a whole stage the same limits apply, as both sides run the same two
kernels on the same rows.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.ops import pallas_convnext as jax_stage_fwd
from audio_to_midi_tpu.ops import pallas_convnext_bwd as jax_stage_bwd
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import convnext as pt_convnext
from audio_to_midi_tpu_torch.ops import convnext_kernels as ck
from tests.test_torch_primitives import rand

torch.set_num_threads(2)

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
BF16_ULPS = 2
F32_SHARE = 1e-5


def stage_blocks(seed: int, depth: int, c: int, hidden: int) -> dict:
    """A stage's stacked ``blocks`` subtree as fp32 numpy, at the init's
    scales but with gamma in (0.5, 1.5) and a LayerNorm off the identity."""
    rng = np.random.default_rng(seed)
    uni = lambda scale, *shape: rng.uniform(-scale, scale, shape).astype(np.float32)
    return {
        "depth_conv": {"w": uni(7 ** -0.5, depth, 7, 1, c), "b": uni(7 ** -0.5, depth, c)},
        "norm": {"scale": 1 + 0.1 * rand(rng, depth, c), "bias": 0.1 * rand(rng, depth, c)},
        "pw1": {"w": uni(c ** -0.5, depth, c, hidden), "b": uni(c ** -0.5, depth, hidden)},
        "pw2": {"w": uni(hidden ** -0.5, depth, hidden, c), "b": uni(hidden ** -0.5, depth, c)},
        "gamma": rng.uniform(0.5, 1.5, (depth, c)).astype(np.float32),
    }


def to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dtype)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_leaf_close(mine, ref, name: str, what: str = "") -> float:
    """Within BF16_ULPS ulps of the leaf's top binade (bf16) or F32_SHARE of
    its largest magnitude (f32); returns the reading in those units."""
    mine, ref = as_np(mine), as_np(ref)
    assert mine.shape == ref.shape, (what, mine.shape, ref.shape)
    top = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(mine - ref).max())
    if name == "bf16":
        unit, limit = 2.0 ** (math.ceil(math.log2(top)) - 8), BF16_ULPS
    else:
        unit, limit = top, F32_SHARE
    assert np.isfinite(mine).all() and err <= limit * unit, (what, name, err / unit, limit)
    return err / unit


def flat_param_grads(blocks: torch.nn.ModuleList) -> dict[str, np.ndarray]:
    """The blocks' parameter gradients stacked like the JAX subtree."""
    names = [n for n, _ in blocks[0].named_parameters()]
    return {n.replace(".", "/"): np.stack([dict(b.named_parameters())[n].grad.float().numpy()
                                           for b in blocks]) for n in names}


# --- kernel 20: the plain version against the Pallas kernel -----------------


@pytest.mark.parametrize("name", ["bf16", "f32"])
@pytest.mark.parametrize("depth,b,l,c,hidden", [
    (3, 2, 40, 128, 256),    # the JAX package's own test geometry
    (2, 4, 40, 128, 256),    # the TPU side packs 4 samples into a grid cell
    (2, 4, 37, 128, 256),    # a length that no tile of either side divides
    (1, 2, 24, 256, 512),    # the widths of the last stage
])
def test_stage_bwd_plain_matches_the_pallas_kernel(name, depth, b, l, c, hidden):
    tdt, jdt = DTYPES[name]
    blocks = stage_blocks(0, depth, c, hidden)
    rng = np.random.default_rng(1)
    carries, dy = rand(rng, depth, b, l, c), rand(rng, b, l, c)
    ref_dx, ref_dblocks = jax_stage_bwd._stage_bwd_pallas(
        jnp.asarray(carries).astype(jdt), to_jax(blocks, jdt), jnp.asarray(dy).astype(jdt))
    weights = tuple(w.detach() for w in
                    ck.stage_weights(convert.stage_blocks_from_jax(blocks), tdt))
    dx, grads = ck.stage_bwd(to_torch(carries, tdt), weights, to_torch(dy, tdt))
    assert dx.dtype == tdt and all(g.dtype == torch.float32 for g in grads)
    assert [tuple(g.shape) for g in grads] == [tuple(w.shape) for w in weights]
    assert_leaf_close(dx, ref_dx, name, "dx")
    mine = convert.stage_grads_to_jax([g.to(tdt) for g in grads])  # the JAX side casts too
    ref = convert.flatten_tree(jax.tree.map(as_np, ref_dblocks))
    assert mine.keys() == ref.keys()
    for path in ref:
        assert_leaf_close(mine[path], ref[path], name, path)


def test_stage_weights_are_the_jax_kernel_operands():
    blocks = stage_blocks(2, 2, 128, 256)
    ref = jax_stage_bwd._kernel_weights(to_jax(blocks, jnp.bfloat16), jnp.bfloat16)
    mine = ck.stage_weights(convert.stage_blocks_from_jax(blocks), torch.bfloat16)
    assert len(mine) == len(ref) == len(ck.WEIGHT_NAMES)
    for n, a, r in zip(ck.WEIGHT_NAMES, mine, ref):
        assert a.dtype == (torch.float32 if n == "ln" else torch.bfloat16), n
        np.testing.assert_array_equal(as_np(a), as_np(r), err_msg=n)
        assert a.requires_grad


# --- kernel 20 under autograd ------------------------------------------------


def jax_stage_loss(fn, cot):
    return lambda x, b: jnp.sum(fn(x, b).astype(jnp.float32) * cot.astype(jnp.float32))


@pytest.mark.parametrize("name", ["bf16", "f32"])
def test_stage_blocks_fused_bwd_matches_jax(name):
    tdt, jdt = DTYPES[name]
    depth, b, l, c, hidden = 3, 2, 40, 128, 256
    blocks = stage_blocks(3, depth, c, hidden)
    rng = np.random.default_rng(4)
    x, cot = rand(rng, b, l, c), rand(rng, b, l, c)
    jx, jcot, jblocks = (jnp.asarray(x).astype(jdt), jnp.asarray(cot).astype(jdt),
                         to_jax(blocks, jdt))
    ref_out = jax_stage_bwd.stage_blocks_fused_bwd(jx, jblocks)
    ref_gx, ref_gb = jax.grad(jax_stage_loss(jax_stage_bwd.stage_blocks_fused_bwd, jcot),
                              argnums=(0, 1))(jx, jblocks)

    modules = convert.stage_blocks_from_jax(blocks)
    tx = to_torch(x, tdt).requires_grad_()
    out = ck.stage_blocks_fused_bwd(tx, ck.stage_weights(modules, tdt))
    loop = tx
    for blk in modules:
        loop = pt_convnext.block(loop, blk)
    assert torch.equal(out, loop)                       # forward: the plain block loop
    assert out.grad_fn is not None and "StageBlocksFusedBwd" in type(out.grad_fn).__name__
    # The forwards agree to the rounding of their matmuls' fp32 sums.
    assert_leaf_close(out, ref_out, name, "forward")
    out.backward(to_torch(cot, tdt))
    assert tx.grad.dtype == tdt
    assert_leaf_close(tx.grad, ref_gx, name, "dx")
    mine = flat_param_grads(modules)
    ref = convert.flatten_tree(jax.tree.map(as_np, ref_gb))
    assert mine.keys() == ref.keys()
    for path in ref:
        assert_leaf_close(mine[path], ref[path], name, path)


def test_fused_bwd_gradient_dtypes_match_the_inputs():
    """Counterpart of the JAX test_grad_dtypes_match_params: the Function
    returns each gradient in its operand's dtype (bf16, ln fp32); the fp32
    parameters receive them through the cast."""
    modules = convert.stage_blocks_from_jax(stage_blocks(5, 2, 128, 256))
    weights = [w.detach().requires_grad_() for w in ck.stage_weights(modules, torch.bfloat16)]
    x = to_torch(rand(np.random.default_rng(6), 1, 40, 128), torch.bfloat16).requires_grad_()
    out = ck.StageBlocksFusedBwd.apply(x, *weights)
    out.float().sum().backward()
    assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
    for n, w in zip(ck.WEIGHT_NAMES, weights):
        assert w.grad.dtype == w.dtype and w.grad.shape == w.shape, n
    ck.stage_blocks_fused_bwd(x, ck.stage_weights(modules, torch.bfloat16)).float().sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in modules.parameters())


def test_fused_bwd_saves_nothing_where_no_gradient_is_asked(monkeypatch):
    modules = convert.stage_blocks_from_jax(stage_blocks(7, 2, 128, 256))
    x = to_torch(rand(np.random.default_rng(8), 2, 16, 128), torch.float32)

    def refuse(*args):
        raise AssertionError("the Function ran although nothing asks for a gradient")

    ref = x
    for blk in modules:
        ref = pt_convnext.block(ref, blk)
    monkeypatch.setattr(ck.StageBlocksFusedBwd, "forward", staticmethod(refuse))
    with torch.no_grad():
        out = ck.stage_blocks_fused_bwd(x, ck.stage_weights(modules, torch.float32))
    assert out.grad_fn is None and torch.equal(out, ref)
    frozen = tuple(w.detach() for w in ck.stage_weights(modules, torch.float32))
    assert ck.stage_blocks_fused_bwd(x, frozen).grad_fn is None


# --- kernel 19 ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["bf16", "f32"])
@pytest.mark.parametrize("depth,b,l,c,hidden", [(3, 2, 40, 64, 128), (2, 2, 37, 128, 256)])
def test_stage_fwd_plain_matches_the_pallas_kernel(name, depth, b, l, c, hidden):
    tdt, jdt = DTYPES[name]
    blocks = stage_blocks(9, depth, c, hidden)
    x = rand(np.random.default_rng(10), b, l, c)
    ref = jax_stage_fwd.fused_convnext_stage(
        jnp.asarray(x).astype(jdt), jax_stage_fwd.stage_weights(to_jax(blocks, jdt), jdt))
    with torch.no_grad():
        out = ck.stage_fwd(to_torch(x, tdt),
                           ck.stage_weights(convert.stage_blocks_from_jax(blocks), tdt))
    assert out.dtype == tdt and out.shape == (b, l, c)
    if name == "f32":
        np.testing.assert_allclose(as_np(out), as_np(ref), rtol=2e-5, atol=2e-6)
    else:
        top = float(np.abs(as_np(ref)).max())
        ulp = 2.0 ** (math.ceil(math.log2(top)) - 8)
        assert float(np.abs(as_np(out) - as_np(ref)).max()) <= ulp


def test_fused_convnext_stage_gradients_match_jax():
    depth, b, l, c, hidden = 2, 2, 37, 64, 128
    blocks = stage_blocks(11, depth, c, hidden)
    rng = np.random.default_rng(12)
    x, cot = rand(rng, b, l, c), rand(rng, b, l, c)
    ref_gx, ref_gb = jax.grad(
        jax_stage_loss(jax_stage_fwd.fused_convnext_stage_diff, jnp.asarray(cot)),
        argnums=(0, 1))(jnp.asarray(x), to_jax(blocks, jnp.float32))
    modules = convert.stage_blocks_from_jax(blocks)
    tx = torch.from_numpy(x).requires_grad_()
    out = ck.fused_convnext_stage(tx, ck.stage_weights(modules, torch.float32))
    assert "FusedConvnextStage" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(cot))
    assert_leaf_close(tx.grad, ref_gx, "f32", "dx")
    mine = flat_param_grads(modules)
    for path, r in convert.flatten_tree(jax.tree.map(as_np, ref_gb)).items():
        assert_leaf_close(mine[path], r, "f32", path)
