"""The fused transformer-layer kernels of the port (``attention_impl``
"pallas_block", "pallas_fused", "pallas_pair") vs the JAX package.

At the geometry of the JAX package's own tests (tests/test_pallas_pair.py:
D = 128, 2 heads x 64, one pair), S = 58 frames -> P = 64 padded rows with
pad_l = 3, the case that exercises the padded-coordinate quirk.  Weights from
JAX ``models/model.init`` through the converter, inputs from a numpy seed.
The JAX kernels run in interpret mode, as their own tests run them; on the
CPU the port's wrappers run their plain versions.  Tolerances (f32): the
kernels and the stacks 2e-5 (the JAX package's own), the model rtol 5e-4 /
atol 5e-5 (tests/test_pallas_attention.py), gradients 2e-4.
tests/test_torch_kernels.py holds the CUDA kernels against these plain
versions on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import attention as jax_attention
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.models import transformer as jax_transformer
from audio_to_midi_tpu.ops import pallas_attention as pa
from audio_to_midi_tpu.ops import pallas_pair, pallas_sublayer
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import attention as pt_attention
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.models import transformer as pt_transformer
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from audio_to_midi_tpu_torch.ops import fused_layer_kernels as flk
from tests.test_torch_primitives import close, port_config, port_model, rand

torch.set_num_threads(2)

IMPLS = ("pallas_block", "pallas_fused", "pallas_pair")
SEQ, PAD_L, PADDED, WIDTH, HEADS = 58, 3, 64, 128, 2
TOL = dict(rtol=2e-5, atol=2e-5)
JAX_CFG = jax_config.ModelConfig(
    dims=(4, 128), depths=(1, 1), num_transformer_layers=1, num_transformer_heads=HEADS,
    attention_size=64, compressed_attention_kv_size=64, compressed_attention_q_size=64,
    rope_max_positions=128, attention_impl="xla", cnn_impl="xla")
CFG = port_config(jax_config.Config(model=JAX_CFG)).model


def with_impl(impl: str):
    return dataclasses.replace(JAX_CFG, attention_impl=impl), dataclasses.replace(
        CFG, attention_impl=impl)


@pytest.fixture(scope="module")
def params():
    """(JAX param tree, the same params in the port's Model).  One jitted
    init compiles faster than the op-by-op one."""
    tree = jax.jit(lambda key: jax_model.init(key, JAX_CFG)[0])(jax.random.PRNGKey(0))
    return tree, port_model(convert.flatten_tree(jax.device_get(tree)),
                            port_config(jax_config.Config(model=JAX_CFG)))


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls of the fused wrappers and of the "pallas" and
    "pallas_rw" cores."""
    calls = {}
    for module, name in ((flk, "attention_block"), (flk, "fused_local_sublayer"),
                         (flk, "fused_global_sublayer"), (flk, "transformer_pair"),
                         (ak, "global_attention"), (ak, "local_two_phase"),
                         (ak, "local_two_phase_rw")):
        real = getattr(module, name)
        calls[name] = 0

        def wrapped(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    return calls


def padded_input(seed: int) -> np.ndarray:
    """(2, P, D) in padded coordinates: the sequence at rows [pad_l, pad_l +
    S), zero elsewhere."""
    xp = np.zeros((2, PADDED, WIDTH), np.float32)
    xp[:, PAD_L:PAD_L + SEQ] = rand(np.random.default_rng(seed), 2, SEQ, WIDTH)
    return xp


def _kernel_case(case: str, tree, model):
    """(the JAX kernel's output, the port wrapper's) for one case, f32."""
    p = jax.tree.map(lambda a: a[0], tree["transformer"])
    pair = model.transformer.layers[0]
    jrope, rope = jax_model.make_rope(JAX_CFG), pt_model.make_rope(CFG)
    f32 = jnp.float32
    if case.startswith("block"):
        window = 16 if case == "block window 16" else 0
        p_len = PADDED if window else SEQ
        x = rand(np.random.default_rng(5), 2, p_len, WIDTH)
        rows = (p_len // 8 - 1) * 16 if window else p_len
        jcos, jsin = jax_attention._rope_tables(jrope, pa._round_up(rows, 128) if window else rows,
                                                window)
        names = ("q_up", "kv_down", "k_up", "v_up", "out")
        ref = pa.fused_attention_layer(
            jnp.asarray(x), *(p["local"]["attention"][n]["w"] for n in names), jcos, jsin,
            HEADS, p_len, window)
        cos, sin = pt_attention._rope_tables(rope, rows, window)
        att = pair.get_submodule("local").attention
        out = flk.attention_block(torch.from_numpy(x), att.q_up.w, att.kv_down.w, att.k_up.w,
                                  att.v_up.w, att.out.w, cos, sin, HEADS, p_len, window)
        return ref, out
    xp = padded_input(6)
    jtables = jax_transformer._pair_rope_tables(jrope, JAX_CFG, PADDED, PAD_L)
    tables = pt_transformer._pair_rope_tables(rope, CFG, PADDED, PAD_L)
    geometry = dict(num_heads=HEADS, valid_len=SEQ, pad_l=PAD_L)
    if case == "pair":
        ref = pallas_pair.fused_transformer_pair(
            jnp.asarray(xp), pallas_pair.pair_weights(p, f32), jtables, window=16, **geometry)
        out = flk.transformer_pair(torch.from_numpy(xp), flk.pair_weights(pair, torch.float32),
                                   tables, window=16, **geometry)
        return ref, out
    side = "local" if case == "local sublayer" else "global"
    jw = pallas_sublayer.sublayer_weights(p[side]["attention_norm"], p[side]["attention"], f32)
    w = flk.sublayer_weights(pair.get_submodule(side), torch.float32)
    if side == "local":
        ref = pallas_sublayer.fused_local_sublayer(jnp.asarray(xp), jw, jtables[:4], window=16,
                                                   **geometry)
        out = flk.fused_local_sublayer(torch.from_numpy(xp), w, tables[:4], window=16, **geometry)
    else:
        ref = pallas_sublayer.fused_global_sublayer(jnp.asarray(xp), jw, jtables[4:], **geometry)
        out = flk.fused_global_sublayer(torch.from_numpy(xp), w, tables[4:], **geometry)
    return ref, out


@pytest.mark.parametrize("case", ["pair", "local sublayer", "global sublayer",
                                  "block window 16", "block global"])
def test_plain_versions_match_the_jax_kernels(params, case):
    tree, model = params
    with torch.no_grad():
        ref, out = _kernel_case(case, tree, model)
    assert out.shape == ref.shape
    close(out, ref, **TOL)
    if case in ("pair", "local sublayer", "global sublayer"):
        # Rows outside the sequence stay exactly zero.
        assert not out[:, :PAD_L].any() and not out[:, PAD_L + SEQ:].any()


# Launches per forward of one pair: the fused wrappers, none of the "pallas" cores.
EXPECTED_ROUTES = {
    "pallas_block": dict(attention_block=2),
    "pallas_fused": dict(fused_local_sublayer=1, fused_global_sublayer=1),
    "pallas_pair": dict(transformer_pair=1),
}


@pytest.mark.parametrize("impl", IMPLS)
def test_transformer_stack_matches_jax(params, routes, impl):
    tree, model = params
    jcfg, cfg = with_impl(impl)
    x = rand(np.random.default_rng(7), 2, SEQ, WIDTH)
    if impl != "pallas_block":
        assert jax_transformer._pair_kernel_applicable(jcfg, jnp.asarray(x), False)
        assert pt_transformer._pair_kernel_applicable(cfg, torch.from_numpy(x), False)
    ref = jax_transformer.transformer_stack(jnp.asarray(x), tree["transformer"],
                                            jax_model.make_rope(jcfg), jcfg)
    with torch.no_grad():
        out = pt_transformer.transformer_stack(torch.from_numpy(x), model.transformer,
                                               pt_model.make_rope(cfg), cfg)
    close(out, ref, **TOL)
    assert routes == dict.fromkeys(routes, 0) | EXPECTED_ROUTES[impl]


@pytest.mark.parametrize("impl", IMPLS)
def test_model_forward_matches_jax(params, impl):
    tree, model = params
    jcfg, cfg = with_impl(impl)
    audio = rand(np.random.default_rng(8), 2, 2, SEQ * 10) * 0.5
    ref_logits, ref_probs = jax_model.forward(tree, jcfg, jnp.asarray(audio),
                                              jax_model.make_rope(jcfg))
    with torch.no_grad():
        logits, probs = pt_model.forward(model, cfg, torch.from_numpy(audio),
                                         pt_model.make_rope(cfg))
    assert probs.shape == (2, SEQ, 90)
    close(probs, ref_probs, rtol=5e-4, atol=5e-5)
    close(logits, ref_logits, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_gradients_match_the_jax_custom_vjps(params, impl):
    """d/dx and d/dparams of sum(stack(x)^2) through the port's Functions
    against the JAX package's custom_vjps; the output carries a grad_fn."""
    tree, model = params
    jcfg, cfg = with_impl(impl)
    x = rand(np.random.default_rng(9), 2, SEQ, WIDTH)
    jrope = jax_model.make_rope(jcfg)
    loss = lambda xx, p: jnp.sum(jax_transformer.transformer_stack(xx, p, jrope, jcfg) ** 2)
    ref_dx, ref_dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), tree["transformer"])
    xt = torch.from_numpy(x).requires_grad_()
    for q in model.parameters():
        q.grad = None
    out = pt_transformer.transformer_stack(xt, model.transformer, pt_model.make_rope(cfg), cfg)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    close(xt.grad, ref_dx, rtol=2e-4, atol=2e-4)
    mine = convert.state_dict_to_jax({n: q.grad for n, q in model.named_parameters()
                                      if n.startswith("transformer.")})
    ref = convert.flatten_tree(jax.device_get({"transformer": ref_dp}))
    assert set(mine) == set(ref)
    for name, grad in mine.items():
        close(grad, ref[name], rtol=2e-4, atol=2e-4)
    for q in model.parameters():
        q.grad = None


@pytest.mark.parametrize("impl", IMPLS)
def test_the_gates_take_the_plain_formulation_in_both_packages(params, routes, impl):
    """A geometry pair_supported refuses (D = 32, 2 heads x 16) and dropout
    on keep the JAX routing: no fused kernel, the plain cores."""
    _, model = params
    jcfg, cfg = with_impl(impl)
    narrow = dataclasses.replace(cfg, dims=(4, 32), attention_size=16,
                                 compressed_attention_kv_size=16, compressed_attention_q_size=16)
    narrow_jax = dataclasses.replace(jcfg, dims=(4, 32), attention_size=16,
                                     compressed_attention_kv_size=16,
                                     compressed_attention_q_size=16)
    assert not flk.pair_supported(PADDED, 32, HEADS, 16)
    assert not pt_transformer._pair_kernel_applicable(narrow, torch.zeros(2, SEQ, 32), False)
    assert not jax_transformer._pair_kernel_applicable(narrow_jax, jnp.zeros((2, SEQ, 32)), False)
    x = torch.from_numpy(rand(np.random.default_rng(10), 2, SEQ, WIDTH))
    assert not pt_transformer._pair_kernel_applicable(cfg, x, True)
    assert not jax_transformer._pair_kernel_applicable(jcfg, jnp.asarray(x.numpy()), True)
    with torch.no_grad():
        out = pt_transformer.transformer_stack(x, model.transformer, pt_model.make_rope(cfg), cfg,
                                               generator=torch.Generator().manual_seed(0),
                                               enable_dropout=True)
    assert torch.isfinite(out).all()
    assert routes == dict.fromkeys(routes, 0)  # plain cores under dropout, for all three


def test_pallas_rw_still_raises(params, routes):
    """The "pallas_rw" stack matches the JAX "pallas_rw" stack: kernel 6 in
    the local layer (P = 64: the two-phase route), kernel 1 in the global
    one, none of the fused kernels and not kernel 2."""
    tree, model = params
    jcfg, cfg = with_impl("pallas_rw")
    x = rand(np.random.default_rng(11), 2, SEQ, WIDTH)
    ref = jax_transformer.transformer_stack(jnp.asarray(x), tree["transformer"],
                                            jax_model.make_rope(jcfg), jcfg)
    with torch.no_grad():
        out = pt_transformer.transformer_stack(torch.from_numpy(x), model.transformer,
                                               pt_model.make_rope(cfg), cfg)
    close(out, ref, **TOL)
    assert routes == dict.fromkeys(routes, 0) | dict(global_attention=1, local_two_phase_rw=1)


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    """On the CPU the wrappers take the plain versions and count nothing; a
    device that is neither CPU nor CUDA is refused."""
    before = [fn.launches for fn in flk.KERNELS]
    x = torch.zeros(1, 32, 128, device="meta")
    with pytest.raises(ValueError):
        flk.transformer_pair(x, (), (), num_heads=2, valid_len=32, pad_l=0, window=16)
    assert [fn.launches for fn in flk.KERNELS] == before
