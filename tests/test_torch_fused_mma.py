"""The arithmetic of the tensor-core fused transformer-layer kernels (TPU
kernels 11, 17 and 18, ``csrc/fused_layer_impl.cuh``), held on the CPU
before the card holds the kernels.

``tensor_core_arithmetic()`` below swaps, inside the plain versions of
``ops/fused_layer_kernels``, the two steps whose arithmetic the kernels'
tensor cores change:

* every product ``a . w`` (+ bias), an fp32 sum in depth order
  (``mma_gemm_kernel``): bf16 in steps of 16 (the product of two bf16
  values is exact in fp32, so only the order of the sum moves); f32 as
  3xTF32 in steps of 8, each operand split into a TF32 high part and the
  TF32 rounding of the rest (``cvt.rna``: to nearest, ties away from zero),
  lo.hi + hi.lo + hi.hi summed apart and then added (the lo.lo term, 2**-22
  relative, dropped);
* the global attention (``global_core_kernel``): q and k RoPE'd and rounded
  as before, the logits by 64-column key tiles (3xTF32 in f32), each row's
  online max and sum, then the weights ``round_T(exp(s - m) / l)`` -- cast
  only after the whole row, as the TPU kernels' softmax is -- times v, key
  tile by key tile.

The local core (16 keys per window, fp32 loops) keeps its arithmetic, which
is the plain version's.  The emulation is held:

* against the JAX kernels 17 (``fused_transformer_pair``), 18
  (``fused_local_sublayer``, ``fused_global_sublayer``) and 11
  (``fused_attention_layer``) in interpret mode, as
  tests/test_torch_fused_layers.py runs them, at that file's geometry (D
  128, 2 heads x 64, S = 58 -> P = 64, pad_l 3): f32 within that file's 2e-5
  (the JAX package's own); bf16 within the card limit below, since both
  round at the same places and differ only in the order of fp32 sums;
* against the port's plain versions within the card limit of
  tests/test_torch_kernels.py (f32 1e-5; bf16 2e-2 or 2 ulps of the output's
  top binade), at the default widths (D 256, 4 heads x 64, kv 64, FFN 512)
  and at widths that do not fill 16-byte pieces (kv 50, FFN 298);
* the TF32 split and the 3xTF32 product against float64: one TF32 rounding
  is within 2**-11 relative, the 3xTF32 product within 2**-20 of the sum of
  |a||w|, where a single TF32 product is off by more than 2**-17.

The emulation and ``fused_call`` import no JAX: tests/test_torch_kernels.py
runs them on the card, where there is none.  Inputs come from numpy or a
seeded torch generator.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_to_midi_tpu_torch.config import ModelConfig
from audio_to_midi_tpu_torch.models import attention as pt_attention
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.models import transformer as pt_transformer
from audio_to_midi_tpu_torch.ops import fused_layer_kernels as flk

torch.set_num_threads(2)

KEY_TILE = 64  # key columns per step of the global core's sweeps
CASES = ("block local", "block global", "local sublayer", "global sublayer", "pair")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
DEFAULT_CFG = ModelConfig()
# kv 50 and FFN 298: rows of 100 / 596 bytes in bf16, 200 / 1192 in f32.
RAGGED_CFG = dataclasses.replace(DEFAULT_CFG, compressed_attention_kv_size=50,
                                 transformer_hidden_expansion=298 / 256)


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, to nearest, ties away
    from zero (the magnitude's bits rounded half up)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fp32 sums of a (..., K) . w (..., K, N) in the kernels' order:
    depth steps of 16 (bf16) or 8 (f32, 3xTF32), each step's sum added to the
    total in turn."""
    f32 = a.dtype == torch.float32
    step = 8 if f32 else 16
    total = None
    for k0 in range(0, a.shape[-1], step):
        a_s, w_s = a[..., k0:k0 + step].float(), w[..., k0:k0 + step, :].float()
        if f32:
            (ah, al), (wh, wl) = split_tf32(a_s), split_tf32(w_s)
            part = al @ wh + ah @ wl + ah @ wh
        else:
            part = a_s @ w_s
        total = part if total is None else total + part
    return total


def _matmul(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    out = product(a, w)
    if b is not None:
        out = out + b.float().reshape(-1)
    return out.to(a.dtype)


def _global_mha(q, k, v, columns: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The global core on RoPE'd q, k (..., P, H*hd); columns (P,): the
    columns every row sees, one run [lo, hi)."""
    *lead, p_len, width = q.shape
    hd = width // num_heads
    heads = lambda t: t.reshape(*lead, p_len, num_heads, hd).transpose(-2, -3)
    qh = heads(q * flk._query_scale(hd, q.dtype).to(q.device))
    kh, vh = heads(k), heads(v)
    seen = columns.nonzero().flatten()
    lo, hi = int(seen[0]), int(seen[-1]) + 1
    tiles = [(c0, min(c0 + KEY_TILE, p_len)) for c0 in range(lo // KEY_TILE * KEY_TILE, hi,
                                                              KEY_TILE)]

    def logits(c0, c1):
        s = product(qh, kh[..., c0:c1, :].transpose(-1, -2))
        return torch.where(columns[c0:c1], s, torch.full_like(s, flk.MASK_FILL))

    m = torch.full((*qh.shape[:-1], 1), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    for c0, c1 in tiles:
        s = logits(c0, c1)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new
    acc = 0
    for c0, c1 in tiles:
        weights = (torch.exp(logits(c0, c1) - m) / l).to(v.dtype)
        acc = acc + product(weights, vh[..., c0:c1, :])
    return acc.transpose(-2, -3).reshape(q.shape).to(v.dtype)


@contextlib.contextmanager
def tensor_core_arithmetic():
    """Inside, the plain versions of ``ops/fused_layer_kernels`` take the
    kernels' products and global core (the attention whose mask is one set of
    columns for every row); the windowed attention stays plain."""
    plain_matmul, plain_mha = flk._matmul, flk._mha

    def mha(q, k, v, mask, num_heads):
        if torch.equal(mask, mask[:1].expand_as(mask)):
            return _global_mha(q, k, v, mask[0], num_heads)
        return plain_mha(q, k, v, mask, num_heads)

    flk._matmul, flk._mha = _matmul, mha
    try:
        yield
    finally:
        flk._matmul, flk._mha = plain_matmul, plain_mha


def emulate(plain, *args, **kwargs) -> torch.Tensor:
    """A plain version of kernel 11, 17 or 18 with the kernels' arithmetic."""
    with torch.no_grad(), tensor_core_arithmetic():
        return plain(*args, **kwargs)


def randn(*shape, seed: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(device=device, dtype=dtype)


def fused_call(case: str, cfg: ModelConfig, seq: int, batch: int, dtype, device="cpu",
               seed: int = 0):
    """(wrapper, its plain version, args, kwargs) of one case of kernels 11
    (``block local|global``), 18 (``local|global sublayer``) and 17
    (``pair``) on seeded inputs and a seeded pair of ``cfg`` whose LayerNorms
    are off the identity."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pair = pt_transformer.AlternatingLayer(cfg, gen)
    with torch.no_grad():
        for name, p in pair.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    pair = pair.to(device)
    rope = pt_model.make_rope(cfg, device)
    window, heads = cfg.local_context_window, cfg.num_transformer_heads
    pad_l, pad_r = pt_attention._local_padding(seq, window)
    p_len = seq + pad_l + pad_r
    x = randn(batch, seq, cfg.transformer_hidden_dim, seed=seed + 1, device=device, dtype=dtype)
    xp = F.pad(x, (0, 0, pad_l, pad_r))
    geometry = dict(num_heads=heads, valid_len=seq, pad_l=pad_l)
    tables = pt_transformer._pair_rope_tables(rope, cfg, p_len, pad_l)
    if case.startswith("block"):
        att = pair.get_submodule("local").attention
        ws = [lin.w.to(dtype) for lin in (att.q_up, att.kv_down, att.k_up, att.v_up, att.out)]
        win, rows_in = (window, xp) if case == "block local" else (0, x)
        p = rows_in.shape[1]
        cos, sin = pt_attention._rope_tables(rope, (p // (window // 2) - 1) * window if win else p,
                                             win)
        return (flk.attention_block, flk.attention_block_plain,
                (rows_in, *ws, cos, sin, heads, p, win), {})
    if case == "pair":
        return (flk.transformer_pair, flk.transformer_pair_plain,
                (xp, flk.pair_weights(pair, dtype), tables), dict(window=window, **geometry))
    side = "local" if case == "local sublayer" else "global"
    sw = flk.sublayer_weights(pair.get_submodule(side), dtype)
    if side == "local":
        return (flk.fused_local_sublayer, flk.fused_sublayer_plain, (xp, sw, tables[:4]),
                dict(window=window, **geometry))
    return flk.fused_global_sublayer, flk.fused_sublayer_plain, (xp, sw, tables[4:]), geometry


def card_limit(ref: torch.Tensor) -> float:
    """The card tests' limit against the plain version (test_torch_kernels
    ``_fused_limit``): f32 1e-5; bf16 2e-2, or 2 ulps of the output's top
    binade where that is larger."""
    if ref.dtype == torch.float32:
        return 1e-5
    top = ref.float().abs().max().item()
    return max(2e-2, 2 * 2.0 ** (math.ceil(math.log2(max(top, 2.0 ** -100))) - 8))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# The TF32 split and the 3xTF32 product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 40, 24), (64, 256, 64), (3, 512, 50)])
def test_tf32_split_and_the_3xtf32_product(shape):
    m, depth, n = shape
    rng = np.random.default_rng(depth)
    a = torch.from_numpy(rng.standard_normal((m, depth)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((depth, n)).astype(np.float32))
    hi, lo = split_tf32(a)
    assert not (hi.view(torch.int32) & 0x1FFF).any()                 # 10 mantissa bits
    assert ((a - hi).abs() <= a.abs() * 2.0 ** -11).all()            # to nearest
    assert ((a - hi - lo).abs() <= a.abs() * 2.0 ** -22).all()
    exact = a.double() @ w.double()
    scale = a.double().abs() @ w.double().abs()
    three = (product(a, w).double() - exact).abs() / scale
    one = (tf32(a).double() @ tf32(w).double() - exact).abs() / scale
    assert three.max().item() <= 2.0 ** -20
    assert one.max().item() > 2.0 ** -17                             # what the split buys
    bf = product(a.bfloat16(), w.bfloat16()).double()                 # exact products
    assert ((bf - a.bfloat16().double() @ w.bfloat16().double()).abs() / scale).max() <= 2.0 ** -20


def test_tf32_rounds_ties_away_from_zero():
    base = torch.tensor([1.0, -1.0, 3.0])
    half_ulp = 2.0 ** -11                                             # TF32 ulp of [1, 2) is 2**-10
    x = base + torch.tensor([half_ulp, -half_ulp, 2 * half_ulp])      # ties: 1 + 2**-11, ...
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10, 3.0 + 2 * 2.0 ** -10]


# ---------------------------------------------------------------------------
# The global core's order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("p_len,lo,hi", [(64, 3, 61), (250, 0, 250), (256, 3, 253),
                                         (200, 70, 130)])
def test_global_core_rounds_the_weights_after_the_whole_row(p_len, lo, hi, name):
    """Tile by tile with an online max and sum, the global core is the plain
    whole-row softmax cast to T, up to the order of fp32 sums (f32 within
    1e-5, bf16 within one ulp of the output's top binade); tiles outside
    [lo, hi) are skipped exactly; columns outside get no weight."""
    dtype = DTYPES[name]
    rng = np.random.default_rng(p_len + lo)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, p_len, 128)).astype(np.float32)).to(dtype)
               for _ in range(3))
    columns = torch.zeros(p_len, dtype=torch.bool)
    columns[lo:hi] = True
    mask = columns[None, :].expand(p_len, p_len)
    out = _global_mha(q, k, v, columns, 2)
    ref = flk._mha(q, k, v, mask, 2)
    assert out.dtype == dtype and out.shape == ref.shape
    err = max_abs(out, ref)
    if name == "f32":
        assert err <= 1e-5
    else:
        top = ref.float().abs().max().item()
        assert err <= 2.0 ** (math.ceil(math.log2(top)) - 8)
    moved = v.clone()
    moved[:, :lo] += 5
    moved[:, hi:] -= 5
    assert torch.equal(_global_mha(q, k, moved, columns, 2), out)


# ---------------------------------------------------------------------------
# Against the JAX kernels (interpret mode) and the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_setup():
    """The geometry, JAX params and port model of tests/test_torch_fused_layers.py."""
    import jax

    from tests import test_torch_fused_layers as tfl

    tree = jax.jit(lambda key: tfl.jax_model.init(key, tfl.JAX_CFG)[0])(jax.random.PRNGKey(0))
    model = tfl.port_model(tfl.convert.flatten_tree(jax.device_get(tree)),
                           tfl.port_config(tfl.jax_config.Config(model=tfl.JAX_CFG)))
    return tfl, tree, model


def _jax_case(tfl, tree, model, case: str, name: str):
    """(the JAX kernel's output, the emulation's) for one case in one dtype,
    at tests/test_torch_fused_layers.py's geometry and inputs."""
    import jax
    import jax.numpy as jnp

    dtype, jdt = DTYPES[name], {"f32": jnp.float32, "bf16": jnp.bfloat16}[name]
    p = jax.tree.map(lambda a: a[0], tree["transformer"])
    pair = model.transformer.layers[0]
    jrope, rope = tfl.jax_model.make_rope(tfl.JAX_CFG), pt_model.make_rope(tfl.CFG)
    heads, width = tfl.HEADS, tfl.WIDTH
    if case.startswith("block"):
        window = 16 if case == "block local" else 0
        p_len = tfl.PADDED if window else tfl.SEQ
        x = tfl.rand(np.random.default_rng(5), 2, p_len, width)
        rows = (p_len // 8 - 1) * 16 if window else p_len
        jcos, jsin = tfl.jax_attention._rope_tables(
            jrope, tfl.pa._round_up(rows, 128) if window else rows, window)
        names = ("q_up", "kv_down", "k_up", "v_up", "out")
        ref = tfl.pa.fused_attention_layer(
            jnp.asarray(x, jdt), *(p["local"]["attention"][n]["w"].astype(jdt) for n in names),
            jcos, jsin, heads, p_len, window)
        cos, sin = pt_attention._rope_tables(rope, rows, window)
        att = pair.get_submodule("local").attention
        ws = [lin.w.to(dtype) for lin in (att.q_up, att.kv_down, att.k_up, att.v_up, att.out)]
        out = emulate(flk.attention_block_plain, torch.from_numpy(x).to(dtype), *ws, cos, sin,
                      heads, p_len, window)
        return ref, out
    xp = tfl.padded_input(6)
    jtables = tfl.jax_transformer._pair_rope_tables(jrope, tfl.JAX_CFG, tfl.PADDED, tfl.PAD_L)
    tables = pt_transformer._pair_rope_tables(rope, tfl.CFG, tfl.PADDED, tfl.PAD_L)
    geometry = dict(num_heads=heads, valid_len=tfl.SEQ, pad_l=tfl.PAD_L)
    jx, tx = jnp.asarray(xp, jdt), torch.from_numpy(xp).to(dtype)
    if case == "pair":
        ref = tfl.pallas_pair.fused_transformer_pair(
            jx, tfl.pallas_pair.pair_weights(p, jdt), jtables, window=16, **geometry)
        out = emulate(flk.transformer_pair_plain, tx, flk.pair_weights(pair, dtype), tables,
                      window=16, **geometry)
        return ref, out
    side = "local" if case == "local sublayer" else "global"
    jw = tfl.pallas_sublayer.sublayer_weights(p[side]["attention_norm"], p[side]["attention"], jdt)
    w = flk.sublayer_weights(pair.get_submodule(side), dtype)
    if side == "local":
        ref = tfl.pallas_sublayer.fused_local_sublayer(jx, jw, jtables[:4], window=16, **geometry)
        out = emulate(flk.fused_sublayer_plain, tx, w, tables[:4], window=16, **geometry)
    else:
        ref = tfl.pallas_sublayer.fused_global_sublayer(jx, jw, jtables[4:], **geometry)
        out = emulate(flk.fused_sublayer_plain, tx, w, tables[4:], **geometry)
    return ref, out


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_tensor_core_arithmetic_matches_the_jax_kernels(jax_setup, case, name):
    ref, out = _jax_case(*jax_setup, case, name)
    ref = torch.from_numpy(np.array(ref, np.float32))
    assert out.dtype == DTYPES[name] and out.shape == ref.shape
    limit = 2e-5 if name == "f32" else card_limit(ref.to(torch.bfloat16))
    assert max_abs(out, ref) <= limit
    if case in ("pair", "local sublayer", "global sublayer"):
        pad_l, seq = jax_setup[0].PAD_L, jax_setup[0].SEQ
        assert not out[:, :pad_l].any() and not out[:, pad_l + seq:].any()


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("cfg", [DEFAULT_CFG, RAGGED_CFG], ids=["kv64 ffn512", "kv50 ffn298"])
@pytest.mark.parametrize("case", CASES)
def test_tensor_core_arithmetic_is_within_the_card_limit_of_plain(case, cfg, name):
    """What the card tests hold kernels 11, 17 and 18 to against their plain
    versions, at the default widths and at widths that do not fill 16-byte
    pieces (S = 58 -> P = 64, 2 windows)."""
    _, plain, args, kwargs = fused_call(case, cfg, 58, 2, DTYPES[name], seed=3)
    out = emulate(plain, *args, **kwargs)
    with torch.no_grad():
        ref = plain(*args, **kwargs)
    assert out.dtype == ref.dtype and torch.isfinite(out.float()).all()
    assert max_abs(out, ref) <= card_limit(ref)


def test_tensor_core_arithmetic_is_not_the_plain_version():
    """In f32 the 3xTF32 products move the outputs off the plain version's
    (fp32 products), by far less than the card limit."""
    _, plain, args, kwargs = fused_call("pair", DEFAULT_CFG, 58, 2, torch.float32, seed=4)
    out = emulate(plain, *args, **kwargs)
    with torch.no_grad():
        ref = plain(*args, **kwargs)
    assert 0 < max_abs(out, ref) <= 1e-5
