"""The port's attention-weight dropout vs the JAX package: the plain Philox,
the plain versions of the dropout kernels, and the routing.

On the CPU the wrappers run their plain PyTorch versions.  The JAX side runs
its precomputed-bits kernels in interpret mode (its in-kernel-PRNG kernels
have no interpret mode; their masks are the TPU generator's and are never
reproduced), and both sides are fed the same uint8 bits from numpy.
Tolerances as in tests/test_torch_attention*.py: forward f32 1e-5, bf16 2e-2
(outputs round to 8 mantissa bits); backward f32 rtol 1e-4 / atol 1e-5 (the
JAX package's own), bf16 rtol 2e-2 / atol 2e-2.  tests/test_torch_kernels.py
holds the CUDA kernels against these plain versions on the card.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.ops import pallas_attention as pa
from audio_to_midi_tpu_torch.models import attention as pt_attention
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.models import nn as pt_nn
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_attention import _attention_pair
from tests.test_torch_attention_bwd import DTYPES, both, inputs
from tests.test_torch_primitives import SMALL_CFG, close

torch.set_num_threads(2)

HEADS, HD = 2, 8
THRESHOLD = 26
FWD_TOL = {"f32": dict(rtol=0, atol=1e-5), "bf16": dict(rtol=0, atol=2e-2)}
BWD_TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def seed_of(a: int, b: int) -> torch.Tensor:
    return torch.tensor([a, b], dtype=torch.int32)


def random_bits(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# --- the plain Philox ---------------------------------------------------------


# Random123's known answers for philox4x32-10 (counter, key -> output); the
# first was also read from a CUDA torch.Generator seeded with 0 on an H100,
# whose first 32-bit draw is 0x6627e8d5.
@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(counter, key, expected):
    as_i64 = lambda xs: [torch.tensor(x, dtype=torch.int64) for x in xs]
    out = ak.philox4x32_10(as_i64(counter), as_i64(key))
    assert " ".join(f"{int(w):08x}" for w in out) == expected


def bytes_at(seed: torch.Tensor, sample: int, core: int, rows, cols) -> torch.Tensor:
    """The mask bytes at (rows, cols) of stream (sample, core), drawn alone:
    byte col % 16 (little endian) of philox(counter=(row, col // 16, sample,
    core), key=seed)."""
    i64 = lambda x: torch.as_tensor(x, dtype=torch.int64)
    key = [i64(int(w)) & 0xFFFFFFFF for w in seed]  # negative words: their uint32 patterns
    words = torch.stack(torch.broadcast_tensors(
        *ak.philox4x32_10((i64(rows), i64(cols) // 16, i64(sample), i64(core)), key)))
    lane = (i64(cols) % 16).expand(words.shape[1:])
    word = torch.gather(words, 0, (lane // 4)[None])[0]
    return ((word >> (8 * (lane % 4))) & 255).to(torch.uint8)


def test_philox_bits_are_addressed_by_position():
    """A sub-block of the plane equals the same sub-block drawn alone, so
    any tiling of the kernels reads the same mask."""
    seed = seed_of(123456789, -42)
    plane = ak.philox_bits_plain(seed, 3, 4, 50)
    assert plane.dtype == torch.uint8 and tuple(plane.shape) == (3, 4, 50, 50)
    rows, cols = torch.arange(9, 41)[:, None], torch.arange(7, 50)[None, :]
    assert torch.equal(bytes_at(seed, 2, 3, rows, cols), plane[2, 3, 9:41, 7:50])
    assert int(bytes_at(seed, 0, 1, 17, 16)) == int(plane[0, 1, 17, 16])
    assert torch.equal(ak.philox_bits_plain(seed, 1, 2, 24), plane[:1, :2, :24, :24])
    assert torch.equal(ak.philox_bits(seed, 3, 4, 50), plane)  # the wrapper, on the CPU
    assert not torch.equal(ak.philox_bits_plain(seed_of(123456789, -41), 3, 4, 50), plane)


def test_philox_bits_keep_at_the_quantized_rate():
    bits = ak.philox_bits_plain(seed_of(5, 6), 4, 8, 128)
    p_keep = (256 - THRESHOLD) / 256
    keep = (bits >= THRESHOLD).float().mean().item()
    assert abs(keep - p_keep) <= 4 * math.sqrt(p_keep * (1 - p_keep) / bits.numel())
    kept = ak._apply_bits(torch.ones(bits.shape), bits, THRESHOLD)
    assert set(kept.unique().tolist()) == {0.0, np.float32(256.0 / (256.0 - THRESHOLD)).item()}


@pytest.mark.parametrize("rate", [0.0, 0.001, 1 / 600, 0.1, 0.25, 0.5, 0.998, 0.999, 1.0])
def test_dropout_threshold_matches_jax(rate):
    assert ak.dropout_threshold(rate) == pa.dropout_threshold(rate)


# --- kernels 4 and 5: the forwards on explicit bits ---------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,block,valid_len", [(250, 0, 250), (256, 0, 200), (128, 16, 128)])
def test_global_attention_bits_plain_matches_pallas(s, block, valid_len, dtype):
    """The TPU kernel takes inputs padded to a multiple of 128 with
    ``valid_len`` and bits of the padded size; the port takes S as it is and
    the top-left S x S of the bits."""
    arrays = inputs(s + block + valid_len, 3, 2, s, HEADS * HD)
    s_pad = -(-s // 128) * 128
    bits = random_bits(s, 2, HEADS, s_pad, s_pad)
    jx, _ = both([np.pad(a, ((0, 0), (0, s_pad - s), (0, 0))) for a in arrays], dtype)
    _, tx = both(arrays, dtype)
    ref = pa.fused_attention_nhd_dropout(*jx, jnp.asarray(bits), HEADS, block, THRESHOLD,
                                         min(valid_len, s))
    tbits = torch.from_numpy(np.ascontiguousarray(bits[:, :, :s, :s]))
    out = ak.global_attention_dropout_bits(*tx, tbits, HEADS, block, valid_len,
                                           threshold=THRESHOLD)
    assert out.dtype == DTYPES[dtype][1]
    close(out, ref[:, :s].astype(jnp.float32), **FWD_TOL[dtype])
    mirror = pa._xla_reference_nhd_bits(*jx, jnp.asarray(bits), HEADS, block, THRESHOLD,
                                        min(valid_len, s))
    close(out, mirror[:, :s].astype(jnp.float32), **FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("p_len", [64, 32, 16])
def test_local_two_phase_bits_plain_matches_pallas(p_len, dtype):
    jx, tx = both(inputs(p_len, 5, 2, p_len, HEADS * HD), dtype)
    bits = random_bits(p_len, 2, 2, HEADS, p_len, p_len)
    ref = pa.fused_local_two_phase_dropout(*jx, jnp.asarray(bits[0]), jnp.asarray(bits[1]),
                                           HEADS, 16, THRESHOLD)
    out = ak.local_two_phase_dropout_bits(*tx, torch.from_numpy(bits[0]),
                                          torch.from_numpy(bits[1]), HEADS, 16,
                                          threshold=THRESHOLD)
    close(out, ref.astype(jnp.float32), **FWD_TOL[dtype])
    free = ak.local_two_phase(*tx, HEADS, 16)
    assert (out.float() - free.float()).abs().max() > 0.05  # it did drop


# --- kernels 8 and 9: the backwards on explicit bits --------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("p_len", [64, 32, 48, 80])
def test_local_two_phase_grads_bits_plain_matches_pallas(p_len, dtype):
    jx, tx = both(inputs(p_len + 1, 6, 2, p_len, HEADS * HD), dtype)
    bits = random_bits(p_len + 1, 2, 2, HEADS, p_len, p_len)
    ref = pa.two_phase_grads_drop(*jx[:5], jnp.asarray(bits[0]), jnp.asarray(bits[1]), jx[5],
                                  HEADS, 16, THRESHOLD)
    out = ak.local_two_phase_grads_bits(*tx[:5], torch.from_numpy(bits[0]),
                                        torch.from_numpy(bits[1]), tx[5], HEADS, 16,
                                        threshold=THRESHOLD)
    assert len(out) == 5
    for o, r in zip(out, ref):
        assert o.dtype == DTYPES[dtype][1]
        close(o, r.astype(jnp.float32), **BWD_TOL[dtype])


def test_local_two_phase_grads_bits_match_the_vjp_of_the_jax_mirror():
    jx, tx = both(inputs(21, 6, 1, 48, HEADS * HD), "f32")
    bits = random_bits(21, 2, 1, HEADS, 48, 48)
    _, vjp = jax.vjp(
        lambda *a: pa._two_phase_reference_bits(*a, jnp.asarray(bits[0]), jnp.asarray(bits[1]),
                                                num_heads=HEADS, window=16, threshold=THRESHOLD),
        *jx[:5])
    out = ak.local_two_phase_grads_bits(*tx[:5], torch.from_numpy(bits[0]),
                                        torch.from_numpy(bits[1]), tx[5], HEADS, 16,
                                        threshold=THRESHOLD)
    for o, r in zip(out, vjp(jx[5])):
        close(o, r, **BWD_TOL["f32"])


@pytest.mark.parametrize("s,block,valid_len", [(128, 0, 128), (128, 0, 100), (128, 16, 128)])
def test_global_attention_grads_bits_match_the_vjp_of_the_jax_mirror(s, block, valid_len):
    jx, tx = both(inputs(s + block + valid_len + 2, 4, 1, s, HEADS * HD), "f32")
    bits = random_bits(s + block, 1, HEADS, s, s)
    _, vjp = jax.vjp(
        lambda q, k, v: pa._xla_reference_nhd_bits(q, k, v, jnp.asarray(bits), HEADS, block,
                                                   THRESHOLD, valid_len=valid_len), *jx[:3])
    out = ak.global_attention_grads(*tx, HEADS, block, valid_len, torch.from_numpy(bits),
                                    THRESHOLD)
    for o, r in zip(out, vjp(jx[3])):
        close(o, r, **BWD_TOL["f32"])


# --- kernels 12-16 on the CPU: a seed stands for its plain Philox bits --------


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("s,block,valid_len", [(130, 0, None), (130, 0, 100), (48, 16, 48)])
def test_seeded_global_attention_equals_the_bits_route_on_its_philox_bits(s, block, valid_len):
    seed = seed_of(s, 9)
    q, k, v = _leaves(inputs(s, 3, 2, s, HEADS * HD))
    bits = ak.philox_bits_plain(seed, 2, HEADS, s)
    out = ak.global_attention_dropout(q, k, v, seed, HEADS, block, valid_len, threshold=THRESHOLD)
    ref = ak.global_attention_dropout_bits(q, k, v, bits, HEADS, block, valid_len,
                                           threshold=THRESHOLD)
    assert torch.equal(out, ref)
    assert type(out.grad_fn).__name__ == "_GlobalAttentionFnBackward"
    cot = torch.from_numpy(inputs(s + 1, 1, 2, s, HEADS * HD)[0])
    grads = torch.autograd.grad(out, (q, k, v), cot)
    for got, want in zip(grads, torch.autograd.grad(ref, (q, k, v), cot)):
        assert torch.equal(got, want)
    # The Function's backward is the plain backward kernel's arithmetic, and
    # agrees with autograd through the plain forward.
    plain = ak.global_attention_plain(q, k, v, HEADS, block, valid_len, bits, THRESHOLD)
    for got, want in zip(grads, torch.autograd.grad(plain, (q, k, v), cot)):
        close(got, want, **BWD_TOL["f32"])
    wanted = ak.global_attention_grads_prng(q.detach(), k.detach(), v.detach(), seed, cot, HEADS,
                                            block, valid_len, threshold=THRESHOLD)
    assert all(torch.equal(a, b) for a, b in zip(grads, wanted))


@pytest.mark.parametrize("p_len", [64, 16])
def test_seeded_local_two_phase_equals_the_bits_route_on_its_philox_bits(p_len):
    seed = seed_of(p_len, -1)
    ts = _leaves(inputs(p_len + 3, 5, 2, p_len, HEADS * HD))
    bits_a, bits_b = ak.two_phase_planes(ak.philox_bits_plain(seed, 2, 2 * HEADS, p_len), HEADS)
    out = ak.local_two_phase_dropout(*ts, seed, HEADS, 16, threshold=THRESHOLD)
    ref = ak.local_two_phase_dropout_bits(*ts, bits_a, bits_b, HEADS, 16, threshold=THRESHOLD)
    assert torch.equal(out, ref)
    assert type(out.grad_fn).__name__ == "_LocalTwoPhaseFnBackward"
    cot = torch.from_numpy(inputs(p_len + 4, 1, 2, p_len, HEADS * HD)[0])
    grads = torch.autograd.grad(out, ts, cot)
    for got, want in zip(grads, torch.autograd.grad(ref, ts, cot)):
        assert torch.equal(got, want)
    plain = ak.local_two_phase_plain(*ts, HEADS, 16, bits_a, bits_b, THRESHOLD)
    for got, want in zip(grads, torch.autograd.grad(plain, ts, cot)):
        close(got, want, **BWD_TOL["f32"])


def test_dropout_wrappers_count_nothing_on_the_cpu_and_check_their_threshold():
    before = [fn.launches for fn in ak.KERNELS]
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 3, 1, 32, HEADS * HD))
    seed = seed_of(1, 2)
    ak.global_attention_dropout(q, k, v, seed, HEADS, threshold=THRESHOLD)
    ak.local_two_phase_dropout(q, k, q, k, v, seed, HEADS, 16, threshold=THRESHOLD)
    assert [fn.launches for fn in ak.KERNELS] == before
    for threshold in (0, 256):
        with pytest.raises(ValueError, match="threshold"):
            ak.global_attention_dropout(q, k, v, seed, HEADS, threshold=threshold)
        with pytest.raises(ValueError, match="threshold"):
            ak.local_two_phase_dropout(q, k, q, k, v, seed, HEADS, 16, threshold=threshold)


def test_seeded_attention_dropout_is_unbiased():
    """Mean over 64 seeds of the dropped attention within 5 sigma of the
    dropout-free attention (inverted dropout, through the linear V product)."""
    q, k, v = (torch.from_numpy(a) for a in inputs(4, 3, 1, 128, HEADS * HD))
    base = ak.global_attention(q, k, v, HEADS)
    outs = torch.stack([ak.global_attention_dropout(q, k, v, seed_of(100 + i, i), HEADS,
                                                    threshold=THRESHOLD) for i in range(64)])
    sigma = outs.std(dim=0) / math.sqrt(outs.shape[0])
    assert ((outs.mean(dim=0) - base).abs() <= 5 * sigma + 1e-6).all()
    assert sigma.mean() > 1e-3  # the seeds do give different masks


# --- routing in models/attention ---------------------------------------------


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls of the seeded cores, the dropout-free cores and the
    exact-rate ``nn.dropout``."""
    calls = dict.fromkeys(["global_seeded", "local_seeded", "global_free", "local_free",
                           "exact"], 0)

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[key] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    spy(ak, "global_attention_dropout", "global_seeded")
    spy(ak, "local_two_phase_dropout", "local_seeded")
    spy(ak, "global_attention", "global_free")
    spy(ak, "local_two_phase", "local_free")
    spy(pt_nn, "dropout", "exact")
    return calls


def _run(fn, seq_len, cfg, seed=0, **kwargs):
    _, module = _attention_pair(4)
    x = torch.from_numpy(inputs(seq_len, 1, 2, seq_len, 32)[0])
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return fn(x, module, pt_model.make_rope(cfg), cfg, generator=gen, enable_dropout=True,
                  **kwargs)


def test_default_rate_takes_the_seeded_kernels(routes):
    cfg = SMALL_CFG.model  # transformer_dropout_rate 0.1 -> threshold 26
    out = _run(pt_attention.self_attention, 250, cfg)
    out_l = _run(pt_attention.local_self_attention, 250, cfg)  # padded 256
    assert routes == dict(global_seeded=1, local_seeded=1, global_free=0, local_free=0, exact=0)
    assert torch.isfinite(out).all() and torch.isfinite(out_l).all()
    assert torch.equal(out, _run(pt_attention.self_attention, 250, cfg))      # same seed
    assert not torch.equal(out, _run(pt_attention.self_attention, 250, cfg, seed=1))
    # "xla" takes the JAX package's einsum route: the exact rate through
    # nn.dropout, for the global and the local layer alike.
    xla = dataclasses.replace(cfg, attention_impl="xla")
    out_x = _run(pt_attention.self_attention, 250, xla)
    out_xl = _run(pt_attention.local_self_attention, 250, xla)
    assert routes == dict(global_seeded=3, local_seeded=1, global_free=0, local_free=0, exact=2)
    assert torch.isfinite(out_x).all() and torch.isfinite(out_xl).all()
    assert not torch.equal(out_x, out)


@pytest.mark.parametrize("rate", [0.001, 1 / 600, 0.999, 1.0])
def test_rates_that_do_not_quantize_take_the_exact_rate_route(routes, rate):
    """Threshold 0 would drop nothing and 256 everything: the plain route
    applies the true rate, the same for 'pallas' and 'xla'."""
    cfg = dataclasses.replace(SMALL_CFG.model, transformer_dropout_rate=rate)
    assert not 0 < ak.dropout_threshold(rate) < 256
    for fn in (pt_attention.self_attention, pt_attention.local_self_attention):
        out = _run(fn, 250, cfg)
        xla = _run(fn, 250, dataclasses.replace(cfg, attention_impl="xla"))
        assert torch.isfinite(out).all() and torch.equal(out, xla)
    assert routes == dict(global_seeded=0, local_seeded=0, global_free=0, local_free=0, exact=4)


def test_plain_routes_drop_at_the_exact_rate_and_the_kernels_at_the_quantized_one(monkeypatch):
    """Fault 2: under dropout "xla" keeps each attention weight with
    probability 0.9 and scales the kept ones by exactly 1/0.9, as the JAX
    einsum route does; "pallas" keeps 230/256.  ~8 M weights put the two
    shares ~15 sigma apart; each must lie within 5 sigma of its own."""
    seen = {}

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(x, *args, **kwargs):
            out = real(x, *args, **kwargs)
            seen[key] = (x, out)
            return out
        monkeypatch.setattr(module, name, wrapped)

    spy(pt_nn, "dropout", "xla")
    spy(ak, "_apply_bits", "pallas")
    _, module = _attention_pair(4)
    x = torch.from_numpy(inputs(11, 1, 64, 250, 32)[0])
    rope = pt_model.make_rope(SMALL_CFG.model)
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(SMALL_CFG.model, attention_impl=impl)
        with torch.no_grad():
            pt_attention.self_attention(x, module, rope, cfg, generator=torch.Generator().manual_seed(5),
                                        enable_dropout=True)
    for impl, keep in (("xla", 0.9), ("pallas", 230 / 256)):
        weights, dropped = seen[impl]
        assert weights.numel() >= 8_000_000
        kept = dropped != 0
        share = kept.double().mean().item()
        sigma = math.sqrt(keep * (1 - keep) / weights.numel())
        assert abs(share - keep) <= 5 * sigma, (impl, share)
    weights, dropped = seen["xla"]
    kept = dropped != 0
    assert torch.equal(dropped[kept], weights[kept] / 0.9)


def test_short_sequences_stay_off_the_global_dropout_kernel(routes):
    out = _run(pt_attention.self_attention, 100, SMALL_CFG.model)
    assert routes["global_seeded"] == 0 and routes["exact"] == 1
    assert torch.isfinite(out).all()


def test_local_dropout_takes_the_windowed_route_when_the_padding_does_not_fit(routes):
    """50 frames pad to 56, 56 % 16 != 0: (B, W, 16, 16) weights dropped at
    the exact rate, not the flattened-window kernel route."""
    out = _run(pt_attention.local_self_attention, 50, SMALL_CFG.model)
    assert routes == dict(global_seeded=0, local_seeded=0, global_free=0, local_free=0, exact=1)
    assert torch.isfinite(out).all() and tuple(out.shape) == (2, 50, 32)
    free = dataclasses.replace(SMALL_CFG.model, transformer_dropout_rate=0.0)
    assert not torch.equal(out, _run(pt_attention.local_self_attention, 50, free))
    assert routes["global_free"] == 1  # rate 0 keeps the dropout-free kernel route


def test_zero_rate_and_disabled_dropout_keep_the_dropout_free_kernels(routes):
    free = dataclasses.replace(SMALL_CFG.model, transformer_dropout_rate=0.0)
    a = _run(pt_attention.self_attention, 250, free)
    _, module = _attention_pair(4)
    x = torch.from_numpy(inputs(250, 1, 2, 250, 32)[0])
    with torch.no_grad():
        b = pt_attention.self_attention(x, module, pt_model.make_rope(free), SMALL_CFG.model)
    assert torch.equal(a, b)
    assert routes == dict(global_seeded=0, local_seeded=0, global_free=2, local_free=0, exact=0)
    with pytest.raises(ValueError, match="generator"):
        pt_attention.self_attention(x, module, pt_model.make_rope(free), SMALL_CFG.model,
                                    enable_dropout=True)


def test_precomputed_bits_route_gives_the_seeded_route(monkeypatch):
    """A2M_PRNG_DROPOUT=0, as in the JAX package, takes the bits kernels on
    the bytes of the same seed."""
    cfg = SMALL_CFG.model
    seeded = [_run(fn, 250, cfg) for fn in (pt_attention.self_attention,
                                           pt_attention.local_self_attention)]
    monkeypatch.setenv("A2M_PRNG_DROPOUT", "0")
    assert not ak.prng_dropout_available()
    used = []
    real = ak.global_attention_dropout_bits
    monkeypatch.setattr(ak, "global_attention_dropout_bits",
                        lambda *a, **k: used.append("global") or real(*a, **k))
    real_l = ak.local_two_phase_dropout_bits
    monkeypatch.setattr(ak, "local_two_phase_dropout_bits",
                        lambda *a, **k: used.append("local") or real_l(*a, **k))
    by_bits = [_run(fn, 250, cfg) for fn in (pt_attention.self_attention,
                                            pt_attention.local_self_attention)]
    assert used == ["global", "local"]
    assert all(torch.equal(a, b) for a, b in zip(seeded, by_bits))
