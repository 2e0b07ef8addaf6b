"""Grain's random-access permutation, ``index_shuffle(index, max_index, seed,
rounds)``, in numpy: bit for bit the C++ function behind
``grain.experimental.index_shuffle`` (not its pure-Python md5 Feistel, which
is another permutation).

The permutation of [0, max_index] is a Simon-style Feistel cipher on a block
of w bits, w = ceil(log2(max_index)) rounded up to even and at least 16,
with cycle walking: an output above ``max_index`` is encrypted again until
it falls inside.  The round keys are ``std::seed_seq{seed}.generate(rounds)``
(the algorithm C++ fixes in [rand.util.seedseq], not numpy's
``SeedSequence``); each pair of them drives one round of two half-updates.
"""

from __future__ import annotations

import functools
import math

import numpy as np

_M32 = 0xFFFFFFFF


def seed_seq_generate(seeds: list[int], n: int) -> list[int]:
    """``std::seed_seq(seeds).generate`` of ``n`` uint32 values."""
    v = [s & _M32 for s in seeds]
    s = len(v)
    out = [0x8B8B8B8B] * n
    if n == 0:
        return out
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(out[k % n] ^ out[(k + p) % n] ^ out[(k - 1) % n])) & _M32
        if k == 0:
            r2 = (r1 + s) & _M32
        elif k <= s:
            r2 = (r1 + k % n + v[k - 1]) & _M32
        else:
            r2 = (r1 + k % n) & _M32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _M32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _M32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((out[k % n] + out[(k + p) % n] + out[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


def _block_bits(max_index: int) -> int:
    w = math.ceil(math.log2(max_index))
    return max(w + w % 2, 16)


def _cipher(max_index: int, seed: int, rounds: int):
    """The block cipher of ``max_index``'s block on uint64 arrays."""
    if rounds % 2 or rounds <= 3:
        raise ValueError(f"rounds must be even and > 3, got {rounds}")
    h = _block_bits(max_index) // 2
    mask = np.uint64((1 << h) - 1)
    sh = [np.uint64(b) for b in (h, 1, 2, 8, h - 1, h - 2, h - 8)]
    keys = [np.uint64(k) & mask for k in seed_seq_generate([seed], rounds)]

    def rotl(v, r, back):
        return ((v << r) | (v >> back)) & mask

    def f(v):
        return rotl(v, sh[2], sh[5]) ^ (rotl(v, sh[3], sh[6]) & rotl(v, sh[1], sh[4]))

    def encrypt(v):
        hi, lo = (v >> sh[0]) & mask, v & mask
        for i in range(0, rounds, 2):
            hi = hi ^ f(lo) ^ keys[i]
            lo = lo ^ f(hi) ^ keys[i + 1]
        return (hi << sh[0]) | lo

    return encrypt


@functools.lru_cache(maxsize=8)
def _small_permutation(max_index: int, seed: int, rounds: int) -> np.ndarray:
    """The whole permutation where the block is the least, 16 bits, and may
    be far wider than [0, max_index] (< 2^16): the cipher of every block value, then
    each one's first successor inside the range by pointer doubling, in the
    log of the walk's length instead of the walk."""
    nxt = _cipher(max_index, seed, rounds)(np.arange(1 << 16, dtype=np.uint64)).astype(np.int64)
    while (nxt[: max_index + 1] > max_index).any():
        # Every value strictly between a value and nxt of it lies outside.
        nxt = np.where(nxt > max_index, nxt[nxt], nxt)
    out = nxt[: max_index + 1].astype(np.uint64)
    out.setflags(write=False)
    return out


def index_shuffle_array(index, max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """``index_shuffle`` of every element of ``index`` (each in [0, max_index])."""
    x = np.array(index, dtype=np.uint64, copy=True)
    if max_index == 0:
        return np.zeros_like(x)
    if max_index < 1 << 16:
        return _small_permutation(max_index, seed, rounds)[x]
    # Wider blocks hold more than a quarter of their values in range: the
    # walk is short.
    encrypt = _cipher(max_index, seed, rounds)
    limit = np.uint64(max_index)
    todo = np.ones(x.shape, bool)
    while todo.any():
        x[todo] = encrypt(x[todo])
        todo = x > limit
    return x


def index_shuffle(index: int, max_index: int, seed: int, rounds: int = 4) -> int:
    """The position of ``index`` in a seeded permutation of [0, max_index]."""
    return int(index_shuffle_array(np.uint64(index), max_index, seed, rounds))
