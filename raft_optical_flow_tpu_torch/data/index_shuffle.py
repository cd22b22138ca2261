"""grain's `index_shuffle`: the position of an index in a pseudorandom
permutation of [0, max_index], computed for one index at a time without
drawing the whole permutation. An own copy of what grain's C++ library
(`index_shuffle/libindex_shuffle.so`, reached through
`grain.python.IndexSampler` and `MapDataset.shuffle`) computes, so that the
port's loader visits the records in grain's order without importing grain:

    index_shuffle(i, max_index=n - 1, seed=(seed + epoch) % 2**32, rounds=4)

The algorithm, as that library runs it:
  - keys: `rounds` 32-bit words of `std::seed_seq{seed}.generate(...)`
    (the C++ standard's seed_seq, [rand.util.seedseq]);
  - a block of width ceil(log2(max_index)) bits, made even, at least 16
    (max_index 0 gives 0);
  - the Simon block cipher on that block: two halves of w/2 bits, and per
    key pair left ^= f(right) ^ k0, right ^= f(left) ^ k1, where
    f(x) = (rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2) within w/2 bits and each
    key is cut to its low w/2 bits;
  - cycle walking: encrypt again while the value exceeds max_index.

grain's pure-Python `index_shuffle_python.py` (md5-based) gives another
permutation; the C++ one is what `IndexSampler` uses.

`index_shuffle` takes one index or a numpy array of them (a whole epoch at
once: 22,872 records of FlyingChairs in a few milliseconds). At the
smallest block (16 bits) a small max_index makes the walks long (about
65536 / (max_index + 1) encryptions each), so there the whole block is
encrypted once and the walks are followed by pointer doubling over it.
"""

from __future__ import annotations

import functools
import math
from typing import List, Union

import numpy as np

_M32 = 0xFFFFFFFF
MIN_BLOCK_BITS = 16


def seed_seq_generate(seeds: List[int], n: int) -> List[int]:
    """`std::seed_seq(seeds).generate` of n 32-bit words."""
    if n == 0:
        return []
    b = [0x8B8B8B8B] * n
    v = [s & _M32 for s in seeds]
    s = len(v)
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _M32
        if k == 0:
            r2 = r1 + s
        elif k <= s:
            r2 = r1 + k % n + v[k - 1]
        else:
            r2 = r1 + k % n
        r2 &= _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def block_bits(max_index: int) -> int:
    """The cipher's block width for [0, max_index]: ceil(log2) of it (as a
    double, as the library computes it), made even, at least 16."""
    bits = math.ceil(math.log2(float(max_index)))
    return max(bits + bits % 2, MIN_BLOCK_BITS)


def _rotl(x: np.ndarray, r: int, half: int, mask: np.uint64) -> np.ndarray:
    r %= half
    if r == 0:
        return x
    return ((x << np.uint64(r)) | (x >> np.uint64(half - r))) & mask


def simon_encrypt(x: np.ndarray, keys: List[int], half: int) -> np.ndarray:
    """The Simon rounds on blocks x (uint64) of 2 * half bits."""
    mask = np.uint64((1 << half) - 1)
    left, right = (x >> np.uint64(half)) & mask, x & mask

    def f(z):
        return (_rotl(z, 1, half, mask) & _rotl(z, 8, half, mask)) ^ _rotl(z, 2, half, mask)

    for i in range(0, len(keys), 2):
        left = left ^ f(right) ^ (np.uint64(keys[i]) & mask)
        right = right ^ f(left) ^ (np.uint64(keys[i + 1]) & mask)
    return (left << np.uint64(half)) | right


@functools.lru_cache(maxsize=8)
def _walked_block(max_index: int, keys: tuple, half: int) -> np.ndarray:
    """For every value x of the block, where its walk ends: the first of
    E(x), E(E(x)), ... within [0, max_index] (E the cipher)."""
    every = np.arange(1 << (2 * half), dtype=np.uint64)
    enc = simon_encrypt(every, list(keys), half)
    # jump[y]: y itself once in range, else its encryption. A walk from x
    # ends at the latest back at x (E is a permutation), so within 2**(2 *
    # half) steps: as many doublings of the jumps reach every walk's end.
    jump = np.where(every > np.uint64(max_index), enc, every).astype(np.int64)
    for _ in range(2 * half):
        jump = jump[jump]
    return jump[enc.astype(np.int64)].astype(np.uint64)


def index_shuffle(index: Union[int, np.ndarray], max_index: int, seed: int,
                  rounds: int = 4) -> Union[int, np.ndarray]:
    """The position of `index` (an int, or an array of them) in the
    permutation of [0, max_index] that grain's C++ `index_shuffle` gives for
    `seed` and `rounds` (even, at least 4)."""
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4, got {rounds}")
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    scalar = np.ndim(index) == 0
    x = np.array(index, dtype=np.uint64, ndmin=1)
    if max_index == 0:
        out = np.zeros_like(x)
    else:
        keys = seed_seq_generate([seed], rounds)
        half = block_bits(max_index) // 2
        if 2 * half == MIN_BLOCK_BITS:
            # the cipher reads the block's low bits only
            block = _walked_block(max_index, tuple(keys), half)
            out = block[(x & np.uint64(0xFFFF)).astype(np.int64)]
            return int(out[0]) if scalar else out.astype(np.int64)
        out = simon_encrypt(x, keys, half)
        walk = out > np.uint64(max_index)
        while walk.any():  # cycle walking back into [0, max_index]
            out[walk] = simon_encrypt(out[walk], keys, half)
            walk = out > np.uint64(max_index)
    return int(out[0]) if scalar else out.astype(np.int64)
