"""Device (jax.numpy) Bloom-filter and exact-map query/update ops.

The hot call-phase loop of the genotyper (reference: main.cpp:487-500) is,
per distinct sample context k-mer: one context Bloom probe, one canonical
center hash, one rank-compressed counter scatter-add, and one exact-map
increment.  These ops implement that loop as batched gathers/scatters over
HBM-resident uint32 arrays so XLA can pipeline them.

Counter semantics mirror the host BF exactly: counters accumulate in
uint32 (read mod 2^16), indexed by rank(bit index) over the bit array.
"""

from __future__ import annotations

import numpy as np


def _jnp():
    import jax.numpy as jnp

    return jnp


def bloom_test(words, word_idx, bit):
    """Gather + bit-test: True where the addressed bit is set."""
    jnp = _jnp()
    w = jnp.take(words, word_idx, axis=0)
    return ((w >> bit.astype(jnp.uint32)) & jnp.uint32(1)).astype(bool)


def rank_counter_idx(words, rank, word_idx, bit):
    """(is_set, counter_index) for each query.

    rank is the per-word exclusive popcount cumsum (uint32); the counter
    index adds the popcount of the bits below the queried bit.
    """
    jnp = _jnp()
    from jax import lax

    w = jnp.take(words, word_idx, axis=0)
    bitu = bit.astype(jnp.uint32)
    is_set = ((w >> bitu) & jnp.uint32(1)).astype(bool)
    below = w & ((jnp.uint32(1) << bitu) - jnp.uint32(1))
    cnt_idx = jnp.take(rank, word_idx, axis=0) + lax.population_count(below)
    return is_set, cnt_idx.astype(jnp.int32)


def scatter_add_u32(counts, cnt_idx, vals, mask):
    """counts[cnt_idx] += vals where mask, duplicates accumulated.

    Masked-out entries are routed to an out-of-bounds index and dropped.
    """
    jnp = _jnp()
    n = counts.shape[0]
    idx = jnp.where(mask, cnt_idx, jnp.int32(n))
    return counts.at[idx].add(vals.astype(counts.dtype), mode="drop")


def bloom_set(words, word_idx, bit, mask=None):
    """Set bits (build path) via scatter-add, correct under duplicates.

    XLA has no scatter-OR, so: lexicographically sort the
    (word, bit) pairs (stable two-key lax.sort — no 37-bit packed key
    needed for large filters), drop exact duplicates, gather the current
    word and add only bits not already set.  Lanes where ``mask`` is
    False are routed out of bounds and dropped.
    """
    jnp = _jnp()
    from jax import lax

    n = words.shape[0]
    w = word_idx.astype(jnp.int32)
    if mask is not None:
        w = jnp.where(mask, w, jnp.int32(n))
    w_s, b_s = lax.sort((w, bit.astype(jnp.uint32)), num_keys=2)
    dup = jnp.concatenate(
        [jnp.zeros(1, bool), (w_s[1:] == w_s[:-1]) & (b_s[1:] == b_s[:-1])]
    )
    safe_w = jnp.minimum(w_s, n - 1)
    current = jnp.take(words, safe_w, axis=0)
    already = ((current >> b_s) & jnp.uint32(1)).astype(bool)
    add = jnp.where(dup | already, jnp.uint32(0), jnp.uint32(1) << b_s)
    return words.at[w_s].add(add, mode="drop")


def pack2bit_jax(kmers, k: int):
    """Pack pure-ACGT (N, k) ASCII uint8 rows into (N, ceil(k/16)) uint32,
    big-endian within words so row-tuple order == lexicographic order.
    Non-ACGT bytes map to code 3 (callers must pre-filter if that matters).
    """
    jnp = _jnp()
    # Arithmetic ACGT->0..3 (alphabetical order): c2 = (c>>1)&3 gives
    # A->0 C->1 G->3 T->2; XOR with its own bit1 swaps 2<->3.  No table
    # gather.  Non-ACGT bytes produce arbitrary codes —
    # callers only pack pure-ACGT canonical k-mers.
    c2 = ((kmers.astype(jnp.uint32)) >> 1) & jnp.uint32(3)
    codes = c2 ^ (c2 >> 1)
    nwords = (k + 15) // 16
    cols = []
    for w in range(nwords):
        acc = jnp.zeros(kmers.shape[0], dtype=jnp.uint32)
        for j in range(w * 16, min((w + 1) * 16, k)):
            acc = acc | (codes[:, j] << (2 * (15 - (j - w * 16))))
        cols.append(acc)
    return jnp.stack(cols, axis=1)


def searchsorted_rows(sorted_keys, queries):
    """Vectorized binary search of (N, W) uint32 query rows in a sorted
    (M, W) uint32 key matrix.  Returns (index, found)."""
    jnp = _jnp()
    from jax import lax

    m, w = sorted_keys.shape
    n = queries.shape[0]
    nbits = max(1, int(np.ceil(np.log2(max(m, 1) + 1))))

    def row_less(a_rows, b_rows):
        # lexicographic a < b over W uint32 columns
        less = jnp.zeros(a_rows.shape[0], dtype=bool)
        decided = jnp.zeros(a_rows.shape[0], dtype=bool)
        for j in range(w):
            less = less | (~decided & (a_rows[:, j] < b_rows[:, j]))
            decided = decided | (a_rows[:, j] != b_rows[:, j])
        return less

    lo = jnp.zeros(n, dtype=jnp.int32)
    hi = jnp.full(n, m, dtype=jnp.int32)

    def body(_, lh):
        lo, hi = lh
        mid = (lo + hi) >> 1
        mid_rows = jnp.take(sorted_keys, jnp.minimum(mid, m - 1), axis=0)
        go_right = row_less(mid_rows, queries)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
        return lo, hi

    lo, hi = lax.fori_loop(0, nbits + 1, body, (lo, hi))
    idx = jnp.minimum(lo, m - 1) if m > 0 else jnp.zeros(n, dtype=jnp.int32)
    if m == 0:
        return idx, jnp.zeros(n, dtype=bool)
    cand = jnp.take(sorted_keys, idx, axis=0)
    found = (lo < m) & jnp.all(cand == queries, axis=1)
    return idx, found
