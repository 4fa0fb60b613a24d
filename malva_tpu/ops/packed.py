"""Column math on 2-bit packed k-mers, as jax.numpy uint32 arrays.

Packed layout = ops.bloom_jax.pack2bit_jax: 16 bases per uint32 word,
base 0 in the TOP 2 bits, so uint32 tuple comparison == ASCII strcmp
(A=0 < C=1 < G=2 < T=3 preserves ASCII order).  A packed sequence is a
list of (N,) uint32 word columns; every helper is elementwise per lane,
so XLA fuses a whole chain of them into one kernel.
"""

from __future__ import annotations

import jax.numpy as jnp

from .xxh3_jax import xxh3_64_cols


def _decode_byte_cols(words, n_bases: int):
    """ASCII byte columns (uint32) of an n_bases-long packed sequence."""
    cols = []
    for j in range(n_bases):
        w = words[j // 16]
        sh = 2 * (15 - (j % 16))
        c = (w >> sh) & jnp.uint32(3) if sh else w & jnp.uint32(3)
        b = (
            jnp.uint32(65)
            + (c << 1)
            + jnp.where(c == 2, jnp.uint32(2), jnp.uint32(0))
            + jnp.where(c == 3, jnp.uint32(13), jnp.uint32(0))
        )
        cols.append(b)
    return cols


def _rev2bit(x):
    """Reverse the 16 2-bit groups of each uint32."""
    m2 = jnp.uint32(0x33333333)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    m4 = jnp.uint32(0x0F0F0F0F)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return (x << 16) | (x >> 16)


def _extract_subpacked(words, off: int, k: int):
    """Packed words of the length-k subsequence starting at base off."""
    w_k = (k + 15) // 16
    s = 2 * (off % 16)
    a0 = off // 16
    out = []
    for i in range(w_k):
        w1 = words[a0 + i] if a0 + i < len(words) else None
        w2 = words[a0 + i + 1] if a0 + i + 1 < len(words) else None
        if s == 0:
            v = w1
        else:
            v = w1 << s
            if w2 is not None:
                v = v | (w2 >> (32 - s))
        out.append(v)
    tail = k - 16 * (w_k - 1)
    if tail < 16:
        mask = jnp.uint32((((1 << (2 * tail)) - 1) << (32 - 2 * tail)) & 0xFFFFFFFF)
        out[-1] = out[-1] & mask
    return out


def _revcomp_packed(words, k: int):
    """Reverse complement of a k-base packed-word sequence (pure ACGT:
    complement code = code ^ 3)."""
    w_k = len(words)
    comp = []
    for i, w in enumerate(words):
        nb = min(16, k - 16 * i)
        m = jnp.uint32((((1 << (2 * nb)) - 1) << (32 - 2 * nb)) & 0xFFFFFFFF)
        comp.append(w ^ m)
    v = [_rev2bit(comp[w_k - 1 - i]) for i in range(w_k)]
    t = 2 * (16 * w_k - k)  # garbage-base lead to shift out (0..30)
    if t == 0:
        return v
    out = []
    for i in range(w_k):
        x = v[i] << t
        if i + 1 < w_k:
            x = x | (v[i + 1] >> (32 - t))
        out.append(x)
    return out


def _lex_min_packed(a, b):
    """Per-lane lexicographic min of two packed-word tuples (+ the strcmp
    tie rule: ties keep b, matching seq.canonical — equal either way)."""
    less = jnp.zeros(a[0].shape, dtype=jnp.bool_)
    decided = jnp.zeros(a[0].shape, dtype=jnp.bool_)
    for i in range(len(a)):
        less = less | (~decided & (a[i] < b[i]))
        decided = decided | (a[i] != b[i])
    return [jnp.where(less, a[i], b[i]) for i in range(len(a))]


def center_hash(rows, k: int, ref_k: int):
    """Call-step front end for packed canonical contexts ((M, wc) uint32):
    the centered k-mer is canonicalized in 2-bit space and hashed with
    XXH3 over its ASCII form.  -> (hash_hi, hash_lo, packed canonical
    center (M, ceil(k/16)))."""
    cols = [rows[:, j] for j in range(rows.shape[1])]
    cen = _extract_subpacked(cols, (ref_k - k) // 2, k)
    can = _lex_min_packed(cen, _revcomp_packed(cen, k))
    ch, cl = xxh3_64_cols(_decode_byte_cols(can, k))
    return ch, cl, jnp.stack(can, axis=1)


def context_hash(rows, ref_k: int):
    """XXH3 of packed context rows ((M, wc) uint32) -> (hash_hi, hash_lo)."""
    cols = [rows[:, j] for j in range(rows.shape[1])]
    return xxh3_64_cols(_decode_byte_cols(cols, ref_k))
