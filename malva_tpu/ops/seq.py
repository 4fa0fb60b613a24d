"""Sequence byte ops: complement, canonical k-mers, 2-bit packing.

Replicates the observable semantics of the reference's canonicalization
(reference: bloom_filter.hpp:36-65, kmap.hpp:84-97) exactly:

* complement via the RCN table — only A/C/G/N/T (and a handful of
  lowercase entries, including the upstream quirk ``'g' -> 'G'``) are
  mapped; every other byte complements to NUL (0).  IUPAC ambiguity codes
  in real references (R, Y, S, W, ...) therefore turn into 0-bytes in the
  reverse complement, which is observable through hashing and map keys.
* canonical(kmer) = kmer if ``strcmp(kmer, revcomp(kmer)) < 0`` else
  revcomp(kmer).  Since the forward k-mer never contains NULs, strcmp over
  the terminated strings is equivalent to bytewise lexicographic
  comparison over the k bytes (first difference decides; the forward
  k-mer's byte at a position where the revcomp has NUL is always larger).

Host path is NumPy over ``(N, K) uint8`` batches; :func:`canonical_jax`
mirrors it in jax.numpy for on-device use.
"""

from __future__ import annotations

import numpy as np

# RCN complement table, extended to 256 entries (reference accesses only
# 0..127; bytes >= 128 would index negatively through a signed char in the
# reference — UB we define as 0 here).  bloom_filter.hpp:36-50.
RCN_TABLE = np.zeros(256, dtype=np.uint8)
for _src, _dst in [
    ("A", "T"), ("C", "G"), ("G", "C"), ("N", "N"), ("T", "A"),
    ("a", "T"), ("c", "G"), ("g", "G"),  # 'g'->'G' is an upstream quirk, kept
    ("n", "N"), ("t", "A"),
]:
    RCN_TABLE[ord(_src)] = ord(_dst)

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a") : ord("z") + 1] = np.arange(ord("A"), ord("Z") + 1, dtype=np.uint8)

# 2-bit encoding for pure-ACGT k-mers: A=0, C=1, G=2, T=3 (preserves ASCII
# order, so integer comparison of packed k-mers == lexicographic ASCII
# comparison — the property the canonical rule depends on).
CODE_TABLE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    CODE_TABLE[ord(_b)] = _i
DECODE_TABLE = np.frombuffer(b"ACGT", dtype=np.uint8)


def upper(a: np.ndarray) -> np.ndarray:
    """ASCII-uppercase a uint8 array (mirrors ::toupper over A-Za-z)."""
    return _UPPER[a]


def revcomp(kmers: np.ndarray) -> np.ndarray:
    """Reverse complement of each row of an (N, K) uint8 batch."""
    return RCN_TABLE[kmers][:, ::-1]


def _lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rowwise lexicographic a < b for (N, K) uint8 arrays."""
    n, k = a.shape
    less = np.zeros(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    for j in range(k):
        aj = a[:, j]
        bj = b[:, j]
        less |= ~decided & (aj < bj)
        decided |= aj != bj
    return less


def canonical(kmers: np.ndarray) -> np.ndarray:
    """Canonical form of each row: min(kmer, revcomp(kmer)) per strcmp.

    Matches BF::_canonical (bloom_filter.hpp:58-65): the reverse complement
    wins ties (strcmp == 0 keeps the computed revcomp, which then equals
    the forward k-mer bytewise anyway).
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 2 and kmers.size:
        from ..utils import native

        out = native.canonical(kmers)
        if out is not None:
            return out
    rc = revcomp(kmers)
    keep_fwd = _lex_less(kmers, rc)
    return np.where(keep_fwd[:, None], kmers, rc)


def truncate_at_nul(keys: np.ndarray) -> np.ndarray:
    """Zero every byte at/after the first NUL in each row.

    KMAP keys are built with ``std::string kmer_string(ckmer)`` from a
    C-string (kmap.hpp:95), so a canonical form containing NUL (from a
    non-ACGTN byte) is truncated.  The padded-with-zeros fixed-width
    representation of the truncated string is unique, so zero-filling the
    tail is an exact model of the reference's key.
    """
    keys = np.asarray(keys, dtype=np.uint8)
    if keys.ndim == 2 and keys.size:
        from ..utils import native

        out = native.truncate_nul(keys)
        if out is not None:
            return out
    nul = keys == 0
    seen = np.cumsum(nul, axis=1) > 0
    out = keys.copy()
    out[seen] = 0
    return out


def pack_2bit(kmers: np.ndarray) -> np.ndarray:
    """Pack pure-ACGT (N, K) uint8 ASCII rows into (N, ceil(K/32)) uint64.

    Base j of a row lands in word j//32 at bit position 2*(31 - j%32), i.e.
    most-significant-first within each word and words ordered left to
    right, so that comparing the uint64 tuple (word0, word1, ...) orders
    rows exactly like ASCII lexicographic comparison of the k-mers.
    Rows containing non-ACGT bytes are the caller's responsibility (use
    :func:`is_acgt`).
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    n, k = kmers.shape
    if kmers.size:
        from ..utils import native

        out = native.pack2bit(kmers)
        if out is not None:
            return out
    codes = CODE_TABLE[kmers].astype(np.uint64)
    nwords = (k + 31) // 32
    out = np.zeros((n, nwords), dtype=np.uint64)
    for j in range(k):
        w = j // 32
        shift = np.uint64(2 * (31 - (j % 32)))
        out[:, w] |= codes[:, j] << shift
    return out


def unpack_2bit(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_2bit` back to (N, K) ASCII uint8."""
    packed = np.asarray(packed, dtype=np.uint64)
    n = packed.shape[0]
    if packed.size:
        from ..utils import native

        out = native.unpack2bit(packed, k)
        if out is not None:
            return out
    out = np.empty((n, k), dtype=np.uint8)
    for j in range(k):
        w = j // 32
        shift = np.uint64(2 * (31 - (j % 32)))
        out[:, j] = DECODE_TABLE[((packed[:, w] >> shift) & np.uint64(3)).astype(np.intp)]
    return out


def is_acgt(kmers: np.ndarray) -> np.ndarray:
    """Rowwise mask: True where every byte is one of A/C/G/T."""
    return (CODE_TABLE[kmers] != 255).all(axis=1)


# ---------------------------------------------------------------------------
# jax.numpy mirrors (device path)
# ---------------------------------------------------------------------------


def complement_jax(kmers):
    """RCN complement as an arithmetic select chain.

    A chain of elementwise compares/selects instead of a byte-table
    gather, so it fuses with the surrounding arithmetic.  Matches
    RCN_TABLE exactly (incl. lowercase quirks and
    0 for everything else).
    """
    import jax.numpy as jnp

    c = kmers
    out = jnp.zeros_like(c)
    for src, dst in [
        (b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"N", b"N"), (b"T", b"A"),
        (b"a", b"T"), (b"c", b"G"), (b"g", b"G"), (b"n", b"N"), (b"t", b"A"),
    ]:
        out = jnp.where(c == src[0], jnp.uint8(dst[0]), out)
    return out


def canonical_jax(kmers):
    """jnp mirror of :func:`canonical` for (N, K) uint8 device arrays."""
    import jax.numpy as jnp

    rc = complement_jax(kmers)[:, ::-1]
    k = kmers.shape[1]
    less = jnp.zeros(kmers.shape[0], dtype=bool)
    decided = jnp.zeros(kmers.shape[0], dtype=bool)
    for j in range(k):
        aj = kmers[:, j]
        bj = rc[:, j]
        less = less | (~decided & (aj < bj))
        decided = decided | (aj != bj)
    return jnp.where(less[:, None], kmers, rc)
