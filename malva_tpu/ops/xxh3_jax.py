"""XXH3_64bits on device (jax.numpy), as uint32-pair arithmetic.

JAX runs with 64-bit types disabled by default, so every uint64 value is
carried as a (hi, lo) pair of uint32 arrays and the 64x64->128 multiplies
of XXH3 are built from 16-bit limb products.  Bit-exact parity
with the NumPy host implementation (malva_tpu.ops.xxh3) — and therefore
with the upstream C library — is enforced by tests across all supported
lengths (0..240 bytes; the pipeline uses k=35 and ref_k=43).

The public entry point :func:`xxh3_64_jax` takes an ``(N, L) uint8``
batch (static L) and returns the hashes as an ``(N, 2) uint32`` array
``[hi, lo]``; :func:`xxh3_mod_pow2shift` folds the Bloom-filter index
computation ``hash % (n_gib * 2^33)`` into uint32 ops.
"""

from __future__ import annotations

import numpy as np

from .xxh3 import (
    PRIME64_1,
    PRIME64_2,
    PRIME64_3,
    PRIME_MX1,
    PRIME_MX2,
    _sec32,
    _sec64,
)

U32 = None  # set lazily (jnp.uint32)


def _jnp():
    import jax.numpy as jnp

    global U32
    U32 = jnp.uint32
    return jnp


def _const(v64: int):
    """Host uint64 constant -> (hi, lo) python ints."""
    v64 = int(v64)
    return (v64 >> 32) & 0xFFFFFFFF, v64 & 0xFFFFFFFF


def _c(jnp, v64: int):
    hi, lo = _const(v64)
    return jnp.uint32(hi), jnp.uint32(lo)


# -- u64-as-pair primitives -------------------------------------------------


def _add(jnp, a, b):
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(jnp.uint32)
    return a[0] + b[0] + carry, lo


def _xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _shr(jnp, a, r: int):
    if r == 0:
        return a
    if r < 32:
        return a[0] >> r, (a[1] >> r) | (a[0] << (32 - r))
    if r == 32:
        return jnp.zeros_like(a[0]), a[0]
    return jnp.zeros_like(a[0]), a[0] >> (r - 32)


def _shl(jnp, a, r: int):
    if r == 0:
        return a
    if r < 32:
        return (a[0] << r) | (a[1] >> (32 - r)), a[1] << r
    if r == 32:
        return a[1], jnp.zeros_like(a[1])
    return a[1] << (r - 32), jnp.zeros_like(a[1])



def _mul32(jnp, a, b):
    """u32 x u32 -> u64 pair, via 16-bit limbs."""
    m16 = jnp.uint32(0xFFFF)
    a0 = a & m16
    a1 = a >> 16
    b0 = b & m16
    b1 = b >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> 16) + (p01 & m16) + (p10 & m16)
    lo = (p00 & m16) | (mid << 16)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def _mul64_lo(jnp, a, b):
    """low 64 bits of a*b."""
    hi, lo = _mul32(jnp, a[1], b[1])
    hi = hi + a[1] * b[0] + a[0] * b[1]
    return hi, lo


def _mul128(jnp, a, b):
    """full product: returns (hi64 pair, lo64 pair)."""
    ll = _mul32(jnp, a[1], b[1])
    lh = _mul32(jnp, a[1], b[0])
    hl = _mul32(jnp, a[0], b[1])
    hh = _mul32(jnp, a[0], b[0])
    mid1 = ll[0] + lh[1]
    c1 = (mid1 < ll[0]).astype(jnp.uint32)
    mid2 = mid1 + hl[1]
    c2 = (mid2 < mid1).astype(jnp.uint32)
    lo64 = (mid2, ll[1])
    hi64 = _add(jnp, hh, (jnp.uint32(0), lh[0]))
    hi64 = _add(jnp, hi64, (jnp.uint32(0), hl[0]))
    hi64 = _add(jnp, hi64, (jnp.uint32(0), c1 + c2))
    return hi64, lo64


def _mul128_fold(jnp, a, b):
    hi, lo = _mul128(jnp, a, b)
    return _xor(hi, lo)


def _rd64(jnp, g, off: int):
    """(hi, lo) little-endian u64 read at byte offset off; g(j) yields the
    j-th byte column as uint32 (matrix column or any broadcastable array)."""
    lo = g(off) | (g(off + 1) << 8) | (g(off + 2) << 16) | (g(off + 3) << 24)
    hi = g(off + 4) | (g(off + 5) << 8) | (g(off + 6) << 16) | (g(off + 7) << 24)
    return hi, lo


def _rd32(jnp, g, off: int):
    return g(off) | (g(off + 1) << 8) | (g(off + 2) << 16) | (g(off + 3) << 24)


def _bcast(jnp, const_pair, like):
    hi = jnp.full_like(like, const_pair[0])
    lo = jnp.full_like(like, const_pair[1])
    return hi, lo


def _avalanche3(jnp, h):
    h = _xor(h, _shr(jnp, h, 37))
    h = _mul64_lo(jnp, h, _c(jnp, int(PRIME_MX1)))
    h = _xor(h, _shr(jnp, h, 32))
    return h


def _avalanche64(jnp, h):
    h = _xor(h, _shr(jnp, h, 33))
    h = _mul64_lo(jnp, h, _c(jnp, int(PRIME64_2)))
    h = _xor(h, _shr(jnp, h, 29))
    h = _mul64_lo(jnp, h, _c(jnp, int(PRIME64_3)))
    h = _xor(h, _shr(jnp, h, 32))
    return h


def _rrmxmx(jnp, h, length: int):
    r49 = ((_shl(jnp, h, 49)[0] | _shr(jnp, h, 15)[0]), (_shl(jnp, h, 49)[1] | _shr(jnp, h, 15)[1]))
    r24 = ((_shl(jnp, h, 24)[0] | _shr(jnp, h, 40)[0]), (_shl(jnp, h, 24)[1] | _shr(jnp, h, 40)[1]))
    h = _xor(h, _xor(r49, r24))
    h = _mul64_lo(jnp, h, _c(jnp, int(PRIME_MX2)))
    h = _xor(h, _add(jnp, _shr(jnp, h, 35), _c_len(jnp, length, h)))
    h = _mul64_lo(jnp, h, _c(jnp, int(PRIME_MX2)))
    h = _xor(h, _shr(jnp, h, 28))
    return h


def _c_len(jnp, length: int, like):
    return (jnp.zeros_like(like[0]), jnp.full_like(like[1], np.uint32(length)))


def _mix16(jnp, g, in_off: int, sec_off: int):
    lo = _xor(_rd64(jnp, g, in_off), _c(jnp, int(_sec64(sec_off))))
    hi = _xor(_rd64(jnp, g, in_off + 8), _c(jnp, int(_sec64(sec_off + 8))))
    return _mul128_fold(jnp, lo, hi)


# -- length paths ----------------------------------------------------------


def _len17to128(jnp, g, length: int):
    acc = _bcast(jnp, _const((length * int(PRIME64_1)) & 0xFFFFFFFFFFFFFFFF), g(0))
    if length > 96:
        acc = _add(jnp, acc, _mix16(jnp, g, 48, 96))
        acc = _add(jnp, acc, _mix16(jnp, g, length - 64, 112))
    if length > 64:
        acc = _add(jnp, acc, _mix16(jnp, g, 32, 64))
        acc = _add(jnp, acc, _mix16(jnp, g, length - 48, 80))
    if length > 32:
        acc = _add(jnp, acc, _mix16(jnp, g, 16, 32))
        acc = _add(jnp, acc, _mix16(jnp, g, length - 32, 48))
    acc = _add(jnp, acc, _mix16(jnp, g, 0, 0))
    acc = _add(jnp, acc, _mix16(jnp, g, length - 16, 16))
    return _avalanche3(jnp, acc)


def _len129to240(jnp, g, length: int):
    acc = _bcast(jnp, _const((length * int(PRIME64_1)) & 0xFFFFFFFFFFFFFFFF), g(0))
    nb = length // 16
    for i in range(8):
        acc = _add(jnp, acc, _mix16(jnp, g, 16 * i, 16 * i))
    acc = _avalanche3(jnp, acc)
    for i in range(8, nb):
        acc = _add(jnp, acc, _mix16(jnp, g, 16 * i, 16 * (i - 8) + 3))
    acc = _add(jnp, acc, _mix16(jnp, g, length - 16, 136 - 17))
    return _avalanche3(jnp, acc)


def _len9to16(jnp, g, length: int):
    bf1 = int(_sec64(24) ^ _sec64(32))
    bf2 = int(_sec64(40) ^ _sec64(48))
    lo = _xor(_rd64(jnp, g, 0), _c(jnp, bf1))
    hi = _xor(_rd64(jnp, g, length - 8), _c(jnp, bf2))
    swapped = _swap64(jnp, lo)
    acc = _add(jnp, _c_len(jnp, length, lo), swapped)
    acc = _add(jnp, acc, hi)
    acc = _add(jnp, acc, _mul128_fold(jnp, lo, hi))
    return _avalanche3(jnp, acc)


def _swap64(jnp, a):
    return _swap32w(jnp, a[1]), _swap32w(jnp, a[0])


def _swap32w(jnp, x):
    return (
        ((x << 24) & jnp.uint32(0xFF000000))
        | ((x << 8) & jnp.uint32(0x00FF0000))
        | ((x >> 8) & jnp.uint32(0x0000FF00))
        | (x >> 24)
    )


def _len4to8(jnp, g, length: int):
    in1 = _rd32(jnp, g, 0)
    in2 = _rd32(jnp, g, length - 4)
    bf = int(_sec64(8) ^ _sec64(16))
    in64 = (in1, in2)  # input2 + (input1 << 32)
    keyed = _xor(in64, _c(jnp, bf))
    return _rrmxmx(jnp, keyed, length)


def _len1to3(jnp, g, length: int):
    c1 = g(0)
    c2 = g(length >> 1)
    c3 = g(length - 1)
    combined = (c1 << 16) | (c2 << 24) | c3 | jnp.uint32(length << 8)
    bitflip = np.uint32(int(_sec32(0)) ^ int(_sec32(4)))
    keyed = (jnp.zeros_like(combined), combined ^ bitflip)
    return _avalanche64(jnp, keyed)


def _dispatch(jnp, g, length: int):
    if length <= 3:
        return _len1to3(jnp, g, length)
    if length <= 8:
        return _len4to8(jnp, g, length)
    if length <= 16:
        return _len9to16(jnp, g, length)
    if length <= 128:
        return _len17to128(jnp, g, length)
    if length <= 240:
        return _len129to240(jnp, g, length)
    raise NotImplementedError("device XXH3 supports lengths <= 240")


def xxh3_64_jax(a):
    """XXH3_64bits of an (N, L) uint8 device batch; returns (N, 2) uint32
    [hi, lo].  Lengths 0..240 supported (hashLong is never hit by the
    genotyper's k/ref_k <= 240 contract)."""
    jnp = _jnp()
    n, length = a.shape
    if length == 0:
        from .xxh3 import xxh3_64_bytes

        v = xxh3_64_bytes(b"")
        return jnp.broadcast_to(
            jnp.array([_const(v)], dtype=jnp.uint32), (n, 2)
        )
    b = a.astype(jnp.uint32)
    hi, lo = _dispatch(jnp, lambda off: b[:, off], length)
    return jnp.stack([hi, lo], axis=1)


def xxh3_64_cols(cols):
    """XXH3_64bits over byte COLUMNS: cols[j] is the j-th byte of every
    lane (any common shape, uint8/uint32).  Returns (hi, lo) arrays of the
    lanes' shape.  Columns keep the hash elementwise per lane, so XLA can
    fuse it with whatever produced the columns and no (N, L) matrix need
    be materialized."""
    jnp = _jnp()
    length = len(cols)
    cache = {}

    def g(off):
        if off not in cache:
            cache[off] = cols[off].astype(jnp.uint32)
        return cache[off]

    return _dispatch(jnp, g, length)


def xxh3_mod_size(h, size_bits: int):
    """hash % size_bits -> (word_index int32, bit int32).

    Supports the two layouts the pipeline uses: size = n_gib * 2^33 (the
    CLI's ``-b`` contract, n_gib <= 8) via :func:`xxh3_mod_gib`, and small
    power-of-two sizes (tests, sharded sub-filters) via masking.
    """
    jnp = _jnp()
    if size_bits >= (1 << 33) and size_bits % (1 << 33) == 0:
        return xxh3_mod_gib(h, size_bits >> 33)
    if size_bits & (size_bits - 1) or size_bits > (1 << 32) or size_bits < 32:
        raise ValueError(
            "device Bloom size must be N*2^33 (N<=8) or a power of two <= 2^32"
        )
    lo = h[:, 1]
    if size_bits == (1 << 32):
        idx = lo
    else:
        idx = lo & jnp.uint32(size_bits - 1)
    return (idx >> 5).astype(jnp.int32), (idx & jnp.uint32(31)).astype(jnp.int32)


def xxh3_mod_gib(h, n_gib: int):
    """hash % (n_gib * 2^33) -> (word_index int32, bit int32) for a uint32
    word-addressed Bloom bit array.

    Since the filter size is always n_gib * 2^33 bits (argument
    parser's ``-b`` contract), hash % size = ((hash >> 33) % n_gib)*2^33
    + (hash & (2^33-1)); the 64-bit modulo collapses to a 31-bit one.
    Requires n_gib <= 8 so that the word index fits int32.
    """
    jnp = _jnp()
    if n_gib > 8:
        raise ValueError("device Bloom filters support at most 8 GiB per shard")
    hi, lo = h[:, 0], h[:, 1]
    q = hi >> 1  # top 31 bits of the hash = hash >> 33
    qm = q % jnp.uint32(n_gib) if (n_gib & (n_gib - 1)) else q & jnp.uint32(n_gib - 1)
    low33_hi = hi & jnp.uint32(1)  # bit 32 of the low-33 remainder
    # word index = idx >> 5: top (28) bits from qm, then 33-5=28 bits of low33
    word = (qm << 28) | (low33_hi << 27) | (lo >> 5)
    bit = lo & jnp.uint32(31)
    return word.astype(jnp.int32), bit.astype(jnp.int32)
