"""Device-resident index + the fused call-phase query/update step.

This is the device materialization of the genotyper's hot loop D (reference:
main.cpp:487-500, SURVEY.md §3.5): for every distinct canonical sample
context k-mer, probe the context Bloom filter, canonicalize + hash the
centered k-mer, scatter-add its count into the rank-compressed alt-allele
counter array (unless the context is a known reference context), and
scatter-add into the exact reference-allele map.

Layout choices (each random access into a GiB-sized table costs about
one memory transaction whatever the row width, so rows carry everything
a lane needs):

* the Bloom word and its rank (exclusive popcount cumsum) are interleaved
  into one (W, 2) uint32 array so the counter path costs ONE gather;
* the exact map is a 4-way bucketized hash table addressed by the same
  XXH3 hash the Bloom probe computes — one gather per query instead of a
  log2(M)-step binary search (see index.kmap_table).

The step is a single jitted function over batched arrays; results are
bit-identical to the host path (enforced by tests) because all arithmetic
is the same uint32 math.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..ops import seq
from ..ops.bloom_jax import pack2bit_jax, scatter_add_u32
from ..ops.xxh3_jax import xxh3_64_jax, xxh3_mod_size
from ..utils.config import Config


def pack2bit_u32_np(kmers: np.ndarray, k: int) -> np.ndarray:
    """Host mirror of ops.bloom_jax.pack2bit_jax layout: (N, ceil(k/16))
    uint32, 16 bases per word, big-endian within the word."""
    table = np.full(256, 3, dtype=np.uint32)
    for i, ch in enumerate(b"ACGT"):
        table[ch] = i
    codes = table[kmers]
    nwords = (k + 15) // 16
    out = np.zeros((kmers.shape[0], nwords), dtype=np.uint32)
    for j in range(k):
        w = j // 16
        out[:, w] |= codes[:, j] << np.uint32(2 * (15 - (j % 16)))
    return out


def device_map_keys(index, cfg: Config) -> list:
    """Exact-map keys that can match device-side sample queries: pure-ACGT,
    full k length (sample contexts are pure ACGT; truncated/IUPAC keys can
    never equal a sample center and keep their counts on host)."""
    keys = [kb for kb in index.ref_bf.kmers if len(kb) == cfg.k]
    if keys:
        arr = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(-1, cfg.k)
        ok = seq.is_acgt(arr)
        keys = [kb for kb, good in zip(keys, ok.tolist()) if good]
    return keys


# The rank column's top 4 bits double as a per-row mini-Bloom filter over
# the exact-map keys ("does any kmap key hash to this Bloom word?"), so the
# call step can skip the bucket gather for the vast majority of lanes.
# Usable whenever the filter's total popcount fits 28 bits (always, in
# practice — popcount == number of distinct alt-allele k-mers).
RANK_BITS = 28
RANK_MASK = (1 << RANK_BITS) - 1


def _minifilter_slot_np(h: np.ndarray) -> np.ndarray:
    """Which of the 4 mini-filter bits a key occupies: hash bits 60-61
    (statistically independent of the low bits that pick word/bit)."""
    return ((h >> np.uint64(60)) & np.uint64(3)).astype(np.uint32)


@dataclass
class DeviceIndex:
    """Arrays for the call-phase step, all device-resident under jit."""

    bf_packed: Any   # (W, 2) uint32: [word, rank(+minifilter in top 4 bits)]
    bf_counts: Any   # (popcount,) uint32
    ctx_words: Any   # (W,) uint32
    kmap_keys: Any   # (n_buckets, 4*Wk) uint32
    kmap_vals: Any   # (n_buckets*4,) uint32
    size_bits: int
    k: int
    ref_k: int
    n_buckets: int
    table: Any       # host BucketTable (for write_back)
    minifilter: bool = False

    @classmethod
    def from_host(cls, index, cfg: Config) -> "DeviceIndex":
        """Build the device-resident index with a SPARSE upload: only the
        nonzero Bloom/context words (and mini-filter words) cross
        host->device; the dense word arrays, the popcount rank, and the
        word+rank interleave are all computed ON DEVICE.  At any
        realistic fill this cuts the transfer from the full 3 GiB (-b 1)
        to ~12 B per nonzero word."""
        import jax.numpy as jnp

        from .kmap_table import BucketTable
        from ..ops.xxh3 import xxh3_64

        assert index.bf.mode, "switch_mode must have run"
        words = index.bf.words
        W = words.shape[0]
        n_counts = len(index.bf.counts)
        assert n_counts < (1 << 32)

        table = BucketTable(device_map_keys(index, cfg), cfg.k)
        table.set_vals_from(index.ref_bf.kmers)

        minifilter = n_counts < (1 << RANK_BITS)
        mf_nz = np.zeros(0, dtype=np.int32)
        mf_val = np.zeros(0, dtype=np.uint32)
        if minifilter:
            keys = [kb for kb in table.slot_keys if kb is not None]
            if keys:
                mf = np.zeros(W, dtype=np.uint32)
                arr = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(-1, cfg.k)
                h = xxh3_64(arr)
                idx = h % np.uint64(cfg.bf_size)
                word = (idx >> np.uint64(5)).astype(np.int64)
                slot = _minifilter_slot_np(h)
                np.bitwise_or.at(mf, word, np.uint32(1) << slot)
                mf_nz = np.flatnonzero(mf).astype(np.int32)
                mf_val = mf[mf_nz]

        w_nz = np.flatnonzero(words).astype(np.int32)
        c_nz = np.flatnonzero(index.context_bf.words).astype(np.int32)
        densify = _make_densify(W, RANK_BITS)
        bf_packed, ctx_words = densify(
            jnp.asarray(w_nz), jnp.asarray(words[w_nz]),
            jnp.asarray(mf_nz), jnp.asarray(mf_val),
            jnp.asarray(c_nz), jnp.asarray(index.context_bf.words[c_nz]),
        )
        counts = index.bf.counts
        if counts.any():
            bf_counts = jnp.asarray(counts)
        else:  # pre-call counters are all zero: create on device
            bf_counts = jnp.zeros(n_counts, dtype=jnp.uint32)

        return cls(
            bf_packed=bf_packed,
            bf_counts=bf_counts,
            ctx_words=ctx_words,
            kmap_keys=jnp.asarray(table.bucket_keys),
            kmap_vals=jnp.asarray(table.vals),
            size_bits=cfg.bf_size,
            k=cfg.k,
            ref_k=cfg.ref_k,
            n_buckets=table.n_buckets,
            table=table,
            minifilter=minifilter,
        )

    def write_back(self, index) -> None:
        """Fold device counter state back into the host index."""
        # np.array (not asarray): jax arrays view as read-only numpy, but
        # the host counters must stay writable (batch mode zeroes them)
        index.bf.counts = np.array(self.bf_counts)
        self.table.write_back(np.asarray(self.kmap_vals), index.ref_bf.kmers)


@functools.lru_cache(maxsize=None)
def _make_densify(W: int, rank_bits: int):
    """Device-side densify of the sparse index upload: scatter nonzero
    Bloom/context words, build the exclusive popcount rank (u32 cumsum —
    total set bits < 2^32 by BF's switch_mode contract), OR the
    mini-filter words into the rank's top bits, and interleave
    [word, rank] — everything the host used to upload dense."""
    import jax
    import jax.numpy as jnp

    def fn(w_idx, w_val, m_idx, m_val, c_idx, c_val):
        words = jnp.zeros(W, jnp.uint32).at[w_idx].set(w_val)
        pc = jax.lax.population_count(words)
        rank = jnp.cumsum(pc, dtype=jnp.uint32) - pc  # exclusive
        aux = rank.at[m_idx].add(m_val << jnp.uint32(rank_bits))
        bf_packed = jnp.stack([words, aux], axis=1)
        ctx_words = jnp.zeros(W, jnp.uint32).at[c_idx].set(c_val)
        return bf_packed, ctx_words

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def make_call_step(k: int, ref_k: int, size_bits: int, n_buckets: int,
                   minifilter: bool = False):
    """Build the jitted fused query/update step (full-batch variant).

    step(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals,
         contexts, counters) -> (bf_counts, kmap_vals)

    contexts: (B, ref_k) uint8 canonical sample k-mers; counters: (B,)
    uint32 (0 for padding rows — adding 0 is a no-op everywhere).
    ``minifilter`` must match how bf_packed was built (rank top bits
    carrying the exact-map mini-filter, see DeviceIndex.from_host).
    """
    import jax
    import jax.numpy as jnp

    from .kmap_table import probe_bucket_table

    off = (ref_k - k) // 2
    w_k = (k + 15) // 16

    @jax.jit
    def step(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals, contexts, counters):
        ctx_hash = xxh3_64_jax(contexts)
        cw, cb = xxh3_mod_size(ctx_hash, size_bits)
        wv = jnp.take(ctx_words, cw, axis=0)
        ctx_known = ((wv >> cb.astype(jnp.uint32)) & jnp.uint32(1)).astype(bool)

        centers = contexts[:, off : off + k]
        centers_canon = seq.canonical_jax(centers)
        ch = xxh3_64_jax(centers_canon)
        bw, bb = xxh3_mod_size(ch, size_bits)
        row = jnp.take(bf_packed, bw, axis=0)  # (B, 2): word, rank
        word = row[:, 0]
        rank = row[:, 1] & jnp.uint32(RANK_MASK) if minifilter else row[:, 1]
        bbu = bb.astype(jnp.uint32)
        is_set = ((word >> bbu) & jnp.uint32(1)).astype(bool)
        below = word & ((jnp.uint32(1) << bbu) - jnp.uint32(1))
        cnt_idx = (rank + jax.lax.population_count(below)).astype(jnp.int32)
        upd = (~ctx_known) & is_set
        bf_counts = scatter_add_u32(bf_counts, cnt_idx, counters, upd)

        packed = pack2bit_jax(centers_canon, k)
        slot, found = probe_bucket_table(
            kmap_keys, n_buckets, w_k, packed, ch[:, 0], ch[:, 1]
        )
        kmap_vals = scatter_add_u32(kmap_vals, slot, counters, found)
        return bf_counts, kmap_vals

    return step


@functools.lru_cache(maxsize=None)
def make_call_step_compact(k: int, ref_k: int, size_bits: int, n_buckets: int,
                           batch: int, cap: int | None = None,
                           minifilter: bool = True):
    """Lane-compacted call step — same contract and bit-exact results as
    :func:`make_call_step`.

    The full step is bound by 5 full-batch random HBM accesses
    per k-mer (ctx gather, bf row gather, bucket gather, 2 scatters).  But
    almost every sample k-mer is "boring": not in the alt filter AND not an
    exact-map key, so only the mandatory bf-row gather is load-bearing.
    This variant:

    1. does the one mandatory gather (bf row: word + rank + mini-filter),
    2. sorts lane ids by interesting = is_set | kmap_candidate,
    3. finishes the interesting lanes with cap-sized accesses: ONE payload
       row-gather (everything a lane needs, packed u32), the context-word
       gather, the bucket gather, and one merged scatter into the combined
       [bf_counts | kmap_vals] state.

    If more than ``cap`` lanes are interesting the step falls back to the
    full-batch path via lax.cond, so results never depend on cap.

    ``batch`` is the static lane count; contexts must be (batch, ref_k).

    step(bf_packed, state, ctx_words, kmap_keys, contexts, counters)
      -> state,  where state = concat(bf_counts, kmap_vals) and the split
    point is state.size - kmap_vals.size (kmap_vals size is static:
    n_buckets * SLOTS).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from .kmap_table import SLOTS, bucket_pair_jax, probe_bucket_table

    off = (ref_k - k) // 2
    w_k = (k + 15) // 16
    if cap is None:
        cap = max(256, batch // 16)
    cap = min(cap, batch)
    kv_len = n_buckets * SLOTS

    @jax.jit
    def step(bf_packed, state, ctx_words, kmap_keys, contexts, counters):
        counts_len = state.shape[0] - kv_len
        centers_canon = seq.canonical_jax(contexts[:, off : off + k])
        ch = xxh3_64_jax(centers_canon)
        bw, bb = xxh3_mod_size(ch, size_bits)
        row = jnp.take(bf_packed, bw, axis=0)  # (B, 2): word, rank(+mf)
        word = row[:, 0]
        bbu = bb.astype(jnp.uint32)
        is_set = ((word >> bbu) & jnp.uint32(1)).astype(bool)
        rank = row[:, 1] & jnp.uint32(RANK_MASK) if minifilter else row[:, 1]
        below = word & ((jnp.uint32(1) << bbu) - jnp.uint32(1))
        cnt_idx = rank + jax.lax.population_count(below)

        if minifilter:
            mf = row[:, 1] >> jnp.uint32(RANK_BITS)
            mf_slot = (ch[:, 0] >> jnp.uint32(28)) & jnp.uint32(3)
            kmap_cand = ((mf >> mf_slot) & jnp.uint32(1)).astype(bool)
        else:
            kmap_cand = jnp.ones(batch, bool)
        if n_buckets <= 1:
            # tiny/empty tables: candidates are everything (probe is cheap)
            kmap_cand = jnp.ones(batch, bool)
        interesting = is_set | kmap_cand
        n_int = jnp.sum(interesting.astype(jnp.int32))

        # everything below is cheap elementwise work, shared by both paths
        ctx_hash = xxh3_64_jax(contexts)
        cw, cb = xxh3_mod_size(ctx_hash, size_bits)
        packed = pack2bit_jax(centers_canon, k)
        bucket, bucket2 = bucket_pair_jax(ch[:, 0], ch[:, 1], n_buckets)
        counters_u = counters.astype(jnp.uint32)

        def compact_path(state):
            key = (~interesting).astype(jnp.uint32)
            lane = jnp.arange(batch, dtype=jnp.int32)
            _, perm = lax.sort((key, lane), num_keys=1)
            sel = perm[:cap]

            flags = (
                is_set.astype(jnp.uint32)
                | (kmap_cand.astype(jnp.uint32) << 1)
                | (cb.astype(jnp.uint32) << 2)
            )
            payload = jnp.stack(
                [cnt_idx, counters_u, flags, cw.astype(jnp.uint32), bucket, bucket2]
                + [packed[:, j] for j in range(w_k)],
                axis=1,
            )
            p = jnp.take(payload, sel, axis=0)          # (cap, 6 + w_k) u32
            p_cnt, p_counter, p_flags = p[:, 0], p[:, 1], p[:, 2]
            p_set = (p_flags & jnp.uint32(1)).astype(bool)
            p_cand = ((p_flags >> jnp.uint32(1)) & jnp.uint32(1)).astype(bool)
            p_cb = p_flags >> jnp.uint32(2)
            p_cw = p[:, 3].astype(jnp.int32)
            p_bucket = p[:, 4]
            p_bucket2 = p[:, 5]
            p_packed = p[:, 6 : 6 + w_k]

            wv = jnp.take(ctx_words, p_cw, axis=0)
            ctx_known = ((wv >> p_cb) & jnp.uint32(1)).astype(bool)
            upd = p_set & ~ctx_known

            slot, found = probe_bucket_table(
                kmap_keys, n_buckets, w_k, p_packed, None, None,
                bucket=p_bucket, bucket2=p_bucket2,
            )
            # one merged scatter into [bf_counts | kmap_vals]
            idx = jnp.concatenate([
                jnp.where(upd, p_cnt.astype(jnp.int32), jnp.int32(state.shape[0])),
                jnp.where(found & p_cand, slot + counts_len, jnp.int32(state.shape[0])),
            ])
            vals = jnp.concatenate([p_counter, p_counter])
            return state.at[idx].add(vals, mode="drop")

        def full_path(state):
            wv = jnp.take(ctx_words, cw, axis=0)
            ctx_known = ((wv >> cb.astype(jnp.uint32)) & jnp.uint32(1)).astype(bool)
            upd = (~ctx_known) & is_set
            slot, found = probe_bucket_table(
                kmap_keys, n_buckets, w_k, packed, None, None,
                bucket=bucket, bucket2=bucket2,
            )
            idx = jnp.concatenate([
                jnp.where(upd, cnt_idx.astype(jnp.int32), jnp.int32(state.shape[0])),
                jnp.where(found & kmap_cand, slot + counts_len, jnp.int32(state.shape[0])),
            ])
            vals = jnp.concatenate([counters_u, counters_u])
            return state.at[idx].add(vals, mode="drop")

        return lax.cond(n_int <= cap, compact_path, full_path, state)

    return step


def packed64_to_u32(keys_u64: np.ndarray, ref_k: int) -> np.ndarray:
    """Counter-layout packed keys ((M, ceil(ref_k/32)) uint64, 32 bases per
    word big-endian) -> the device layout ((M, ceil(ref_k/16)) uint32, 16
    bases per word).  A pure bit-level split: u64 word j = u32 cols 2j,2j+1."""
    keys_u64 = np.ascontiguousarray(keys_u64)
    wc = (ref_k + 15) // 16
    m, w64 = keys_u64.shape
    out = np.empty((m, 2 * w64), dtype=np.uint32)
    out[:, 0::2] = (keys_u64 >> np.uint64(32)).astype(np.uint32)
    out[:, 1::2] = (keys_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.ascontiguousarray(out[:, :wc])


@functools.lru_cache(maxsize=None)
def make_call_step_packed(k: int, ref_k: int, size_bits: int, n_buckets: int,
                          batch: int, cap: int | None = None,
                          minifilter: bool = True, donate: bool | None = None,
                          seg_c: int | None = None):
    """Lane-compacted call step over 2-BIT PACKED contexts — bit-exact with
    :func:`make_call_step_compact` for pure-ACGT canonical contexts (the
    counter's output contract):

    * input traffic is wc*4 B/k-mer instead of ref_k bytes (and the
      counter already has the packed form — no unpack/repack roundtrip);
    * the front end (center canonicalization + center hash) is elementwise
      uint32 column math (ops.packed) that XLA fuses, so no byte matrix
      is built;
    * the state buffer is donated, so the merged counter scatter updates
      in place instead of copying the whole counter state per batch.

    step(bf_packed, state, ctx_words, kmap_keys, ctx_packed, counters)
      -> state.  ctx_packed: (batch, ceil(ref_k/16)) uint32.

    Compaction is SEGMENTED: the batch splits into rows of 16K lanes and
    each row sorts independently (one batched lax.sort along the minor
    axis).  Each row contributes its first T entries to the tail; a row
    with more than T interesting lanes is detected from the sorted keys
    themselves (entry T still interesting) and falls through to the next
    tier / full path, so results never depend on T.  Lanes are
    uniform-random w.r.t. row assignment, so at WGS fill P(row overflow
    at the working tier) is binomially negligible and the fallback is
    compile-time-only in practice.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from .kmap_table import SLOTS, bucket_pair_jax, probe_bucket_table
    from ..ops.packed import center_hash, context_hash

    if donate is None:
        donate = jax.default_backend() != "cpu"
    w_k = (k + 15) // 16
    wc = (ref_k + 15) // 16
    if cap is None:
        cap = max(256, batch // 16)
    cap = min(cap, batch)
    kv_len = n_buckets * SLOTS
    assert batch < (1 << 31), "sort key packs lane into 31 bits"
    if seg_c is None:
        seg_c = 16384 if (batch % 16384 == 0 and batch >= 32768) else batch
    assert batch % seg_c == 0
    segs = batch // seg_c

    def ctx_hash_rows(rows):
        """XXH3 of packed context rows ((M, wc) u32) -> (word, bit)."""
        return xxh3_mod_size(jnp.stack(context_hash(rows, ref_k), axis=1), size_bits)

    def step(bf_packed, state, ctx_words, kmap_keys, ctx_packed, counters):
        counts_len = state.shape[0] - kv_len
        # the context hash is NOT computed full-batch: only "interesting"
        # lanes (alt-filter hit or exact-map candidate) ever test the
        # context filter, so it is deferred to the cap-sized tail
        chh, chl, packed = center_hash(ctx_packed, k, ref_k)
        ch = jnp.stack([chh, chl], axis=1)
        bw, bb = xxh3_mod_size(ch, size_bits)
        row = jnp.take(bf_packed, bw, axis=0)  # (B, 2): word, rank(+mf)
        word = row[:, 0]
        bbu = bb.astype(jnp.uint32)
        is_set = ((word >> bbu) & jnp.uint32(1)).astype(bool)

        def row_fields(row_m, chh_m, bb_m):
            """(is_set, cnt_idx, kmap_cand) from gathered bf rows — used
            full-batch by the full path, tail-sized by the compact path."""
            w = row_m[:, 0]
            bbu_m = bb_m.astype(jnp.uint32)
            set_m = ((w >> bbu_m) & jnp.uint32(1)).astype(bool)
            rank = row_m[:, 1] & jnp.uint32(RANK_MASK) if minifilter else row_m[:, 1]
            below = w & ((jnp.uint32(1) << bbu_m) - jnp.uint32(1))
            cnt = rank + jax.lax.population_count(below)
            if minifilter and n_buckets > 1:
                mf = row_m[:, 1] >> jnp.uint32(RANK_BITS)
                mf_slot = (chh_m >> jnp.uint32(28)) & jnp.uint32(3)
                cand = ((mf >> mf_slot) & jnp.uint32(1)).astype(bool)
            else:
                cand = jnp.ones(row_m.shape[0], bool)
            return set_m, cnt, cand

        if minifilter and n_buckets > 1:
            mf = row[:, 1] >> jnp.uint32(RANK_BITS)
            mf_slot = (chh >> jnp.uint32(28)) & jnp.uint32(3)
            kmap_cand = ((mf >> mf_slot) & jnp.uint32(1)).astype(bool)
        else:
            kmap_cand = jnp.ones(batch, bool)
        interesting = is_set | kmap_cand
        counters_u = counters.astype(jnp.uint32)

        # segmented single-key sort: top bit = boring, low bits = lane
        # WITHIN the segment (consecutive, so per-row order == stable
        # global order restricted to the row).  seg_c <= 32768 fits a
        # uint16 key — half the sort bandwidth of u32.
        if seg_c <= (1 << 15):
            lane16 = jnp.broadcast_to(
                jnp.arange(seg_c, dtype=jnp.uint16)[None, :], (segs, seg_c))
            key = (((~interesting).astype(jnp.uint16) << 15).reshape(segs, seg_c)
                   | lane16)
            seg_sorted = lax.sort(key, dimension=1)
            flag_shift, lane_mask = 15, (1 << 15) - 1
            seg_base = (jnp.arange(segs, dtype=jnp.int32) * seg_c)[:, None]

            def tail_sel(t):
                local = (seg_sorted[:, :t] & jnp.uint16(lane_mask)).astype(jnp.int32)
                return (seg_base + local).reshape(-1)
        else:
            lane = jnp.arange(batch, dtype=jnp.uint32)
            key = (((~interesting).astype(jnp.uint32) << 31) | lane).reshape(
                segs, seg_c)
            seg_sorted = lax.sort(key, dimension=1)
            flag_shift = 31

            def tail_sel(t):
                return (seg_sorted[:, :t].reshape(-1)
                        & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
        # tail source: ctx words + counter in ONE row, so the tail pays a
        # single source gather (full-batch concat is a cheap linear copy)
        src_cat = jnp.concatenate(
            [ctx_packed, counters_u[:, None]], axis=1)      # (batch, wc+1)

        def make_compact_path(t: int):
            """Tail of segs * t lanes (every row fits t at call time, by
            the cond tree).  Boring filler lanes are exact no-ops: their
            is_set and kmap_cand flags are both false."""

            def compact_path(state):
                sel = tail_sel(t)

                # no payload matrix: the tail re-gathers its rows from
                # the SOURCE arrays (ctx+counter rows, bf rows) and
                # recomputes everything else — the full-batch part of the
                # step stays gather + flags + segmented sort only
                p = jnp.take(src_cat, sel, axis=0)          # (c, wc+1)
                p_ctx = p[:, :wc]
                p_counter = p[:, wc]

                p_chh, p_chl, p_packed = center_hash(p_ctx, k, ref_k)
                p_ch = jnp.stack([p_chh, p_chl], axis=1)
                p_bw, p_bb = xxh3_mod_size(p_ch, size_bits)
                p_row = jnp.take(bf_packed, p_bw, axis=0)       # (c, 2)
                p_set, p_cnt, p_cand = row_fields(p_row, p_chh, p_bb)
                p_bucket, p_bucket2 = bucket_pair_jax(p_chh, p_chl, n_buckets)

                # deferred context-filter test: hash only the tail lanes
                p_cw, p_cb = ctx_hash_rows(p_ctx)
                wv = jnp.take(ctx_words, p_cw, axis=0)
                ctx_known = ((wv >> p_cb.astype(jnp.uint32)) & jnp.uint32(1)).astype(bool)
                upd = p_set & ~ctx_known

                slot, found = probe_bucket_table(
                    kmap_keys, n_buckets, w_k, p_packed, None, None,
                    bucket=p_bucket, bucket2=p_bucket2,
                )
                idx = jnp.concatenate([
                    jnp.where(upd, p_cnt.astype(jnp.int32), jnp.int32(state.shape[0])),
                    jnp.where(found & p_cand, slot + counts_len, jnp.int32(state.shape[0])),
                ])
                vals = jnp.concatenate([p_counter, p_counter])
                return state.at[idx].add(vals, mode="drop")

            return compact_path

        def full_path(state):
            _, cnt_idx, _ = row_fields(row, chh, bb)
            cw, cb = ctx_hash_rows(ctx_packed)
            wv = jnp.take(ctx_words, cw, axis=0)
            ctx_known = ((wv >> cb.astype(jnp.uint32)) & jnp.uint32(1)).astype(bool)
            upd = (~ctx_known) & is_set
            bucket, bucket2 = bucket_pair_jax(chh, chl, n_buckets)
            slot, found = probe_bucket_table(
                kmap_keys, n_buckets, w_k, packed, None, None,
                bucket=bucket, bucket2=bucket2,
            )
            idx = jnp.concatenate([
                jnp.where(upd, cnt_idx.astype(jnp.int32), jnp.int32(state.shape[0])),
                jnp.where(found & kmap_cand, slot + counts_len, jnp.int32(state.shape[0])),
            ])
            vals = jnp.concatenate([counters_u, counters_u])
            return state.at[idx].add(vals, mode="drop")

        # tiered tails: every tail-sized access costs per row, so when few
        # lanes are interesting — the overwhelmingly common case at WGS
        # fill — a smaller per-row take halves the post-gather work again.
        # Results are identical for any sufficient tier; the tree picks
        # the smallest one.  "Row r fits t" is read straight off the
        # sorted keys: entry t of row r is boring (bit 31 set).
        t_cap = max(1, cap // segs)
        tiers = sorted({t_cap, max(64, t_cap // 2), max(64, t_cap // 4)})
        tiers = [t for t in tiers if t < seg_c]

        def fits(t: int):
            return jnp.all(
                (seg_sorted[:, t] >> seg_sorted.dtype.type(flag_shift))
                == seg_sorted.dtype.type(1))

        def dispatch(i, state):
            if i == len(tiers):
                # a whole-segment tail degenerates to full-batch work —
                # the plain full path is the cheaper implementation of it
                return full_path(state)
            return lax.cond(
                fits(tiers[i]), make_compact_path(tiers[i]),
                lambda s: dispatch(i + 1, s), state,
            )

        return dispatch(0, state)

    return jax.jit(step, donate_argnums=(1,)) if donate else jax.jit(step)


def ref_window_hashes(ref_chunk, k: int, ref_k: int, size_bits: int, chunk: int):
    """Window stage of the reference scan: for each of the chunk
    ref_k-windows of ref_chunk ((chunk + ref_k - 1,) uint8), the Bloom
    (word, bit) of its canonical centered k-mer and of the canonical
    window itself.  -> (center_word, center_bit, ctx_word, ctx_bit)."""
    import jax
    import jax.numpy as jnp

    off = (ref_k - k) // 2
    cols = [jax.lax.dynamic_slice(ref_chunk, (j,), (chunk,)) for j in range(ref_k)]
    win = jnp.stack(cols, axis=1)  # (chunk, ref_k)
    bw, bb = xxh3_mod_size(xxh3_64_jax(seq.canonical_jax(win[:, off : off + k])), size_bits)
    cw, cb = xxh3_mod_size(xxh3_64_jax(seq.canonical_jax(win)), size_bits)
    return bw, bb, cw, cb


def make_ref_scan_step(k: int, ref_k: int, size_bits: int, chunk: int):
    """Device version of the index-phase reference scan (hot loop C,
    main.cpp:382-401): for every ref_k-window of the reference whose
    centered k-mer hits the alt-allele filter, set the window's bit in the
    context filter.

    scan(bf_words, ctx_words, ref_chunk, n_valid) -> ctx_words
    ref_chunk: (chunk + ref_k - 1,) uint8, zero-padded at the tail;
    lanes >= n_valid are masked out exactly.
    """
    import jax
    import jax.numpy as jnp

    from ..ops.bloom_jax import bloom_set

    @jax.jit
    def scan(bf_words, ctx_words, ref_chunk, n_valid):
        bw, bb, cw, cb = ref_window_hashes(ref_chunk, k, ref_k, size_bits, chunk)
        wv = jnp.take(bf_words, bw, axis=0)
        hit = ((wv >> bb.astype(jnp.uint32)) & jnp.uint32(1)).astype(bool)
        hit = hit & (jnp.arange(chunk, dtype=jnp.int32) < n_valid)
        return bloom_set(ctx_words, cw, cb, mask=hit)

    return scan


def build_context_device(
    index, refs_used: list[np.ndarray], cfg: Config, chunk: int = 1 << 20,
):
    """Run the reference context scan on device, updating
    index.context_bf.words in place.  Equivalent to the host scan in
    pipeline.build_index."""
    import jax.numpy as jnp

    scan = make_ref_scan_step(cfg.k, cfg.ref_k, cfg.bf_size, chunk)

    # short contigs first, on host (their adds must precede the device
    # snapshot of the context words, or they would be overwritten below)
    for ref in refs_used:
        if len(ref) < cfg.ref_k:
            off = cfg.center_off
            if len(ref) > off:
                sub = ref[off : off + cfg.k][None, :]
                if index.bf.test_keys(sub)[0]:
                    index.context_bf.add_keys(ref[: cfg.ref_k][None, :])

    bf_words = jnp.asarray(index.bf.words)
    ctx_words = jnp.asarray(index.context_bf.words)
    for ref in refs_used:
        L = len(ref)
        if L < cfg.ref_k:
            continue
        n_pos = L - cfg.ref_k + 1
        for start in range(0, n_pos, chunk):
            n_valid = min(chunk, n_pos - start)
            piece = ref[start : start + chunk + cfg.ref_k - 1]
            if piece.shape[0] < chunk + cfg.ref_k - 1:
                piece = np.concatenate(
                    [piece, np.zeros(chunk + cfg.ref_k - 1 - piece.shape[0], np.uint8)]
                )
            ctx_words = scan(bf_words, ctx_words, jnp.asarray(piece), n_valid)
    index.context_bf.words = np.asarray(ctx_words)


def apply_sample_counts_device(
    index, contexts: np.ndarray, counters: np.ndarray, cfg: Config, batch: int = 1 << 20,
    dev: "DeviceIndex | None" = None,
) -> None:
    """Device equivalent of pipeline.apply_sample_counts: stream the
    distinct sample contexts through the fused step, then fold the counter
    state back into the host index.

    ``contexts`` is either (N, ref_k) uint8 ASCII or (N, ceil(ref_k/32))
    uint64 2-bit packed in the counter's layout (the counter hands the
    packed form straight through — no unpack/repack roundtrip, and the
    host->device upload is ref_k/4x smaller).

    Pass a prebuilt ``dev`` to reuse the uploaded index across samples
    (batch genotyping): only the counter state is fresh per call — the
    caller must have zeroed the host counters (pipeline._reset_counters),
    which makes the initial device state all-zeros."""
    apply_sample_counts_stream(
        index, iter([(contexts, counters)]), cfg, batch=batch, dev=dev
    )


# Scan chaining factor of the streaming step: SCAN_S sub-batches run
# inside ONE dispatch via lax.scan (dispatch + donation overhead
# amortizes; the H2D transfer batches up too).  The value is inherited,
# not yet measured on the H100.
SCAN_S = int(os.environ.get("MALVA_DEVICE_SCAN", "4"))


def make_call_step_scan(step_fn):
    """Wrap an UNJITTED make_call_step_packed step into a jitted lax.scan
    over (S, batch, wc) context / (S, batch) counter stacks.  Zero-counter
    sub-batches are exact no-ops, so callers pad partial stacks with
    zeros.  State is donated at the scan level."""
    import jax
    from jax import lax

    def scan_step(bf_packed, state, ctx_words, kmap_keys, ctx_s, cnt_s):
        def body(st, xs):
            ctx, cnt = xs
            return step_fn(bf_packed, st, ctx_words, kmap_keys, ctx, cnt), None

        st, _ = lax.scan(body, state, (ctx_s, cnt_s))
        return st

    return jax.jit(scan_step, donate_argnums=(1,))


def apply_sample_counts_stream(
    index, batches, cfg: Config, batch: int = 1 << 20,
    dev: "DeviceIndex | None" = None,
) -> None:
    """Streaming core of the device call phase: consume an iterator of
    (contexts, counters) batches (arbitrary sizes; uint64-packed or ASCII
    rows) with the counter state resident on device across the whole
    stream — the bounded-memory spill counter feeds its per-bucket output
    straight through here without the distinct set ever existing in RAM.

    ASCII rows containing non-ACGT bytes (possible only via external
    k-mer dumps) are collected and replayed through the exact host path
    after the device write-back (counter updates are commutative, so the
    ordering is unobservable).  The step's lane count is fixed by the
    first full buffer (one compile); SCAN_S sub-batches chain inside one
    dispatch (lax.scan), with partial stacks zero-padded (zero-counter
    lanes are exact no-ops).
    """
    import jax
    import jax.numpy as jnp

    from ..ops import seq

    if dev is None:
        dev = DeviceIndex.from_host(index, cfg)
        state = jnp.concatenate([dev.bf_counts, dev.kmap_vals])
    else:
        # reused device index: counter state restarts from the HOST
        # counters (dev's arrays hold the previous sample's counts)
        dev.table.set_vals_from(index.ref_bf.kmers)
        state = jnp.concatenate([
            jnp.asarray(index.bf.counts), jnp.asarray(dev.table.vals)
        ])

    wc = (cfg.ref_k + 15) // 16
    host_rows: list[tuple[np.ndarray, np.ndarray]] = []
    buf_k: list[np.ndarray] = []
    buf_c: list[np.ndarray] = []
    buf_n = 0
    step = None
    eff = None
    pend_k: list[np.ndarray] = []  # host sub-batches awaiting one dispatch
    pend_c: list[np.ndarray] = []
    inflight = None  # (device_ctx_stack, device_cnt_stack) uploaded ahead

    def to_packed(contexts, counters):
        nonlocal host_rows
        counters = np.asarray(counters).astype(np.uint32)
        if contexts.dtype == np.uint64:
            return packed64_to_u32(contexts, cfg.ref_k), counters
        ok = seq.is_acgt(contexts) if contexts.shape[0] else np.ones(0, bool)
        if not ok.all():
            host_rows.append((contexts[~ok], counters[~ok]))
            contexts, counters = contexts[ok], counters[ok]
        # external dumps may carry non-canonical k-mers; the host path
        # canonicalizes per probe, the packed step expects canonical input
        return pack2bit_u32_np(seq.canonical(contexts), cfg.ref_k), counters

    def dispatch_pending():
        """Upload the pending stack and run the previously uploaded one
        (double buffering at scan granularity)."""
        nonlocal state, inflight, pend_k, pend_c
        while len(pend_k) < SCAN_S:  # zero-counter pad: exact no-op
            pend_k.append(np.zeros((eff, wc), np.uint32))
            pend_c.append(np.zeros(eff, np.uint32))
        up = (jax.device_put(np.stack(pend_k)), jax.device_put(np.stack(pend_c)))
        pend_k, pend_c = [], []
        if inflight is not None:
            state = step(dev.bf_packed, state, dev.ctx_words, dev.kmap_keys, *inflight)
        inflight = up

    def run(chunk, cnts):
        nonlocal step, eff
        if step is None:
            eff = min(max(chunk.shape[0], 1), batch)
            inner = make_call_step_packed(
                cfg.k, cfg.ref_k, dev.size_bits, dev.n_buckets, eff,
                minifilter=dev.minifilter, donate=False,
            )
            step = make_call_step_scan(inner.__wrapped__)
        if chunk.shape[0] < eff:
            pad = eff - chunk.shape[0]
            chunk = np.concatenate([chunk, np.zeros((pad, wc), np.uint32)])
            cnts = np.concatenate([cnts, np.zeros(pad, np.uint32)])
        pend_k.append(chunk)
        pend_c.append(cnts)
        if len(pend_k) == SCAN_S:
            dispatch_pending()

    def drain_buffer(final: bool):
        nonlocal buf_k, buf_c, buf_n
        if buf_n == 0 and not final:
            return
        packed = (np.concatenate(buf_k) if len(buf_k) != 1 else buf_k[0]
                  ) if buf_k else np.zeros((0, wc), np.uint32)
        cnts = (np.concatenate(buf_c) if len(buf_c) != 1 else buf_c[0]
                ) if buf_c else np.zeros(0, np.uint32)
        buf_k, buf_c, buf_n = [], [], 0
        n = packed.shape[0]
        limit = eff if eff is not None else batch
        pos = 0
        while n - pos >= limit:
            run(packed[pos : pos + limit], cnts[pos : pos + limit])
            pos += limit
        if pos < n or (final and step is None):
            if final:
                run(packed[pos:], cnts[pos:])
            else:
                buf_k = [packed[pos:]]
                buf_c = [cnts[pos:]]
                buf_n = n - pos

    for contexts, counters in batches:
        pk, pc = to_packed(contexts, counters)
        if pk.shape[0]:
            buf_k.append(pk)
            buf_c.append(pc)
            buf_n += pk.shape[0]
        if buf_n >= batch:
            drain_buffer(final=False)
    drain_buffer(final=True)
    if pend_k:
        dispatch_pending()
    if inflight is not None:
        state = step(dev.bf_packed, state, dev.ctx_words, dev.kmap_keys, *inflight)

    counts_len = int(index.bf.counts.shape[0])
    dev.bf_counts, dev.kmap_vals = state[:counts_len], state[counts_len:]
    dev.write_back(index)

    if host_rows:
        from ..pipeline import apply_sample_counts

        for ctx, cnt in host_rows:
            apply_sample_counts(index, ctx, cnt, cfg)
