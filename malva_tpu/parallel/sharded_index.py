"""Hash-range-sharded device index + multi-chip call-phase step.

The answer to "the index does not fit one card's memory"
(SURVEY.md §2: sharded k-mer index; BASELINE.json north_star): the Bloom
bit/counter arrays and the exact map are split into contiguous hash
ranges, one range per device along mesh axis ``shard``.  Read-derived
k-mer batches stream in data-parallel (one slice per device) and are
all-gathered within the axis; each device resolves probes/updates that
land in its range, and the only cross-device dependency — "is this
context k-mer a known reference context?", whose bit may live on any
shard — is merged with a single boolean psum.  Counter updates then stay
entirely local to the owning shard (deterministic: uint32 adds are
commutative), and per-shard counter state concatenates back into exactly
the host layout.

Per-shard layouts mirror the single-chip ones (index.device): Bloom word
and local rank interleaved (one gather), exact map as a 4-way bucket
table addressed by the already-computed XXH3 (one gather), sharded by
contiguous bucket ranges.

Collectives used: all_gather (batch), psum (context membership bits) —
both ride ICI inside a pod slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from ..index.device import device_map_keys
from ..index.kmap_table import SLOTS, BucketTable, bucket_pair_jax
from ..ops import seq
from ..ops.bloom_jax import pack2bit_jax, scatter_add_u32
from ..ops.xxh3_jax import xxh3_64_jax, xxh3_mod_size
from ..utils.config import Config


@dataclass
class ShardedIndexState:
    bf_packed: Any     # (S, W/S, 2) uint32: [word, local rank]
    bf_counts: Any     # (S, Cmax) uint32, padded
    ctx_words: Any     # (S, W/S) uint32
    kmap_keys: Any     # (S, NB/S, 4*Wk) uint32
    kmap_vals: Any     # (S, NB/S * 4) uint32
    counts_len: list
    table: Any         # host BucketTable (global)
    n_shards: int
    n_buckets: int     # global bucket count
    size_bits: int


def shard_index(index, cfg: Config, n_shards: int) -> ShardedIndexState:
    """Split a host Index into n_shards contiguous hash ranges."""
    import jax.numpy as jnp

    S = n_shards
    words = index.bf.words
    W = words.shape[0]
    assert W % S == 0, "word count must divide evenly across shards"
    wps = W // S

    bf_words = words.reshape(S, wps)
    ctx_words = index.context_bf.words.reshape(S, wps)

    pc = np.bitwise_count(bf_words).astype(np.uint32)
    local_rank = np.zeros_like(pc)
    local_rank[:, 1:] = np.cumsum(pc, axis=1)[:, :-1].astype(np.uint32)
    bf_packed = np.stack([bf_words, local_rank], axis=2)

    per_shard = pc.sum(axis=1).astype(np.int64)
    cmax = max(1, int(per_shard.max()))
    counts = np.zeros((S, cmax), dtype=np.uint32)
    starts = np.concatenate([[0], np.cumsum(per_shard)])
    for s in range(S):
        counts[s, : per_shard[s]] = index.bf.counts[starts[s] : starts[s + 1]]

    # exact map: global bucket table split into contiguous bucket ranges
    # (min_buckets=S keeps n_buckets divisible — both are powers of two)
    table = BucketTable(device_map_keys(index, cfg), cfg.k, min_buckets=S)
    table.set_vals_from(index.ref_bf.kmers)
    nbps = table.n_buckets // S
    kk = table.bucket_keys.reshape(S, nbps, SLOTS * table.w)
    kv = table.vals.reshape(S, nbps * SLOTS)

    return ShardedIndexState(
        bf_packed=jnp.asarray(bf_packed),
        bf_counts=jnp.asarray(counts),
        ctx_words=jnp.asarray(ctx_words),
        kmap_keys=jnp.asarray(kk),
        kmap_vals=jnp.asarray(kv),
        counts_len=per_shard.tolist(),
        table=table,
        n_shards=S,
        n_buckets=table.n_buckets,
        size_bits=cfg.bf_size,
    )


def write_back(state: ShardedIndexState, index) -> None:
    counts = np.asarray(state.bf_counts)
    index.bf.counts = np.concatenate(
        [counts[s, : state.counts_len[s]] for s in range(state.n_shards)]
    )
    vals = np.asarray(state.kmap_vals).reshape(-1)
    state.table.write_back(vals, index.ref_bf.kmers)


def make_sharded_call_step(mesh, k: int, ref_k: int, size_bits: int, n_shards: int, n_buckets: int):
    """Jitted multi-device call step under shard_map.

    step(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals,
         contexts, counters) with index arrays sharded on axis 0 and the
    batch sharded on axis 0 (data parallel); returns updated
    (bf_counts, kmap_vals) shards.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    off = (ref_k - k) // 2
    w_k = (k + 15) // 16
    W_total = size_bits // 32
    wps = W_total // n_shards
    nbps = n_buckets // n_shards

    def step(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals, contexts, counters):
        bf_packed = bf_packed[0]
        bf_counts = bf_counts[0]
        ctx_words = ctx_words[0]
        kmap_keys = kmap_keys[0]
        kmap_vals = kmap_vals[0]

        my = jax.lax.axis_index("shard")

        # data-parallel batch: gather all slices (ICI all_gather)
        contexts = jax.lax.all_gather(contexts, "shard", axis=0, tiled=True)
        counters = jax.lax.all_gather(counters, "shard", axis=0, tiled=True)

        # context membership: probe local range, merge bits across shards
        ctx_hash = xxh3_64_jax(contexts)
        cw, cb = xxh3_mod_size(ctx_hash, size_bits)
        lcw = cw - my * wps
        cmine = (lcw >= 0) & (lcw < wps)
        wv = jnp.take(ctx_words, jnp.clip(lcw, 0, wps - 1), axis=0)
        hit_local = cmine & (((wv >> cb.astype(jnp.uint32)) & jnp.uint32(1)).astype(bool))
        ctx_known = jax.lax.psum(hit_local.astype(jnp.int32), "shard") > 0

        # centered k-mer -> canonical -> counter update in local range
        centers = seq.canonical_jax(contexts[:, off : off + k])
        ch = xxh3_64_jax(centers)
        bw, bb = xxh3_mod_size(ch, size_bits)
        lbw = bw - my * wps
        bmine = (lbw >= 0) & (lbw < wps)
        row = jnp.take(bf_packed, jnp.clip(lbw, 0, wps - 1), axis=0)
        word = row[:, 0]
        bbu = bb.astype(jnp.uint32)
        is_set = ((word >> bbu) & jnp.uint32(1)).astype(bool)
        below = word & ((jnp.uint32(1) << bbu) - jnp.uint32(1))
        cnt_idx = (row[:, 1] + jax.lax.population_count(below)).astype(jnp.int32)
        upd = bmine & (~ctx_known) & is_set
        bf_counts = scatter_add_u32(bf_counts, cnt_idx, counters, upd)

        # exact map: contiguous bucket ranges per shard; a key lives in
        # exactly one of its two global cuckoo buckets, so at most one
        # shard finds it (two-choice layout, kmap_table module doc)
        packed = pack2bit_jax(centers, k)
        gb1, gb2 = bucket_pair_jax(ch[:, 0], ch[:, 1], n_buckets)
        found = jnp.zeros(packed.shape[0], dtype=bool)
        slot = jnp.zeros(packed.shape[0], dtype=jnp.int32)
        for gb in (gb1, gb2):
            lbucket = gb.astype(jnp.int32) - my * nbps
            kmine = (lbucket >= 0) & (lbucket < nbps)
            lb = jnp.clip(lbucket, 0, nbps - 1)
            rows = jnp.take(kmap_keys, lb, axis=0)
            for s in range(SLOTS):
                eq = kmine
                for j in range(w_k):
                    eq = eq & (rows[:, s * w_k + j] == packed[:, j])
                slot = jnp.where(eq & ~found, lb * SLOTS + s, slot)
                found = found | eq
        kmap_vals = scatter_add_u32(kmap_vals, slot, counters, found)

        return bf_counts[None], kmap_vals[None]

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P("shard"), P("shard"), P("shard"), P("shard"), P("shard"), P("shard"), P("shard")),
        out_specs=(P("shard"), P("shard")),
        check_vma=False,
    )
    return jax.jit(sharded)


# ---------------------------------------------------------------------------
# Routed (all_to_all) sharded step.
#
# The all_gather design above replicates the whole batch (and its hashing)
# on every shard — fine at small shard counts, but per-chip work stays O(B)
# so scaling efficiency collapses as D grows.  The routed design keeps
# per-chip work at O(B/D): each device hashes only its own slice and the
# k-mers travel to the shards that own their index ranges:
#
#   hop 1 (all_to_all): route by context-word owner; the owner probes its
#     slice of the context filter (ctx_known);
#   hop 2 (all_to_all): route by Bloom-word owner, carrying ctx_known; the
#     owner resolves the rank/counter update AND the exact-map update —
#     possible because the routed exact map is partitioned by the same
#     Bloom-word owner (the bucket layout is an implementation choice, not
#     reference semantics; contents stay bit-exact).
#
# Per-destination capacity is 2x the uniform-hash mean; if any slot
# overflows (adversarial skew), the step falls back to the all_gather path
# for that batch, so results never depend on the capacity.


@dataclass
class RoutedIndexState:
    bf_packed: Any       # (S, W/S, 2) uint32
    bf_counts: Any       # (S, Cmax) uint32
    ctx_words: Any       # (S, W/S) uint32
    kmap_keys: Any       # (S, NBs, 4*Wk) uint32 — per-shard tables
    kmap_vals: Any       # (S, NBs*4) uint32
    counts_len: list
    tables: list         # per-shard host BucketTable
    n_shards: int
    nbs: int             # buckets per shard (uniform)
    size_bits: int


def shard_index_routed(index, cfg: Config, n_shards: int) -> RoutedIndexState:
    import jax.numpy as jnp

    from ..index.kmap_table import BucketTable
    from ..ops.xxh3 import xxh3_64

    S = n_shards
    words = index.bf.words
    W = words.shape[0]
    assert W % S == 0
    wps = W // S

    bf_words = words.reshape(S, wps)
    ctx_words = index.context_bf.words.reshape(S, wps)
    pc = np.bitwise_count(bf_words).astype(np.uint32)
    local_rank = np.zeros_like(pc)
    local_rank[:, 1:] = np.cumsum(pc, axis=1)[:, :-1].astype(np.uint32)
    bf_packed = np.stack([bf_words, local_rank], axis=2)

    per_shard = pc.sum(axis=1).astype(np.int64)
    cmax = max(1, int(per_shard.max()))
    counts = np.zeros((S, cmax), dtype=np.uint32)
    starts = np.concatenate([[0], np.cumsum(per_shard)])
    for s in range(S):
        counts[s, : per_shard[s]] = index.bf.counts[starts[s] : starts[s + 1]]

    # exact map partitioned by Bloom-word owner of each key
    keys = device_map_keys(index, cfg)
    by_shard: list[list[bytes]] = [[] for _ in range(S)]
    if keys:
        arr = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(-1, cfg.k)
        h = xxh3_64(arr)
        word = ((h % np.uint64(cfg.bf_size)) >> np.uint64(5)).astype(np.int64)
        owner = word // wps
        for kb, s in zip(keys, owner.tolist()):
            by_shard[s].append(kb)
    nbs = 1
    for s in range(S):
        t = BucketTable(by_shard[s], cfg.k)
        nbs = max(nbs, t.n_buckets)
    while True:  # rebuild until uniform (overflow can double one shard)
        tables = [BucketTable(by_shard[s], cfg.k, min_buckets=nbs) for s in range(S)]
        grown = max(t.n_buckets for t in tables)
        if grown == nbs:
            break
        nbs = grown
    for t in tables:
        t.set_vals_from(index.ref_bf.kmers)
    kk = np.stack([t.bucket_keys for t in tables])
    kv = np.stack([t.vals for t in tables])

    return RoutedIndexState(
        bf_packed=jnp.asarray(bf_packed),
        bf_counts=jnp.asarray(counts),
        ctx_words=jnp.asarray(ctx_words),
        kmap_keys=jnp.asarray(kk),
        kmap_vals=jnp.asarray(kv),
        counts_len=per_shard.tolist(),
        tables=tables,
        n_shards=S,
        nbs=nbs,
        size_bits=cfg.bf_size,
    )


def write_back_routed(state: RoutedIndexState, index) -> None:
    counts = np.asarray(state.bf_counts)
    index.bf.counts = np.concatenate(
        [counts[s, : state.counts_len[s]] for s in range(state.n_shards)]
    )
    vals = np.asarray(state.kmap_vals)
    for s, t in enumerate(state.tables):
        t.write_back(vals[s], index.ref_bf.kmers)


def make_routed_call_step(mesh, k: int, ref_k: int, size_bits: int,
                          n_shards: int, nbs: int, slice_b: int):
    """Routed multi-device call step (see module section comment).

    step(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals,
         contexts, counters) with the batch sharded along axis 0
    ((S*slice_b, ref_k) global); returns updated (bf_counts, kmap_vals).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    off = (ref_k - k) // 2
    w_k = (k + 15) // 16
    W_total = size_bits // 32
    wps = W_total // n_shards
    D = n_shards
    # per-(src,dst) slot capacity: 2x the uniform mean, lane-aligned
    cap = max(128, (2 * slice_b + D - 1) // D)
    F = 8 + w_k  # payload u32 columns

    def pack_dests(owner, payload, valid):
        """Sort lanes by owner and scatter into (D*cap, F) slot matrix.
        Returns (slots, overflow) — slots row d*cap+r holds the r-th item
        destined to shard d; invalid slots have flags column 0."""
        b = owner.shape[0]
        key = jnp.where(valid, owner, jnp.int32(D)).astype(jnp.uint32)
        lane = jnp.arange(b, dtype=jnp.int32)
        sk, perm = lax.sort((key, lane), num_keys=1)
        sorted_payload = jnp.take(payload, perm, axis=0)
        # rank within destination: position - first position of this key
        first = jnp.concatenate(
            [jnp.zeros(1, bool), sk[1:] != sk[:-1]]
        )
        pos = jnp.arange(b, dtype=jnp.int32)
        start_of_key = jnp.where(first, pos, 0)
        start_of_key = jax.lax.associative_scan(jnp.maximum, start_of_key)
        rank = pos - start_of_key
        ok = (sk < D) & (rank < cap)
        overflow = jnp.any((sk < jnp.uint32(D)) & (rank >= cap))
        tgt = jnp.where(ok, sk.astype(jnp.int32) * cap + rank, jnp.int32(D * cap))
        slots = jnp.zeros((D * cap, F), jnp.uint32).at[tgt].set(
            sorted_payload, mode="drop"
        )
        return slots, overflow

    def routed(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals,
               contexts, counters):
        my = jax.lax.axis_index("shard")
        b = contexts.shape[0]

        # hash own slice once (the whole point vs the all_gather design)
        cc = seq.canonical_jax(contexts[:, off : off + k])
        ch = xxh3_64_jax(cc)
        bw, bb = xxh3_mod_size(ch, size_bits)
        ctx_hash = xxh3_64_jax(contexts)
        cw, cb = xxh3_mod_size(ctx_hash, size_bits)
        packed = pack2bit_jax(cc, k)
        bucket, bucket2 = bucket_pair_jax(ch[:, 0], ch[:, 1], nbs)

        valid = counters > 0
        flags = valid.astype(jnp.uint32)  # bit0 valid
        payload = jnp.stack(
            [flags,
             (cw - (cw // wps) * wps).astype(jnp.uint32),  # local ctx word
             cb.astype(jnp.uint32),
             bw.astype(jnp.uint32), bb.astype(jnp.uint32),
             counters.astype(jnp.uint32), bucket, bucket2]
            + [packed[:, j] for j in range(w_k)], axis=1,
        )
        slots1, ovf1 = pack_dests((cw // wps).astype(jnp.int32), payload, valid)
        slots1 = lax.all_to_all(slots1, "shard", split_axis=0, concat_axis=0,
                                tiled=True)

        # hop-1 owner: probe local context-filter range
        p_flags = slots1[:, 0]
        p_valid = (p_flags & jnp.uint32(1)).astype(bool)
        lcw = slots1[:, 1].astype(jnp.int32)
        wv = jnp.take(ctx_words, jnp.clip(lcw, 0, wps - 1), axis=0)
        known = ((wv >> slots1[:, 2]) & jnp.uint32(1)).astype(bool) & p_valid
        flags2 = p_flags | (known.astype(jnp.uint32) << 1)
        payload2 = slots1.at[:, 0].set(flags2)

        # hop 2: route by Bloom-word owner
        bw2 = payload2[:, 3].astype(jnp.int32)
        slots2, ovf2 = pack_dests(bw2 // wps, payload2, p_valid)
        slots2 = lax.all_to_all(slots2, "shard", split_axis=0, concat_axis=0,
                                tiled=True)

        q_flags = slots2[:, 0]
        q_valid = (q_flags & jnp.uint32(1)).astype(bool)
        q_known = ((q_flags >> jnp.uint32(1)) & jnp.uint32(1)).astype(bool)
        lbw = slots2[:, 3].astype(jnp.int32) - my * wps
        row = jnp.take(bf_packed, jnp.clip(lbw, 0, wps - 1), axis=0)
        word = row[:, 0]
        bbu = slots2[:, 4]
        is_set = ((word >> bbu) & jnp.uint32(1)).astype(bool)
        below = word & ((jnp.uint32(1) << bbu) - jnp.uint32(1))
        cnt_idx = (row[:, 1] + jax.lax.population_count(below)).astype(jnp.int32)
        q_counter = slots2[:, 5]
        upd = q_valid & is_set & ~q_known
        bf_counts = scatter_add_u32(bf_counts, cnt_idx, q_counter, upd)

        q_packed = slots2[:, 8 : 8 + w_k]
        found = jnp.zeros(q_packed.shape[0], dtype=bool)
        slot = jnp.zeros(q_packed.shape[0], dtype=jnp.int32)
        for col in (6, 7):
            q_bucket = slots2[:, col].astype(jnp.int32)
            rows = jnp.take(kmap_keys, jnp.clip(q_bucket, 0, nbs - 1), axis=0)
            for s in range(SLOTS):
                eq = jnp.ones(q_packed.shape[0], dtype=bool)
                for j in range(w_k):
                    eq = eq & (rows[:, s * w_k + j] == q_packed[:, j])
                slot = jnp.where(eq & ~found, q_bucket * SLOTS + s, slot)
                found = found | eq
        kmap_vals = scatter_add_u32(kmap_vals, slot, q_counter, found & q_valid)
        return bf_counts, kmap_vals, ovf1 | ovf2

    def gather_fallback(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals,
                        contexts, counters):
        """all_gather variant over the routed layout (kmap partitioned by
        Bloom-word owner) — overflow escape hatch, rare by construction."""
        my = jax.lax.axis_index("shard")
        contexts = jax.lax.all_gather(contexts, "shard", axis=0, tiled=True)
        counters = jax.lax.all_gather(counters, "shard", axis=0, tiled=True)

        ctx_hash = xxh3_64_jax(contexts)
        cw, cb = xxh3_mod_size(ctx_hash, size_bits)
        lcw = cw - my * wps
        cmine = (lcw >= 0) & (lcw < wps)
        wv = jnp.take(ctx_words, jnp.clip(lcw, 0, wps - 1), axis=0)
        hit_local = cmine & (((wv >> cb.astype(jnp.uint32)) & jnp.uint32(1)).astype(bool))
        ctx_known = jax.lax.psum(hit_local.astype(jnp.int32), "shard") > 0

        cc = seq.canonical_jax(contexts[:, off : off + k])
        ch = xxh3_64_jax(cc)
        bw, bb = xxh3_mod_size(ch, size_bits)
        lbw = bw - my * wps
        bmine = (lbw >= 0) & (lbw < wps)
        row = jnp.take(bf_packed, jnp.clip(lbw, 0, wps - 1), axis=0)
        word = row[:, 0]
        bbu = bb.astype(jnp.uint32)
        is_set = ((word >> bbu) & jnp.uint32(1)).astype(bool)
        below = word & ((jnp.uint32(1) << bbu) - jnp.uint32(1))
        cnt_idx = (row[:, 1] + jax.lax.population_count(below)).astype(jnp.int32)
        upd = bmine & (~ctx_known) & is_set
        bf_counts = scatter_add_u32(bf_counts, cnt_idx, counters, upd)

        packed = pack2bit_jax(cc, k)
        b1, b2 = bucket_pair_jax(ch[:, 0], ch[:, 1], nbs)
        found = jnp.zeros(packed.shape[0], dtype=bool)
        slot = jnp.zeros(packed.shape[0], dtype=jnp.int32)
        for b in (b1, b2):
            bi = b.astype(jnp.int32)
            rows = jnp.take(kmap_keys, bi, axis=0)
            for s in range(SLOTS):
                eq = jnp.ones(packed.shape[0], dtype=bool)
                for j in range(w_k):
                    eq = eq & (rows[:, s * w_k + j] == packed[:, j])
                slot = jnp.where(eq & ~found, bi * SLOTS + s, slot)
                found = found | eq
        kmap_vals = scatter_add_u32(kmap_vals, slot, counters, found & bmine)
        return bf_counts, kmap_vals

    def step(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals,
             contexts, counters):
        new_counts, new_vals, ovf = routed(
            bf_packed[0], bf_counts[0], ctx_words[0], kmap_keys[0],
            kmap_vals[0], contexts, counters,
        )
        any_ovf = jax.lax.psum(ovf.astype(jnp.int32), "shard") > 0
        # on capacity overflow (adversarial skew) the routed attempt is
        # discarded; the host reruns the batch through the gather fallback
        new_counts = jnp.where(any_ovf, bf_counts[0], new_counts)
        new_vals = jnp.where(any_ovf, kmap_vals[0], new_vals)
        return new_counts[None], new_vals[None], jnp.broadcast_to(any_ovf, (1,))

    def fb_step(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals,
                contexts, counters):
        c, v = gather_fallback(
            bf_packed[0], bf_counts[0], ctx_words[0], kmap_keys[0],
            kmap_vals[0], contexts, counters,
        )
        return c[None], v[None]

    routed_j = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P("shard"),) * 7,
        out_specs=(P("shard"), P("shard"), P("shard")), check_vma=False,
    ))
    fallback_j = jax.jit(jax.shard_map(
        fb_step, mesh=mesh, in_specs=(P("shard"),) * 7,
        out_specs=(P("shard"), P("shard")), check_vma=False,
    ))

    def run(bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals,
            contexts, counters):
        new_counts, new_vals, ovf = routed_j(
            bf_packed, bf_counts, ctx_words, kmap_keys, kmap_vals,
            contexts, counters,
        )
        if bool(np.asarray(ovf).any()):
            return fallback_j(
                bf_packed, new_counts, ctx_words, kmap_keys, new_vals,
                contexts, counters,
            )
        return new_counts, new_vals

    return run


def make_sharded_ref_scan(mesh, k: int, ref_k: int, size_bits: int,
                          n_shards: int, slice_chunk: int):
    """Multi-device index-phase context scan (hot loop C, reference
    main.cpp:382-401): contig positions are data-parallel (one slice per
    device, ref_k-1 halo baked into each slice), every device probes the
    replicated alt filter and hashes its own windows, and the context-
    filter bit sets merge by word owner — the hit triples (word, bit)
    all_gather within the axis (12 B/position — tiny next to the hashing)
    and each shard applies only the bits in its contiguous word range via
    the sort-dedup scatter (ops.bloom_jax.bloom_set).

    scan(bf_words, ctx_shards, ref_slices, n_valid) -> ctx_shards
      bf_words: (W,) replicated; ctx_shards: (S, W/S); ref_slices:
      (S, slice_chunk + ref_k - 1) uint8; n_valid: (S, 1) int32.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.bloom_jax import bloom_set

    off = (ref_k - k) // 2
    wps = (size_bits // 32) // n_shards

    def step(bf_words, ctx_shard, ref_slice, n_valid):
        ctx_shard = ctx_shard[0]
        ref_slice = ref_slice[0]
        n_valid = n_valid[0, 0]
        my = jax.lax.axis_index("shard")

        cols = [
            jax.lax.dynamic_slice(ref_slice, (j,), (slice_chunk,))
            for j in range(ref_k)
        ]
        win = jnp.stack(cols, axis=1)
        centers = seq.canonical_jax(win[:, off : off + k])
        h = xxh3_64_jax(centers)
        bw, bb = xxh3_mod_size(h, size_bits)
        wv = jnp.take(bf_words, bw, axis=0)
        hit = ((wv >> bb.astype(jnp.uint32)) & jnp.uint32(1)).astype(bool)
        lane = jnp.arange(slice_chunk, dtype=jnp.int32)
        hit = hit & (lane < n_valid)

        ctxc = seq.canonical_jax(win)
        h2 = xxh3_64_jax(ctxc)
        cw, cb = xxh3_mod_size(h2, size_bits)

        # merge by owner: gather every shard's triples, set local bits
        cw = jax.lax.all_gather(cw, "shard", axis=0, tiled=True)
        cb = jax.lax.all_gather(cb, "shard", axis=0, tiled=True)
        hit = jax.lax.all_gather(hit, "shard", axis=0, tiled=True)
        lcw = cw - my * wps
        mine = hit & (lcw >= 0) & (lcw < wps)
        return bloom_set(ctx_shard, lcw, cb, mask=mine)[None]

    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(), P("shard"), P("shard"), P("shard")),
        out_specs=P("shard"), check_vma=False,
    )
    return jax.jit(sharded)


def build_context_sharded(index, refs_used, cfg: Config, mesh,
                          slice_chunk: int = 1 << 18) -> None:
    """Multi-device equivalent of pipeline.build_index's context scan /
    index.device.build_context_device: updates index.context_bf.words."""
    import jax.numpy as jnp

    S = mesh.devices.size
    W = index.bf.words.shape[0]
    assert W % S == 0
    halo = cfg.ref_k - 1

    # short contigs first, on host (mirrors build_context_device)
    for ref in refs_used:
        if len(ref) < cfg.ref_k:
            off = cfg.center_off
            if len(ref) > off:
                sub = ref[off : off + cfg.k][None, :]
                if index.bf.test_keys(sub)[0]:
                    index.context_bf.add_keys(ref[: cfg.ref_k][None, :])

    scan = make_sharded_ref_scan(
        mesh, cfg.k, cfg.ref_k, cfg.bf_size, S, slice_chunk
    )
    bf_words = jnp.asarray(index.bf.words)
    ctx_shards = jnp.asarray(index.context_bf.words.reshape(S, W // S))
    gchunk = S * slice_chunk
    for ref in refs_used:
        L = len(ref)
        if L < cfg.ref_k:
            continue
        n_pos = L - cfg.ref_k + 1
        for start in range(0, n_pos, gchunk):
            slices = np.zeros((S, slice_chunk + halo), dtype=np.uint8)
            n_valid = np.zeros((S, 1), dtype=np.int32)
            for s in range(S):
                p0 = start + s * slice_chunk
                if p0 >= n_pos:
                    break
                nv = min(slice_chunk, n_pos - p0)
                piece = ref[p0 : p0 + slice_chunk + halo]
                slices[s, : piece.shape[0]] = piece
                n_valid[s, 0] = nv
            ctx_shards = scan(bf_words, ctx_shards, slices, n_valid)
    index.context_bf.words = np.asarray(ctx_shards).reshape(-1)


class ShardedCallSession:
    """Sharded call-phase state reused across many batches: the index is
    sharded ONCE, incoming (contexts, counters) batches accumulate into a
    fixed-shape buffer (the routed jit has a static per-chip slice), and
    ``finish`` flushes the padded remainder and writes counters back to
    the host index.  This is what the product ``call()`` routes through
    on a multi-device mesh (pipeline.call -> _apply_counts_maybe_sharded);
    per-k-mer semantics match main.cpp:487-500 exactly."""

    def __init__(self, index, cfg: Config, mesh, batch: int = 1 << 20,
                 routed: bool = True):
        self.index = index
        self.cfg = cfg
        self.mesh = mesh
        self.routed = routed
        S = self.S = mesh.devices.size
        batch = max(batch - batch % S, S)
        if routed:
            self.state = shard_index_routed(index, cfg, S)
            slice_b = batch // S
            self.step = make_routed_call_step(
                mesh, cfg.k, cfg.ref_k, cfg.bf_size, S, self.state.nbs, slice_b
            )
            self.batch = slice_b * S
        else:
            self.state = shard_index(index, cfg, S)
            self.step = make_sharded_call_step(
                mesh, cfg.k, cfg.ref_k, cfg.bf_size, S, self.state.n_buckets
            )
            self.batch = batch
        self.bf_counts = self.state.bf_counts
        self.kmap_vals = self.state.kmap_vals
        self._buf_ctx = np.full((self.batch, cfg.ref_k), ord("A"), np.uint8)
        self._buf_cnt = np.zeros(self.batch, dtype=np.uint32)
        self._fill = 0

    def _run(self, chunk, cnts):
        # fresh copies: the CPU backend aliases numpy inputs zero-copy
        # and dispatch is async, so refilling the reused staging buffer
        # for the next chunk would race the in-flight step (measured:
        # multi-chunk all_gather parity broke without this)
        self.bf_counts, self.kmap_vals = self.step(
            self.state.bf_packed, self.bf_counts, self.state.ctx_words,
            self.state.kmap_keys, self.kmap_vals, np.array(chunk),
            np.array(cnts),
        )

    def apply(self, contexts: np.ndarray, counters: np.ndarray) -> None:
        """Queue ASCII (n, ref_k) contexts + counters; steps fire whenever
        the fixed-size buffer fills."""
        n = contexts.shape[0]
        at = 0
        while at < n:
            take = min(n - at, self.batch - self._fill)
            self._buf_ctx[self._fill : self._fill + take] = contexts[at : at + take]
            self._buf_cnt[self._fill : self._fill + take] = counters[at : at + take]
            self._fill += take
            at += take
            if self._fill == self.batch:
                self._run(self._buf_ctx, self._buf_cnt)
                self._fill = 0

    def finish(self) -> None:
        """Flush the padded remainder ('A'-rows with counter 0 are masked
        by valid=counters>0) and write counters back to the host index."""
        if self._fill:
            self._buf_ctx[self._fill :] = ord("A")
            self._buf_cnt[self._fill :] = 0
            self._run(self._buf_ctx, self._buf_cnt)
            self._fill = 0
        self.state.bf_counts, self.state.kmap_vals = self.bf_counts, self.kmap_vals
        if self.routed:
            write_back_routed(self.state, self.index)
        else:
            write_back(self.state, self.index)


def apply_sample_counts_sharded(
    index, contexts: np.ndarray, counters: np.ndarray, cfg: Config, mesh,
    batch: int = 1 << 20, routed: bool = True,
) -> None:
    """Multi-device equivalent of pipeline.apply_sample_counts."""
    S = mesh.devices.size
    n = contexts.shape[0]
    if routed:  # size the fixed slice to the problem when it is small
        batch = min(max(batch - batch % S, S), max(S, n + (-n) % S))
    sess = ShardedCallSession(index, cfg, mesh, batch=batch, routed=routed)
    sess.apply(contexts, counters.astype(np.uint32))
    sess.finish()


def apply_sample_counts_sharded_stream(index, batches, cfg: Config, mesh,
                                       batch: int | None = None) -> None:
    """Streaming multi-device call step: consumes (keys, counts) batches
    (2-bit-packed uint64 rows from the built-in counter, or ASCII rows
    from external KMC artifacts) without materializing the distinct set.
    The product pipeline routes here when >1 device is attached
    (pipeline._apply_counts_maybe_sharded)."""
    import os

    from ..ops.seq import unpack_2bit

    if batch is None:
        batch = int(os.environ.get("MALVA_SHARD_BATCH", 1 << 20))
    sess = ShardedCallSession(index, cfg, mesh, batch=batch, routed=True)
    for keys, cnts in batches:
        if keys.dtype == np.uint64:
            keys = unpack_2bit(keys, cfg.ref_k)
        sess.apply(keys, np.asarray(cnts).astype(np.uint32))
    sess.finish()
