#!/usr/bin/env python
"""Call-step benchmark: sample k-mers queried/sec/card through the fused
call-phase step (hot loop D — SURVEY.md §3.5).

Default mode "wgs" models a 30x whole-genome index: 1 GiB Bloom filter at
~1.6e-2 set-bit density (AND of 6 random words) and a 10M-key exact map —
the cache-hostile regime a real cohort run sees.  MALVA_BENCH_MODE=sparse
gives a ~3e-6 fill and a 1M-key map.

The index is synthesized on device (no bulk host->device transfer in the
timed region except the one-time bucket-table upload); each iteration's
packed contexts come from a counter-based PRNG on device.

Runs on a GPU only.  Prints the card's name and power limit on stderr and
ONE json line on stdout: {"metric", "value", "unit", "device"}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MODE = os.environ.get("MALVA_BENCH_MODE", "wgs")
LOG2_BITS = int(os.environ.get("MALVA_BENCH_LOG2_BITS", "33"))  # 1 GiB filter
BATCH = int(os.environ.get("MALVA_BENCH_BATCH", str(1 << 21)))
ITERS = int(os.environ.get("MALVA_BENCH_ITERS", "10"))
N_AND = 6 if MODE == "wgs" else 0          # bit density 2^-6 ~ 1.6e-2
KMAP_KEYS = (10_000_000 if MODE == "wgs" else 1_000_000)


def synth_index(size_bits: int, n_and: int, n_keys: int):
    """Synthesize a device-resident call-step index: a Bloom filter of
    size_bits with set-bit density 2^-n_and (n_and=0: ~3e-6), its context
    filter, and an exact map of n_keys random 35-mers with the mini-filter
    in the rank's top bits.  -> (bf_packed, ctx_words, kmap_keys, host
    BucketTable, popcount)."""
    import jax
    import jax.numpy as jnp

    from malva_tpu.index.device import RANK_BITS, pack2bit_u32_np
    from malva_tpu.index.kmap_table import BucketTable
    from malva_tpu.ops.xxh3 import xxh3_64

    nwords = size_bits // 32

    # exact map: n_keys random ACGT 35-mers -> host bucket table
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    t0 = time.perf_counter()
    key_arr = alpha[rng.integers(0, 4, size=(n_keys, 35))]
    h = xxh3_64(key_arr)
    table = BucketTable.from_packed(pack2bit_u32_np(key_arr, 35), h, 35)
    print(f"[bench] kmap table: {n_keys} keys, {table.n_buckets} buckets "
          f"({time.perf_counter()-t0:.1f}s host build)", file=sys.stderr)
    kmap_keys = jnp.asarray(table.bucket_keys)

    # key hashes -> device, for the on-device mini-filter build
    key_h = jnp.asarray(
        np.stack([(h >> np.uint64(32)).astype(np.uint32),
                  (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=1)
    )
    del key_arr, h

    @jax.jit
    def build_index(key, key_h):
        ks = jax.random.split(key, 2 * max(n_and, 1) + 2)
        if n_and > 0:
            words = jax.random.bits(ks[0], (nwords,), dtype=jnp.uint32)
            ctx_words = jax.random.bits(ks[1], (nwords,), dtype=jnp.uint32)
            for j in range(1, n_and):
                words &= jax.random.bits(ks[2 * j], (nwords,), dtype=jnp.uint32)
                ctx_words &= jax.random.bits(ks[2 * j + 1], (nwords,), dtype=jnp.uint32)
        else:
            r = jax.random.randint(ks[0], (nwords,), 0, 10000, dtype=jnp.int32)
            bitpos = jax.random.randint(ks[1], (nwords,), 0, 32, dtype=jnp.int32)
            words = jnp.where(r == 0, jnp.uint32(1) << bitpos.astype(jnp.uint32), jnp.uint32(0))
            r2 = jax.random.randint(ks[2], (nwords,), 0, 10000, dtype=jnp.int32)
            ctx_words = jnp.where(r2 == 0, jnp.uint32(1) << bitpos.astype(jnp.uint32), jnp.uint32(0))
        pc = jax.lax.population_count(words)
        rank = jnp.concatenate([jnp.zeros(1, jnp.uint32), jnp.cumsum(pc)[:-1]])
        n_counts = rank[-1] + pc[-1]

        # exact-map mini-filter in the rank column's top 4 bits, exactly as
        # DeviceIndex.from_host lays it out (hash -> word, bits 60-61 -> slot)
        from malva_tpu.ops.xxh3_jax import xxh3_mod_size

        kw, _ = xxh3_mod_size(key_h, size_bits)
        slot = (key_h[:, 0] >> jnp.uint32(28)) & jnp.uint32(3)
        mf = jnp.zeros(nwords, dtype=jnp.uint32)
        for s in range(4):
            idx = jnp.where(slot == s, kw, jnp.int32(nwords))
            mf = mf.at[idx].max(jnp.uint32(1 << s), mode="drop")
        bf_packed = jnp.stack([words, rank | (mf << jnp.uint32(RANK_BITS))], axis=1)
        return bf_packed, ctx_words, n_counts

    bf_packed, ctx_words, n_counts = build_index(jax.random.PRNGKey(0), key_h)
    return bf_packed, ctx_words, kmap_keys, table, int(np.asarray(n_counts))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from malva_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from malva_tpu.index.device import RANK_BITS, make_call_step_packed

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"[bench] needs a GPU; JAX's device is {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(dev.local_hardware_id or 0)],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[bench] card: {card}; device: {dev.device_kind}, mode: {MODE}",
          file=sys.stderr)

    size_bits = 1 << LOG2_BITS
    bf_packed, ctx_words, kmap_keys, table, n_counts = synth_index(
        size_bits, N_AND, KMAP_KEYS)
    kv_len = table.vals.shape[0]
    fill = n_counts / size_bits
    print(f"[bench] filter popcount {n_counts} (density {fill:.2e})", file=sys.stderr)
    assert n_counts < (1 << RANK_BITS)
    state = jnp.zeros(n_counts + kv_len, dtype=jnp.uint32)

    # production dispatch pattern (index/device.apply_sample_counts_stream):
    # SCAN_S sub-batches chained inside one dispatch via lax.scan.  The
    # sub-batch contexts are generated inside the scan body — uniform
    # random packed rows: every 2-bit base code is a uniform random bit
    # pair, so raw random words ARE a packed batch (the step never reads
    # bits past base ref_k-1).
    from jax import lax

    from malva_tpu.index.device import SCAN_S

    inner = make_call_step_packed(35, 43, size_bits, table.n_buckets, BATCH,
                                  donate=False)
    counters = jnp.ones((BATCH,), dtype=jnp.uint32)

    def scan_step(bf_packed, state, ctx_words, kmap_keys, i, counters):
        def body(st, j):
            ctx = jax.random.bits(
                jax.random.fold_in(jax.random.PRNGKey(7), i * SCAN_S + j),
                (BATCH, 3), dtype=jnp.uint32)
            return inner.__wrapped__(
                bf_packed, st, ctx_words, kmap_keys, ctx, counters), None

        st, _ = lax.scan(body, state, jnp.arange(SCAN_S))
        return st

    step = jax.jit(scan_step, donate_argnums=(1,))

    def it(i, state):
        return step(bf_packed, state, ctx_words, kmap_keys, i, counters)

    # warmup / compile (state is donated: always rebind)
    state = jax.block_until_ready(it(1, it(0, state)))

    t0 = time.perf_counter()
    for i in range(2, 2 + ITERS):
        state = it(i, state)
    state = jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    rate = BATCH * SCAN_S * ITERS / dt
    print(f"[bench] {rate:.3e} kmers/s over {ITERS} iters of {SCAN_S}x{BATCH}",
          file=sys.stderr)

    print(json.dumps({
        "metric": f"call_kmers_queried_per_sec_per_card_{MODE}",
        "value": rate,
        "unit": "kmers/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
