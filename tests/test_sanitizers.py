"""Sanitizer-style harnesses (SURVEY.md §5: the reference is single-
threaded and has none; the device build needs NaN and determinism gates).

* debug_nans: the genotype model and the call step run clean under
  jax.debug_nans (no hidden NaN-producing intermediates).
* scatter determinism: counter updates are a commutative monoid — any
  permutation of the input stream and any batch split must produce the
  identical counter state (the property multi-chip routing relies on).
"""

import numpy as np
import pytest

from malva_tpu.index.bloom_filter import BF
from malva_tpu.index.kmap import KMAP
from malva_tpu.pipeline import Index
from malva_tpu.utils.config import Config


def _tiny_index(cfg, seed=0):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    bf = BF(cfg.bf_size)
    ref_bf = KMAP()
    ctx = BF(cfg.bf_size)
    bf.add_keys(alpha[rng.integers(0, 4, size=(200, cfg.k))])
    ref_bf.add_keys(alpha[rng.integers(0, 4, size=(200, cfg.k))])
    ctx.add_keys(alpha[rng.integers(0, 4, size=(100, cfg.ref_k))])
    bf.switch_mode()
    ctx.switch_mode()
    return Index(bf=bf, ref_bf=ref_bf, context_bf=ctx)


def test_genotype_model_debug_nans():
    import jax

    from malva_tpu.models.genotype_jax import make_genotype_fn

    rng = np.random.default_rng(0)
    geno = make_genotype_fn(max_alleles=4, haploid=False,
                            error_rate=0.001, max_cov=200)
    cov = rng.integers(0, 30, size=(32, 4)).astype(np.int32)
    freqs = rng.random((32, 4), dtype=np.float32)
    n_all = rng.integers(2, 5, size=32).astype(np.int32)
    with jax.debug_nans(True):
        g1, g2, gq = jax.jit(geno)(cov, freqs, n_all)
        np.asarray(gq)


def test_call_step_debug_nans():
    import jax

    from malva_tpu.index.device import (
        DeviceIndex, make_call_step_packed, pack2bit_u32_np,
    )
    from malva_tpu.ops.seq import canonical

    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    index = _tiny_index(cfg)
    dev = DeviceIndex.from_host(index, cfg)
    rng = np.random.default_rng(1)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ctx = canonical(alpha[rng.integers(0, 4, size=(256, 43))])
    step = make_call_step_packed(
        cfg.k, cfg.ref_k, cfg.bf_size, dev.n_buckets, 256,
        minifilter=dev.minifilter, donate=False,
    )
    import jax.numpy as jnp

    state = jnp.concatenate([dev.bf_counts, dev.kmap_vals])
    with jax.debug_nans(True):
        out = step(dev.bf_packed, state, dev.ctx_words, dev.kmap_keys,
                   pack2bit_u32_np(ctx, 43), np.ones(256, np.uint32))
        np.asarray(out)


def test_counter_updates_order_and_split_invariant():
    """Permuting the context stream and changing the batch split must not
    change the final counter state (determinism under data parallelism)."""
    from malva_tpu.index.device import apply_sample_counts_device
    from malva_tpu.ops.seq import canonical

    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    rng = np.random.default_rng(2)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    contexts = canonical(alpha[rng.integers(0, 4, size=(1000, 43))])
    # force real collisions/updates: duplicate blocks + indexed centers
    contexts[500:700] = contexts[:200]
    counters = rng.integers(1, 255, size=1000).astype(np.uint32)

    results = []
    for perm_seed, batch in [(None, 256), (7, 256), (8, 128), (9, 1000)]:
        idx = _tiny_index(cfg, seed=3)
        ctx, cnt = contexts, counters
        if perm_seed is not None:
            p = np.random.default_rng(perm_seed).permutation(1000)
            ctx, cnt = contexts[p], counters[p]
        apply_sample_counts_device(idx, ctx, cnt, cfg, batch=batch)
        results.append((idx.bf.counts.copy(), dict(idx.ref_bf.kmers)))
    for counts, kmers in results[1:]:
        np.testing.assert_array_equal(results[0][0], counts)
        assert results[0][1] == kmers
