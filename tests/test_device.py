"""Device (jax) path parity with the exact host path."""

import numpy as np
import pytest

from malva_tpu.index.bloom_filter import BF
from malva_tpu.index.device import DeviceIndex, apply_sample_counts_device, pack2bit_u32_np
from malva_tpu.index.kmap import KMAP
from malva_tpu.ops.xxh3 import xxh3_64
from malva_tpu.pipeline import Index, apply_sample_counts
from malva_tpu.utils.config import Config


def _u64_pairs_to_np(h2):
    h2 = np.asarray(h2)
    return (h2[:, 0].astype(np.uint64) << np.uint64(32)) | h2[:, 1].astype(np.uint64)


@pytest.mark.parametrize("length", [1, 2, 3, 4, 7, 8, 9, 16, 17, 35, 43, 64, 100, 128, 129, 200, 240])
def test_xxh3_jax_parity(length):
    import jax.numpy as jnp

    from malva_tpu.ops.xxh3_jax import xxh3_64_jax

    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, size=(64, length), dtype=np.uint8)
    want = xxh3_64(data)
    got = _u64_pairs_to_np(xxh3_64_jax(jnp.asarray(data)))
    np.testing.assert_array_equal(got, want)


def test_mod_gib():
    import jax.numpy as jnp

    from malva_tpu.ops.xxh3_jax import xxh3_64_jax, xxh3_mod_gib

    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(256, 43), dtype=np.uint8)
    h = xxh3_64(data)
    for n_gib in (1, 3, 4, 8):
        size = n_gib << 33
        want_idx = h % np.uint64(size)
        w, b = xxh3_mod_gib(xxh3_64_jax(jnp.asarray(data)), n_gib)
        got_idx = np.asarray(w).astype(np.uint64) * 32 + np.asarray(b).astype(np.uint64)
        np.testing.assert_array_equal(got_idx, want_idx)


def test_pack2bit_layouts_agree():
    import jax.numpy as jnp

    from malva_tpu.ops.bloom_jax import pack2bit_jax

    rng = np.random.default_rng(1)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    batch = alpha[rng.integers(0, 4, size=(100, 35))]
    np.testing.assert_array_equal(
        np.asarray(pack2bit_jax(jnp.asarray(batch), 35)), pack2bit_u32_np(batch, 35)
    )


def test_searchsorted_rows():
    import jax.numpy as jnp

    from malva_tpu.ops.bloom_jax import searchsorted_rows

    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 32, size=(500, 3), dtype=np.uint64).astype(np.uint32)
    keys = np.unique(keys, axis=0)  # sorted lexicographically by columns
    queries = np.concatenate([keys[::7], rng.integers(0, 1 << 32, size=(64, 3)).astype(np.uint32)])
    idx, found = searchsorted_rows(jnp.asarray(keys), jnp.asarray(queries))
    idx = np.asarray(idx)
    found = np.asarray(found)
    keyset = {k.tobytes() for k in keys}
    for q, i, f in zip(queries, idx, found):
        in_set = q.tobytes() in keyset
        assert f == in_set
        if f:
            assert keys[i].tobytes() == q.tobytes()


def _tiny_index(cfg, seed=0):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    bf = BF(cfg.bf_size)
    ref_bf = KMAP()
    ctx = BF(cfg.bf_size)
    alt_keys = alpha[rng.integers(0, 4, size=(300, cfg.k))]
    ref_keys = alpha[rng.integers(0, 4, size=(300, cfg.k))]
    ctx_keys = alpha[rng.integers(0, 4, size=(200, cfg.ref_k))]
    bf.add_keys(alt_keys)
    ref_bf.add_keys(ref_keys)
    ctx.add_keys(ctx_keys)
    bf.switch_mode()
    ctx.switch_mode()
    return Index(bf=bf, ref_bf=ref_bf, context_bf=ctx), (alt_keys, ref_keys, ctx_keys)


@pytest.mark.slow
def test_device_call_step_parity_with_host():
    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)

    index_h, (alt_keys, ref_keys, ctx_keys) = _tiny_index(cfg)
    index_d, _ = _tiny_index(cfg)

    # sample contexts: some overlapping the indexed keys' centers, some not
    contexts = alpha[rng.integers(0, 4, size=(2000, cfg.ref_k))]
    contexts[:200, 4:39] = alt_keys[:200]
    contexts[200:400, 4:39] = ref_keys[:200]
    contexts[400:600] = ctx_keys[:200]
    from malva_tpu.ops.seq import canonical

    contexts = canonical(contexts)  # sample stream is canonical (KMC)
    counters = rng.integers(1, 255, size=2000).astype(np.uint32)

    apply_sample_counts(index_h, contexts, counters, cfg)
    apply_sample_counts_device(index_d, contexts, counters, cfg, batch=512)

    np.testing.assert_array_equal(index_h.bf.counts, np.asarray(index_d.bf.counts))
    assert index_h.ref_bf.kmers == index_d.ref_bf.kmers


@pytest.mark.parametrize("cap,minifilter", [(None, True), (8, True), (None, False), (8, False)])
def test_compact_call_step_matches_full(cap, minifilter):
    """Lane-compacted step == full-batch step, across compact/overflow
    (cap=8 forces the lax.cond fallback) and minifilter on/off."""
    import jax.numpy as jnp

    from malva_tpu.index.device import DeviceIndex, make_call_step, make_call_step_compact
    from malva_tpu.ops.seq import canonical

    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    index, (alt_keys, ref_keys, ctx_keys) = _tiny_index(cfg)

    dev = DeviceIndex.from_host(index, cfg)
    assert dev.minifilter  # tiny index: popcount far below 2^28
    packed = np.asarray(dev.bf_packed)
    if not minifilter:
        packed = packed.copy()
        packed[:, 1] &= (1 << 28) - 1
    bf_packed = jnp.asarray(packed)

    B = 512
    contexts = alpha[rng.integers(0, 4, size=(B, cfg.ref_k))]
    contexts[:64, 4:39] = alt_keys[:64]
    contexts[64:128, 4:39] = ref_keys[:64]
    contexts[128:192] = ctx_keys[:64]
    contexts = canonical(contexts)
    counters = rng.integers(1, 255, size=B).astype(np.uint32)

    full = make_call_step(cfg.k, cfg.ref_k, cfg.bf_size, dev.n_buckets, minifilter)
    compact = make_call_step_compact(
        cfg.k, cfg.ref_k, cfg.bf_size, dev.n_buckets, B, cap=cap, minifilter=minifilter
    )
    c_full, v_full = full(
        bf_packed, dev.bf_counts, dev.ctx_words, dev.kmap_keys, dev.kmap_vals,
        contexts, counters,
    )
    state = jnp.concatenate([dev.bf_counts, dev.kmap_vals])
    n_counts = dev.bf_counts.shape[0]
    state = compact(bf_packed, state, dev.ctx_words, dev.kmap_keys, contexts, counters)
    np.testing.assert_array_equal(np.asarray(c_full), np.asarray(state[:n_counts]))
    np.testing.assert_array_equal(np.asarray(v_full), np.asarray(state[n_counts:]))


def test_device_ref_scan_parity():
    """Device context scan == host context scan (index phase hot loop C)."""
    import jax.numpy as jnp

    from malva_tpu.index.device import build_context_device

    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGTN", dtype=np.uint8)
    ref = alpha[rng.integers(0, 5, size=5000)]

    def make(seed):
        idx, (alt_keys, _, _) = _tiny_index(cfg, seed=seed)
        return idx, alt_keys

    host_idx, _ = make(7)
    dev_idx, _ = make(7)
    # plant some centers from the reference so the scan has hits
    for start in (100, 500, 900, 1300):
        host_idx.bf.add_keys(ref[start + 4 : start + 39][None, :])
        dev_idx.bf.add_keys(ref[start + 4 : start + 39][None, :])

    # host scan (as in pipeline.build_index)
    off = cfg.center_off
    n_pos = len(ref) - cfg.ref_k + 1
    windows = np.lib.stride_tricks.sliding_window_view(ref, cfg.ref_k)[:n_pos]
    hits = host_idx.bf.test_keys(np.ascontiguousarray(windows[:, off : off + cfg.k]))
    host_idx.context_bf.add_keys(np.ascontiguousarray(windows[hits]))

    build_context_device(dev_idx, [ref], cfg, chunk=512)

    np.testing.assert_array_equal(host_idx.context_bf.words, dev_idx.context_bf.words)


@pytest.mark.parametrize("k,ref_k", [(35, 43), (15, 23), (31, 50)])
def test_packed_front_end_matches_host(k, ref_k):
    """XLA front end of the packed call step (ops.packed) == host
    seq.canonical + xxh3_64, for the center and the whole context."""
    import jax.numpy as jnp

    from malva_tpu.ops.packed import center_hash, context_hash
    from malva_tpu.ops.seq import canonical

    rng = np.random.default_rng(k * 100 + ref_k)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    contexts = canonical(alpha[rng.integers(0, 4, size=(300, ref_k))])
    off = (ref_k - k) // 2
    rows = jnp.asarray(pack2bit_u32_np(contexts, ref_k))

    ch, cl, cen = center_hash(rows, k, ref_k)
    want_cen = canonical(np.ascontiguousarray(contexts[:, off : off + k]))
    got = (np.asarray(ch).astype(np.uint64) << np.uint64(32)) | np.asarray(cl)
    np.testing.assert_array_equal(got, xxh3_64(want_cen))
    np.testing.assert_array_equal(np.asarray(cen), pack2bit_u32_np(want_cen, k))

    xh, xl = context_hash(rows, ref_k)
    got = (np.asarray(xh).astype(np.uint64) << np.uint64(32)) | np.asarray(xl)
    np.testing.assert_array_equal(got, xxh3_64(contexts))


@pytest.mark.parametrize("cap,minifilter", [(None, True), (8, True), (None, False), (8, False)])
def test_packed_call_step_matches_full(cap, minifilter):
    """Packed step == full-batch step on the tiny index, across the
    compact tail and the fallback tier (cap=8 overflows every tier) and
    minifilter on/off."""
    import jax.numpy as jnp

    from malva_tpu.index.device import make_call_step, make_call_step_packed
    from malva_tpu.ops.seq import canonical

    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    rng = np.random.default_rng(6)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    index, (alt_keys, ref_keys, ctx_keys) = _tiny_index(cfg)
    dev = DeviceIndex.from_host(index, cfg)
    packed = np.asarray(dev.bf_packed)
    if not minifilter:
        packed = packed.copy()
        packed[:, 1] &= (1 << 28) - 1
    bf_packed = jnp.asarray(packed)

    B = 512
    contexts = alpha[rng.integers(0, 4, size=(B, cfg.ref_k))]
    contexts[:64, 4:39] = alt_keys[:64]
    contexts[64:128, 4:39] = ref_keys[:64]
    contexts[128:192] = ctx_keys[:64]
    contexts = canonical(contexts)
    counters = rng.integers(1, 255, size=B).astype(np.uint32)

    full = make_call_step(cfg.k, cfg.ref_k, cfg.bf_size, dev.n_buckets, minifilter)
    c_full, v_full = full(
        bf_packed, dev.bf_counts, dev.ctx_words, dev.kmap_keys, dev.kmap_vals,
        contexts, counters,
    )
    step = make_call_step_packed(
        cfg.k, cfg.ref_k, cfg.bf_size, dev.n_buckets, B, cap=cap,
        minifilter=minifilter,
    )
    state = jnp.concatenate([dev.bf_counts, dev.kmap_vals])
    state = step(bf_packed, state, dev.ctx_words, dev.kmap_keys,
                 jnp.asarray(pack2bit_u32_np(contexts, cfg.ref_k)), counters)
    n_counts = dev.bf_counts.shape[0]
    assert np.asarray(c_full).any() and np.asarray(v_full).any()
    np.testing.assert_array_equal(np.asarray(c_full), np.asarray(state[:n_counts]))
    np.testing.assert_array_equal(np.asarray(v_full), np.asarray(state[n_counts:]))


def test_stream_batch_needs_no_lane_rounding():
    """A stream whose distinct set is not a multiple of 128 lanes runs at
    its own lane count and matches the host path."""
    from malva_tpu.ops.seq import canonical

    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    rng = np.random.default_rng(8)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    index_h, (alt_keys, ref_keys, _) = _tiny_index(cfg)
    index_d, _ = _tiny_index(cfg)
    contexts = alpha[rng.integers(0, 4, size=(301, cfg.ref_k))]
    contexts[:100, 4:39] = alt_keys[:100]
    contexts[100:200, 4:39] = ref_keys[:100]
    contexts = canonical(contexts)
    counters = rng.integers(1, 255, size=301).astype(np.uint32)

    apply_sample_counts(index_h, contexts, counters, cfg)
    apply_sample_counts_device(index_d, contexts, counters, cfg, batch=100)
    np.testing.assert_array_equal(index_h.bf.counts, index_d.bf.counts)
    assert index_h.ref_bf.kmers == index_d.ref_bf.kmers
