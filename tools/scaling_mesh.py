#!/usr/bin/env python
"""Multi-device scaling of the sharded call step on a virtual CPU mesh
(BASELINE north star, SURVEY §2): routed (two-hop all_to_all, O(B/D)
per-chip post-route work) vs all_gather (O(B) everywhere) at D=1/2/4/8,
fixed GLOBAL batch.

CPU-mesh wall-clock is NOT device wall-clock — the point is the CURVE:
whether the routed step's per-chip work actually shrinks with D and what
the collective overhead trend looks like, so the 16-chip design in
BASELINE.md rests on a measured trend.

Run: python tools/scaling_mesh.py   (forces an 8-device CPU mesh itself)
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K, REF_K = 35, 43
LOG2_BITS = 26          # 64 Mbit filter (CPU-mesh-sized, same structure)
GLOBAL_BATCH = 1 << 17
ITERS = 6


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from malva_tpu.index.bloom_filter import BF
    from malva_tpu.index.kmap import KMAP
    from malva_tpu.ops.seq import canonical
    from malva_tpu.parallel import sharded_index as si
    from malva_tpu.parallel.mesh import make_mesh
    from malva_tpu.pipeline import Index
    from malva_tpu.utils.config import Config

    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    cfg = Config(fasta_path="", vcf_path="", sample_path="",
                 bf_size=1 << LOG2_BITS)
    cfg.k, cfg.ref_k = K, REF_K

    bf = BF(cfg.bf_size)
    ref_bf = KMAP()
    ctx = BF(cfg.bf_size)
    bf.add_keys(alpha[rng.integers(0, 4, size=(200_000, K))])
    ref_bf.add_keys(alpha[rng.integers(0, 4, size=(100_000, K))])
    ctx.add_keys(alpha[rng.integers(0, 4, size=(50_000, REF_K))])
    bf.switch_mode()
    ctx.switch_mode()
    index = Index(bf=bf, ref_bf=ref_bf, context_bf=ctx)

    contexts = canonical(alpha[rng.integers(0, 4, size=(GLOBAL_BATCH, REF_K))])
    counters = np.ones(GLOBAL_BATCH, dtype=np.uint32)

    n_avail = len(jax.devices())
    print(f"[scale] devices: {n_avail}; global batch {GLOBAL_BATCH}",
          file=sys.stderr)
    results = {}
    for d in (1, 2, 4, 8):
        if d > n_avail:
            continue
        mesh = make_mesh(d)
        for kind, routed in (("routed", True), ("gather", False)):
            if routed:
                state = si.shard_index_routed(index, cfg, d)
                slice_b = GLOBAL_BATCH // d
                step = si.make_routed_call_step(
                    mesh, K, REF_K, cfg.bf_size, d, state.nbs, slice_b)
            else:
                state = si.shard_index(index, cfg, d)
                step = si.make_sharded_call_step(
                    mesh, K, REF_K, cfg.bf_size, d, state.n_buckets)
            bf_counts, kmap_vals = state.bf_counts, state.kmap_vals

            def it(bc, kv):
                return step(state.bf_packed, bc, state.ctx_words,
                            state.kmap_keys, kv, contexts, counters)

            bf_counts, kmap_vals = it(bf_counts, kmap_vals)  # compile
            jax.block_until_ready((bf_counts, kmap_vals))
            t0 = time.perf_counter()
            for _ in range(ITERS):
                bf_counts, kmap_vals = it(bf_counts, kmap_vals)
            jax.block_until_ready((bf_counts, kmap_vals))
            dt = (time.perf_counter() - t0) / ITERS
            results[(kind, d)] = dt
            print(f"[scale] {kind:7s} D={d}: {dt*1e3:8.2f} ms/batch "
                  f"({GLOBAL_BATCH/dt/1e6:6.2f} M/s)", file=sys.stderr)
    for kind in ("routed", "gather"):
        if (kind, 1) in results:
            base = results[(kind, 1)]
            trend = {d: round(base / results[(kind, d)], 2)
                     for d in (1, 2, 4, 8) if (kind, d) in results}
            print(f"[scale] {kind} speedup vs D=1: {trend}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
