#!/usr/bin/env python
"""Trace the device call step and the reference scan at real widths.

    python tools/trace_steps.py [--out chiprun_out/trace]

Four programs, each compiled on its own: the packed call step (batch
2^21 on a synthetic 2^33-bit WGS-fill index, bench.synth_index), its
front end alone (center canonicalization + XXH3 + Bloom index), the
reference scan (2^20 positions per chunk), and its window stage alone
(index.device.ref_window_hashes).  For each: the optimized HLO goes to
<out>/<name>.hlo.txt; the entry computation's fusions are listed with
their output shapes, and any uint8 matrix (a window or k-mer byte
matrix) that leaves a fusion is flagged; 10 runs are timed with
block_until_ready; 3 more are traced with jax.profiler and reduced to
device time per XLA op.  One JSON line per program on stdout.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

K, REF_K = 35, 43
BITS = 1 << 33
BATCH = 1 << 21
CHUNK = 1 << 20


def entry_ops(hlo: str) -> list[tuple[str, str, str]]:
    """(name, shape, opcode) of every instruction in the ENTRY computation."""
    body = hlo[hlo.index("\nENTRY "):]
    body = body[: body.index("\n}") + 2]
    ops = []
    for m in re.finditer(r"^\s*(?:ROOT )?%?([\w.\-]+) = (\([^()]*\)|\S+) ([\w\-]+)\(",
                         body, re.M):
        ops.append((m.group(1), m.group(2), m.group(3)))
    return ops


def shape_bytes(shape: str) -> int:
    """Bytes of an HLO shape string (arrays or a tuple of arrays)."""
    size = {"pred": 1, "u8": 1, "s8": 1, "u16": 2, "s16": 2, "u32": 4,
            "s32": 4, "f32": 4, "u64": 8, "s64": 8}
    total = 0
    for ty, dims in re.findall(r"\b([a-z]+\d*)\[([\d,]*)\]", shape):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += size.get(ty, 4) * n
    return total


def device_op_times(trace_dir: str) -> dict[str, int]:
    """Summed device nanoseconds per XLA op over every GPU plane."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        return {}
    prof = ProfileData.from_file(paths[-1])
    acc: dict[str, int] = collections.Counter()
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        for ln in ops:
            for ev in ln.events:
                acc[ev.name] += int(ev.duration_ns)
    return acc


def measure(name: str, fn, args, out: str, carry: int | None = None,
            n_traced: int = 3) -> dict:
    """``carry``: index of a donated argument that each run's result
    replaces (the call step's counter state, as in production)."""
    import jax

    def run(args):
        res = jax.block_until_ready(compiled(*args))
        if carry is None:
            return args
        return args[:carry] + (res,) + args[carry + 1:]

    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    hlo = compiled.as_text()
    with open(os.path.join(out, f"{name}.hlo.txt"), "w") as f:
        f.write(hlo)
    ops = entry_ops(hlo)
    fusions = collections.Counter(re.sub(r"\{[^}]*\}", "", s)
                                  for _, s, op in ops if op == "fusion")
    byte_mats = [(n, s, op) for n, s, op in ops if op != "parameter"
                 and any(int(c) > 1 for c in re.findall(r"\bu8\[\d+,(\d+)", s))]

    args = run(args)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        args = run(args)
        times.append(time.perf_counter() - t0)
    times.sort()

    tdir = os.path.join(out, f"trace_{name}")
    with jax.profiler.trace(tdir):
        for _ in range(n_traced):
            args = run(args)
    per_op = device_op_times(tdir)
    total = sum(per_op.values())
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:12]
    return {
        "program": name,
        "compile_s": t_compile,
        "median_s": times[len(times) // 2],
        "min_s": times[0],
        "entry_fusions": sum(fusions.values()),
        "fusion_output_bytes": sum(shape_bytes(sh) for _, sh, op in ops
                                   if op == "fusion"),
        "fusion_shapes": dict(fusions),
        "u8_matrices_out_of_fusions": byte_mats,
        "device_ns_per_run": total / n_traced,
        "top_ops": [(n, ns / n_traced, ns / total if total else 0.0) for n, ns in top],
        "temp_bytes": compiled.memory_analysis().temp_size_in_bytes,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "trace"))
    out = ap.parse_args().out
    os.makedirs(out, exist_ok=True)

    import jax
    import jax.numpy as jnp

    from bench import synth_index
    from malva_tpu.index.device import make_call_step_packed, ref_window_hashes
    from malva_tpu.index.device import make_ref_scan_step
    from malva_tpu.ops.packed import center_hash
    from malva_tpu.ops.xxh3_jax import xxh3_mod_size
    from malva_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"[trace] {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)

    bf_packed, ctx_words, kmap_keys, table, n_counts = synth_index(BITS, 6, 1_000_000)
    state = jnp.zeros(n_counts + table.vals.shape[0], jnp.uint32)
    wc = (REF_K + 15) // 16
    ctx = jax.random.bits(jax.random.PRNGKey(1), (BATCH, wc), jnp.uint32)
    counters = jnp.ones(BATCH, jnp.uint32)
    step = make_call_step_packed(K, REF_K, BITS, table.n_buckets, BATCH, donate=True)

    @jax.jit
    def front_end(rows):
        chh, chl, packed = center_hash(rows, K, REF_K)
        bw, bb = xxh3_mod_size(jnp.stack([chh, chl], axis=1), BITS)
        return bw, bb, chh, packed

    bf_words = bf_packed[:, 0]
    alpha = jnp.asarray([65, 67, 71, 84], jnp.uint8)
    ref = alpha[jax.random.randint(jax.random.PRNGKey(2), (CHUNK + REF_K - 1,), 0, 4)]
    scan = make_ref_scan_step(K, REF_K, BITS, CHUNK)
    windows = jax.jit(lambda r: ref_window_hashes(r, K, REF_K, BITS, CHUNK))

    # the call step donates its counter state, as in production; the
    # ref scan does not donate the context filter (nor does production)
    progs = [
        ("call_step", step, (bf_packed, state, ctx_words, kmap_keys, ctx, counters), 1),
        ("call_front_end", front_end, (ctx,), None),
        ("ref_scan", scan, (bf_words, ctx_words, ref, jnp.int32(CHUNK)), None),
        ("ref_window_hashes", windows, (ref,), None),
    ]
    for name, fn, args, carry in progs:
        print(json.dumps(measure(name, fn, args, out, carry)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
