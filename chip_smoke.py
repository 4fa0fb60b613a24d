#!/usr/bin/env python
"""Smoke test of the device path on NVIDIA GPUs.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded path only

One card, in this order; each phase prints its result and wall time:

1. environment: the card's name and power limit (nvidia-smi) and JAX's
   version; fails unless JAX's first device is a GPU;
2. kernel parity at real widths against the exact host path:
   (a) the packed call step at batch 2^21 on a seeded 2^33-bit index
       with planted alt, reference and context hits, against
       ``pipeline.apply_sample_counts``;
   (b) the reference context scan over a seeded 16 Mbp contig at 2^33
       bits, against the host scan of ``pipeline.build_index``;
   (c) the device sort-count against the host counter on the chr-shape
       reads;
3. golden: ``run -b 1 --backend device`` on tests/data/diploid equals
   golden.vcf byte for byte;
4. chr shape (tools/make_synth_scale.py: 10 Mbp, 100,000 diploid
   records x 50 samples, 5x reads, seed 7): ``run -k 35 -r 43 -b 1``
   with ``--backend device`` equals ``--backend host`` byte for byte, and
   the ref scan, the counting and the call step took the device route;
5. the CLI's default filter (-b 4, 2^35 bits): device equals host on the
   diploid fixture.

With ``--cards 4``: the chr-shape ``run --backend device`` on four cards
(sharded context scan and routed call step) against the host output, and
``__graft_entry__.dryrun_multichip(4)``.

Every comparison is exact.  The device path is uint32 arithmetic
throughout (XXH3 as u32 pairs, Bloom bits, popcount ranks, integer
scatter-adds); genotype likelihoods run on the host in float64
(models/genotype.py), so TF32 and the order of float sums do not arise.

The CLI runs in this process (one JAX process per card), with its stdout
and stderr sent to files under .smoke_work/.  Any failure exits non-zero
without the final line.  The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DIPLOID = os.path.join(HERE, "tests", "data", "diploid")
SYNTH = os.path.join(HERE, "tools", "make_synth_scale.py")
WORK = os.path.join(HERE, ".smoke_work")
CHR_SHAPE = ["--mbp", "10", "--variants", "100000", "--samples", "50",
             "--coverage", "5", "--seed", "7"]
SEED = 20261016
# real widths: a -b 1 filter, the call step's 2^21-lane batch, a 16 Mbp
# contig through the 2^20-position scan chunks
BITS = 1 << 33
BATCH = 1 << 21
N_ALT, N_REF, N_CTX = 1_000_000, 200_000, 400_000
CONTIG_BP, N_PLANT = 16_000_000, 100_000


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fmt_mem(compiled) -> str:
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return ", ".join(f"{f.replace('_size_in_bytes', '')}={getattr(ma, f, 'n/a')}"
                     for f in fields)


@contextlib.contextmanager
def redirect_fds(out_path: str, err_path: str):
    """Send fds 1 and 2 (and so sys.stdout/sys.stderr) to files."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1), os.dup(2)
    with open(out_path, "wb") as out, open(err_path, "wb") as err:
        os.dup2(out.fileno(), 1)
        os.dup2(err.fileno(), 2)
        try:
            yield
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            os.close(saved[0])
            os.close(saved[1])


def run_cli(tag: str, inputs: list[str], opts: list[str]):
    """`malva-tpu run <opts> ref vcf reads` in a fresh directory holding
    links to the inputs (the index file is written beside the VCF).
    -> (vcf_bytes, stderr_text, seconds)."""
    from malva_tpu import cli

    wd = os.path.join(WORK, tag)
    os.makedirs(wd)
    args = []
    for src in inputs:
        dst = os.path.join(wd, os.path.basename(src))
        os.symlink(src, dst)
        args.append(dst)
    out, err = os.path.join(wd, "out.vcf"), os.path.join(wd, "stderr.txt")
    t0 = time.perf_counter()
    try:
        with redirect_fds(out, err):
            rc = cli.main(["run", *opts, *args])
    except BaseException:
        with open(err) as f:
            sys.stdout.write(f.read()[-4000:])
        raise
    dt = time.perf_counter() - t0
    with open(err) as f:
        err_text = f.read()
    check(rc == 0, f"{tag}: exit code {rc}\n{err_text[-4000:]}")
    with open(out, "rb") as f:
        vcf = f.read()
    for line in err_text.splitlines():  # PhaseTimer lines, no heartbeats
        if "Execution Time" in line and not re.search(r"Processed \d+ variants", line):
            log(f"  {tag} {line}")
    return vcf, err_text, dt


def acgt(rng, n: int, length: int):
    import numpy as np

    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    return alpha[rng.integers(0, 4, size=(n, length), dtype=np.uint8)]


def phase_call_step() -> str:
    import jax
    import numpy as np

    from malva_tpu.index.bloom_filter import BF
    from malva_tpu.index.device import (
        DeviceIndex, make_call_step_packed, packed64_to_u32,
    )
    from malva_tpu.index.kmap import KMAP
    from malva_tpu.ops.seq import canonical, pack_2bit
    from malva_tpu.pipeline import Index, apply_sample_counts
    from malva_tpu.utils.config import Config

    cfg = Config(k=35, ref_k=43, bf_size=BITS)
    k, ref_k, off = cfg.k, cfg.ref_k, cfg.center_off
    B = BATCH
    rng = np.random.default_rng(SEED)
    alt = acgt(rng, N_ALT, k)
    ref_keys = canonical(acgt(rng, N_REF, k))
    ctx_keys = acgt(rng, N_CTX, ref_k)
    half = N_CTX // 2
    ctx_keys[:half, off:off + k] = alt[:half]  # known reference contexts

    bf = BF(cfg.bf_size)
    bf.add_keys(alt)
    bf.switch_mode()
    km = KMAP()
    km.add_keys(ref_keys)
    ctx = BF(cfg.bf_size)
    ctx.add_keys(ctx_keys)
    ctx.switch_mode()
    host = Index(bf=bf, ref_bf=km, context_bf=ctx)
    dev_index = copy.deepcopy(host)

    contexts = acgt(rng, B, ref_k)
    q = B // 8
    contexts[:q, off:off + k] = alt[rng.integers(0, alt.shape[0], q)]
    contexts[q:2 * q, off:off + k] = ref_keys[rng.integers(0, ref_keys.shape[0], q)]
    contexts[2 * q:3 * q] = ctx_keys[rng.integers(0, half, q)]
    contexts = np.unique(canonical(contexts), axis=0)  # counter contract
    counters = rng.integers(1, 256, size=contexts.shape[0]).astype(np.uint32)
    packed = pack_2bit(contexts)

    apply_sample_counts(host, packed, counters, cfg)

    dev = DeviceIndex.from_host(dev_index, cfg)
    step = make_call_step_packed(k, ref_k, cfg.bf_size, dev.n_buckets, B,
                                 minifilter=dev.minifilter)
    n = contexts.shape[0]
    ctx_u32 = np.zeros((B, (ref_k + 15) // 16), np.uint32)
    ctx_u32[:n] = packed64_to_u32(packed, ref_k)
    cnt = np.zeros(B, np.uint32)
    cnt[:n] = counters
    import jax.numpy as jnp

    state = jnp.concatenate([dev.bf_counts, dev.kmap_vals])
    args = (dev.bf_packed, state, dev.ctx_words, dev.kmap_keys,
            jnp.asarray(ctx_u32), jnp.asarray(cnt))
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    log(f"  call step compile {time.perf_counter() - t0:.3f} s; "
        f"memory_analysis: {fmt_mem(compiled)}")
    t0 = time.perf_counter()
    state = jax.block_until_ready(compiled(*args))
    log(f"  call step run (first, {n} lanes of {B}) "
        f"{time.perf_counter() - t0:.4f} s")
    n_counts = dev.bf_counts.shape[0]
    dev.bf_counts, dev.kmap_vals = state[:n_counts], state[n_counts:]
    dev.write_back(dev_index)

    check(np.array_equal(host.bf.counts, dev_index.bf.counts),
          "call step: BF counters differ from the host path")
    check(host.ref_bf.kmers == dev_index.ref_bf.kmers,
          "call step: exact-map values differ from the host path")
    hit_bf = int(np.count_nonzero(host.bf.counts))
    hit_km = sum(1 for v in host.ref_bf.kmers.values() if v)
    check(hit_bf > 0 and hit_km > 0, "call step: planted hits did not land")
    return (f"{n} contexts: BF counters ({hit_bf} nonzero) and exact map "
            f"({hit_km} nonzero) equal to the host path")


def phase_ref_scan() -> str:
    import numpy as np

    from malva_tpu.index.bloom_filter import BF
    from malva_tpu.index.device import build_context_device
    from malva_tpu.index.kmap import KMAP
    from malva_tpu.pipeline import Index
    from malva_tpu.utils.config import Config

    cfg = Config(k=35, ref_k=43, bf_size=BITS)
    k, ref_k, off = cfg.k, cfg.ref_k, cfg.center_off
    rng = np.random.default_rng(SEED + 1)
    L = CONTIG_BP
    contig = acgt(rng, 1, L)[0]
    for s in rng.integers(0, L - 5000, 5):  # N islands
        contig[s:s + 2000] = ord("N")
    starts = rng.integers(0, L - ref_k, N_PLANT)
    planted = np.stack([contig[s + off:s + off + k] for s in starts])
    bf = BF(cfg.bf_size)
    bf.add_keys(acgt(rng, N_ALT, k))
    bf.add_keys(planted)
    bf.switch_mode()

    host_ctx = BF(cfg.bf_size)
    chunk = 1 << 20
    n_pos = L - ref_k + 1
    for start in range(0, n_pos, chunk):
        stop = min(start + chunk, n_pos)
        win = np.lib.stride_tricks.sliding_window_view(
            contig[start:stop + ref_k - 1], ref_k)
        hits = bf.test_keys(win[:, off:off + k])
        if hits.any():
            host_ctx.add_keys(np.ascontiguousarray(win[hits]))

    dev = Index(bf=bf, ref_bf=KMAP(), context_bf=BF(cfg.bf_size))
    t0 = time.perf_counter()
    build_context_device(dev, [contig], cfg)
    log(f"  ref scan on device {time.perf_counter() - t0:.3f} s "
        f"(compile included, {n_pos} positions)")
    check(np.array_equal(host_ctx.words, dev.context_bf.words),
          "ref scan: context words differ from the host scan")
    n_set = int(np.bitwise_count(host_ctx.words).sum())
    check(n_set > 0, "ref scan: no planted context landed")
    return f"{n_pos} positions: context words equal ({n_set} bits set)"


def phase_sort_count(reads: str) -> str:
    import numpy as np

    from malva_tpu.count.counter import count_reads_kmers

    with open(os.devnull, "w") as quiet:
        t0 = time.perf_counter()
        dk, dc = count_reads_kmers(reads, 43, use_device=True,
                                   return_packed=True, log=quiet)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        hk, hc = count_reads_kmers(reads, 43, use_device=False,
                                   return_packed=True, log=quiet)
        t_host = time.perf_counter() - t0
    log(f"  device sort-count {t_dev:.3f} s (compile included), "
        f"host counter {t_host:.3f} s")
    check(np.array_equal(dk, hk) and np.array_equal(dc, hc),
          "sort-count: device keys/counts differ from the host counter")
    return f"{dk.shape[0]} distinct k-mers past ci, keys and counts equal"


def diploid_inputs() -> list[str]:
    return [os.path.join(DIPLOID, f) for f in ("ref.fa", "vars.vcf", "reads.fa")]


def phase_golden() -> str:
    vcf, _, dt = run_cli("golden", diploid_inputs(),
                         ["-b", "1", "--backend", "device"])
    with open(os.path.join(DIPLOID, "golden.vcf"), "rb") as f:
        golden = f.read()
    check(vcf == golden, "golden: device output differs from golden.vcf")
    n_lines = vcf.count(b"\n")
    return f"{n_lines} lines byte-identical to golden.vcf ({dt:.3f} s)"


DEVICE_TAGS = ("Reference BF creation complete (device)",
               "(device sort-count)", "BF weights created (device")


def chr_inputs(out: list[str]) -> str:
    d = os.path.join(WORK, "chr")
    subprocess.run([sys.executable, SYNTH, d, *CHR_SHAPE], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    out += [os.path.join(d, f) for f in ("synth.fa", "synth.vcf", "synth.fq")]
    return f"generated {' '.join(CHR_SHAPE)} ({os.path.getsize(out[2])} B of reads)"


def phase_chr(inputs: list[str], host_vcf: bytes | None, n_cards: int):
    opts = ["-k", "35", "-r", "43", "-b", "1"]
    dvcf, derr, dt = run_cli(f"chr_device_{n_cards}", inputs,
                             opts + ["--backend", "device"])
    missing = [t for t in DEVICE_TAGS if t not in derr]
    check(not missing, f"chr: device route not taken for {missing}")
    if n_cards > 1:
        check("-device mesh)" in derr, "chr: sharded call step not taken")
    if host_vcf is None:
        host_vcf, _, ht = run_cli("chr_host", inputs, opts + ["--backend", "host"])
        log(f"  chr host run {ht:.3f} s")
    check(dvcf == host_vcf, "chr: device output differs from host output")
    n_lines = dvcf.count(b"\n")
    return (f"{n_lines} lines, device ({n_cards} card(s)) == host byte for byte; "
            f"device run {dt:.3f} s")


def phase_b4() -> str:
    import jax
    import jax.numpy as jnp

    from malva_tpu.index.device import RANK_BITS, _make_densify

    W = (1 << 35) // 32
    i32 = jax.ShapeDtypeStruct((4096,), jnp.int32)
    u32 = jax.ShapeDtypeStruct((4096,), jnp.uint32)
    compiled = _make_densify(W, RANK_BITS).lower(i32, u32, i32, u32, i32, u32).compile()
    log(f"  densify at 2^30 words memory_analysis: {fmt_mem(compiled)}")
    dvcf, _, dt = run_cli("b4_device", diploid_inputs(),
                          ["-b", "4", "--backend", "device"])
    hvcf, _, ht = run_cli("b4_host", diploid_inputs(), ["-b", "4", "--backend", "host"])
    check(dvcf == hvcf, "-b 4: device output differs from host output")
    return f"device == host byte for byte (device {dt:.3f} s, host {ht:.3f} s)"


def run_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    res = fn(*args)
    log(f"{name}: ok — {res} [{time.perf_counter() - t0:.3f} s]")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    n_cards = ap.parse_args().cards

    for p in (os.path.join(HERE, "malva_tpu", "cli.py"), DIPLOID, SYNTH):
        if not os.path.exists(p):
            print(f"[smoke] FAIL: {p} missing; run from a checkout of the repo",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, HERE)
    if n_cards == 1:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    if n_cards == 1:
        query += ["-i", visible.split(",")[0]]
    try:
        smi = subprocess.run(query, check=True, capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[smoke] FAIL: nvidia-smi: {e}", file=sys.stderr)
        return 2
    for line in smi.splitlines()[:n_cards]:
        print(line, flush=True)

    import jax

    from malva_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    log(f"jax {jax.__version__}; devices: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform}); compile cache {cache}")
    if devs[0].platform != "gpu" or len(devs) != n_cards:
        print(f"[smoke] FAIL: need {n_cards} GPU(s), JAX has {len(devs)} "
              f"{devs[0].platform} device(s)", file=sys.stderr)
        return 2

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_all = time.perf_counter()
    try:
        inputs: list[str] = []
        run_phase("chr inputs", chr_inputs, inputs)
        if n_cards == 1:
            run_phase("(a) call step parity", phase_call_step)
            run_phase("(b) ref scan parity", phase_ref_scan)
            run_phase("(c) sort-count parity", phase_sort_count, inputs[2])
            run_phase("golden", phase_golden)
            run_phase("chr shape", phase_chr, inputs, None, 1)
            run_phase("-b 4", phase_b4)
        else:
            from __graft_entry__ import dryrun_multichip

            host_vcf, _, ht = run_cli("chr_host", inputs,
                                      ["-k", "35", "-r", "43", "-b", "1",
                                       "--backend", "host"])
            log(f"  chr host run {ht:.3f} s")
            run_phase("chr shape, 4 cards", phase_chr, inputs, host_vcf, 4)
            run_phase("dryrun_multichip(4)",
                      lambda: dryrun_multichip(4) or "asserted bit-equal")
    except Exception as e:
        print(f"[smoke] FAIL: {type(e).__name__}: {e}", flush=True)
        import traceback

        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"all phases ok [{time.perf_counter() - t_all:.3f} s]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
