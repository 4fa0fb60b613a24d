"""Command-line interface: `malva index | call | run`.

Flag names/defaults mirror the reference CLI (reference:
argument_parser.hpp:31-67, MALVA:17-38).  `run` is the end-to-end driver
replacing the MALVA shell script + external KMC: count sample k-mers,
build the index (reusing an existing index file like MALVA:113-118
intended to), and call genotypes to stdout.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .pipeline import build_index, call, load_index, save_index
from .utils.config import Config
from .utils.timing import PhaseTimer


def _parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, add_help=True)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("index", "call", "run", "batch"):
        sp = sub.add_parser(name)
        sp.add_argument("-k", "--kmer-size", type=int, default=35)
        sp.add_argument("-r", "--ref-kmer-size", type=int, default=43)
        sp.add_argument("-e", "--error-rate", type=float, default=0.001)
        sp.add_argument("-s", "--samples", default="-")
        sp.add_argument("-f", "--freq-key", default="AF")
        sp.add_argument("-c", "--max-coverage", type=int, default=200)
        sp.add_argument("-b", "--bf-size", type=int, default=4, help="bloom filter size in GB")
        sp.add_argument("-p", "--strip-chr", action="store_true")
        sp.add_argument("-u", "--uniform", action="store_true")
        sp.add_argument("-v", "--verbose", action="store_true")
        sp.add_argument("-1", "--haploid", action="store_true", dest="haploid")
        sp.add_argument("--from-kmc-dump", action="store_true",
                        help="treat <sample> as kmc_dump text (KMER<TAB>COUNT)")
        sp.add_argument("--from-kmc", action="store_true", dest="from_kmc_db",
                        help="treat <sample> as a KMC database prefix (.kmc_pre/.kmc_suf)")
        sp.add_argument("--spill-dir", default="",
                        help="bounded-memory counting: spill distinct k-mers "
                             "to this directory (kmc -m4 parity; resumable)")
        sp.add_argument("--backend", default="auto",
                        choices=("auto", "host", "device"),
                        help="where the hot loops run (auto routes by size)")
        sp.add_argument("--malvax", action="store_true",
                        help="read/write the reference .malvax.zst index format")
        sp.add_argument("--profile-dir", default=None,
                        help="capture a jax.profiler trace into this directory")
        sp.add_argument("reference")
        sp.add_argument("variants")
        if name == "batch":
            sp.add_argument("sample", nargs="+", help="reads files, FASTA/FASTQ (.gz ok)")
            sp.add_argument("-o", "--out-dir", default=".", help="output directory for per-sample VCFs")
        else:
            sp.add_argument("sample", help="reads file, FASTA/FASTQ (.gz ok)")
    return p


def _config(args: argparse.Namespace) -> Config:
    sample = args.sample[0] if isinstance(args.sample, list) else args.sample
    return Config(
        fasta_path=args.reference,
        vcf_path=args.variants,
        sample_path=sample,
        k=args.kmer_size,
        ref_k=args.ref_kmer_size,
        error_rate=np.float32(args.error_rate),
        samples=args.samples,
        freq_key=args.freq_key,
        max_coverage=args.max_coverage,
        bf_size=Config.bf_gb_to_bits(args.bf_size),
        strip_chr=args.strip_chr,
        from_kmc_dump=args.from_kmc_dump,
        from_kmc_db=args.from_kmc_db,
        spill_dir=args.spill_dir,
        backend=args.backend,
        uniform=args.uniform,
        verbose=args.verbose,
        haploid=args.haploid,
    )


def main(argv: list[str] | None = None) -> int:
    """Dispatch + the reference's one-line `ERROR:` exit contract for bad
    inputs (main.cpp:262-281): truncated/corrupt index files, malformed
    VCF/FASTQ, unsupported KMC databases and missing paths print a single
    stderr line and exit 1 — never a traceback.  Only the dedicated
    InputError (raised at validated I/O boundaries) plus genuine
    I/O-layer exceptions are caught; internal bugs (shape ValueErrors,
    KeyErrors, ...) traceback so they stay diagnosable."""
    import gzip
    import struct
    import zipfile

    from .utils.errors import InputError

    try:
        return _main(argv)
    except (InputError, OSError, EOFError, struct.error,
            zipfile.BadZipFile, gzip.BadGzipFile, UnicodeDecodeError) as e:
        print(f"ERROR: {e}", file=sys.stderr)  # reference: main.cpp:269-277
        return 1


def _main(argv: list[str] | None = None) -> int:
    from .utils.compile_cache import enable_compile_cache
    from .utils.native import tune_malloc

    tune_malloc()  # GiB-buffer page reuse (see utils.native.tune_malloc)
    enable_compile_cache()
    args = _parser("malva-tpu").parse_args(argv)
    cfg = _config(args)
    timer = PhaseTimer()

    if args.profile_dir:
        import atexit

        import jax

        jax.profiler.start_trace(args.profile_dir)
        atexit.register(jax.profiler.stop_trace)
        print(f"[malva-tpu] jax.profiler trace -> {args.profile_dir}", file=sys.stderr)

    if args.cmd == "index":
        index = build_index(cfg, timer)
        if args.malvax:
            from .io.malvax import write_malvax

            path = cfg.index_path().replace(".malvax.npz", ".malvax.zst")
            write_malvax(index, path)
        else:
            save_index(index, cfg.index_path(), cfg)
        timer.pelapsed("Index saved")
        return 0

    if args.cmd == "call":
        if args.malvax:
            from .io.malvax import read_malvax
            from .pipeline import Index

            path = cfg.index_path().replace(".malvax.npz", ".malvax.zst")
            bf, km, ctx = read_malvax(path)
            index = Index(bf=bf, ref_bf=km, context_bf=ctx)
        else:
            path = cfg.index_path()
            if not os.path.exists(path):
                print(f"ERROR: index file {path} not found (run `index` first)", file=sys.stderr)
                return 1
            index = load_index(path)
        timer.pelapsed("Index loaded")
        call(cfg, index, sys.stdout, timer)
        return 0

    if args.cmd == "batch":
        from .pipeline import call_batch

        path = cfg.index_path()
        index = None
        if os.path.exists(path):
            from .pipeline import index_matches_config

            ok, why = index_matches_config(path, cfg)
            if ok:
                print(f"[malva-tpu] reusing index {path}", file=sys.stderr)
                index = load_index(path)
            else:
                print(
                    f"[malva-tpu] existing index {path} was built with "
                    f"different options ({why}); rebuilding", file=sys.stderr,
                )
        if index is None:
            index = build_index(cfg, timer)
            _try_save_index(index, path, cfg, timer)
        os.makedirs(args.out_dir, exist_ok=True)
        outs = []
        names = []
        seen: dict[str, int] = {}
        for sp in args.sample:
            base = os.path.basename(sp).split(".")[0]
            n = seen.get(base, 0)
            seen[base] = n + 1
            if n:
                base = f"{base}.{n}"
            names.append(os.path.join(args.out_dir, f"{base}.malva.vcf"))
            outs.append(open(names[-1], "w"))
        try:
            call_batch(cfg, index, args.sample, outs, timer)
        finally:
            for f in outs:
                f.close()
        print("[malva-tpu] wrote: " + " ".join(names), file=sys.stderr)
        return 0

    # run: end to end, in process.  When the index must be built and the
    # sample is a large read set counted host-side, the counting phase
    # (reads only) runs in a helper process OVERLAPPED with the index
    # phase (VCF+ref only) — the two touch disjoint inputs, so the
    # smaller phase hides behind the larger (the MALVA driver serializes
    # KMC before index, MALVA:107-121).
    path = cfg.index_path()
    producer = None
    saver = None
    index = None
    if os.path.exists(path):
        from .pipeline import index_matches_config

        ok, why = index_matches_config(path, cfg)
        if ok:
            print(f"[malva-tpu] reusing index {path}", file=sys.stderr)
            index = load_index(path)
        else:
            # the index path is keyed only by (vcf, ref_k, k) — the
            # upstream contract (MALVA:113-118) — so a persisted index
            # built under different -b/-s/-u/-1/-f would silently change
            # output; the fingerprint check rebuilds instead
            print(
                f"[malva-tpu] existing index {path} was built with "
                f"different options ({why}); rebuilding", file=sys.stderr,
            )
    if index is None:
        try:
            producer = _start_count_producer(cfg)
            index = build_index(cfg, timer)
        except BaseException:
            # don't orphan the counting helper (it would keep burning
            # CPU on a doomed run) or leak its temp spill dir
            if producer is not None:
                producer[0].kill()
                producer[0].wait()
                if producer[2]:
                    import shutil

                    shutil.rmtree(producer[1], ignore_errors=True)
            raise
        from .pipeline import save_index_async

        saver = save_index_async(index, path, cfg)  # write overlaps the call
        if producer is not None:
            _finish_count_producer(producer, cfg, timer)
    try:
        call(cfg, index, sys.stdout, timer)
    finally:
        if saver is not None:
            saver.join()
        if producer is not None and producer[2]:
            import shutil

            shutil.rmtree(producer[1], ignore_errors=True)
    timer.pelapsed("Execution completed")
    return 0


def _start_count_producer(cfg: Config):
    """Launch the spill-counting producer for the overlapped `run`, or
    None when overlap does not apply (KMC input, small reads, device
    counting, or MALVA_NO_OVERLAP=1).  Returns (Popen, spill_dir,
    spill_dir_is_temporary)."""
    import subprocess
    import tempfile

    if os.environ.get("MALVA_NO_OVERLAP"):
        return None
    if cfg.from_kmc_dump or cfg.from_kmc_db:
        return None
    try:
        nbytes = os.path.getsize(cfg.sample_path)
    except OSError:
        return None  # missing reads surface as the call phase's error
    # reads below this size count inline: the helper-process + disk-spill
    # overhead outweighs the overlap win
    if nbytes < int(os.environ.get("MALVA_OVERLAP_MIN_BYTES", 32 << 20)):
        return None
    from .pipeline import DEVICE_MIN_READ_BYTES, _resolve_backend

    if _resolve_backend(cfg, nbytes, DEVICE_MIN_READ_BYTES) != "host":
        return None  # device counting would contend for the chip
    import malva_tpu

    repo = os.path.dirname(os.path.dirname(os.path.abspath(malva_tpu.__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    is_tmp = not cfg.spill_dir
    spill_dir = cfg.spill_dir or _auto_spill_dir(nbytes)
    p = subprocess.Popen(
        [sys.executable, "-m", "malva_tpu.count.spill",
         cfg.sample_path, str(cfg.ref_k), spill_dir],
        env=env, stdout=subprocess.DEVNULL,  # parent stdout is pure VCF
    )
    print(
        f"[malva-tpu] counting overlapped with index build (spill {spill_dir})",
        file=sys.stderr,
    )
    return (p, spill_dir, is_tmp)


def _auto_spill_dir(reads_bytes: int) -> str:
    """Temp spill directory for the overlapped `run`'s counting helper.

    Prefers /dev/shm when the spill's upper bound fits comfortably: the
    block device on this VM class writes at ~100 MB/s (writeback
    throttling), tmpfs at >2 GB/s — a chr-scale producer spent 4 of its
    ~11 s in np.save against /tmp.  Spill volume is bounded by ~20 bytes
    per k-mer occurrence =~ 10x the FASTQ byte size; require 2x that
    bound free so the gate stays conservative.  Explicit --spill-dir is
    never overridden (bounded-memory runs belong on disk), and
    MALVA_SPILL_SHM=0 opts out."""
    import tempfile

    shm = "/dev/shm"
    if os.environ.get("MALVA_SPILL_SHM", "1") != "0":
        try:
            st = os.statvfs(shm)
            avail = st.f_bavail * st.f_frsize
            if reads_bytes * 20 < avail and os.access(shm, os.W_OK):
                return tempfile.mkdtemp(prefix="malva_spill_", dir=shm)
        except OSError:
            pass
    return tempfile.mkdtemp(prefix="malva_spill_")


def _finish_count_producer(producer, cfg: Config, timer: PhaseTimer) -> None:
    """Join the producer; on success the call phase consumes its spill
    store (resume skips straight to the merge), on failure fall back to
    inline counting (correctness never depends on the overlap)."""
    p, spill_dir, is_tmp = producer
    rc = p.wait()
    if rc != 0:
        print(
            f"[malva-tpu] overlapped counting failed (rc={rc}); "
            f"recounting inline", file=sys.stderr,
        )
        if is_tmp:
            import shutil

            shutil.rmtree(spill_dir, ignore_errors=True)
        return
    cfg.spill_dir = spill_dir
    timer.pelapsed("Sample k-mer counting (overlapped with index phase)")


def _try_save_index(index, path: str, cfg: Config, timer: PhaseTimer) -> None:
    """Persist the index `run`/`batch` just built so consecutive runs can
    reuse it (the MALVA driver's skip-if-exists intent, MALVA:113-118 —
    its check is broken upstream and the index is always rebuilt there).
    Save failure is not fatal: the in-memory index is still good."""
    try:
        save_index(index, path, cfg)
        timer.pelapsed("Index saved")
    except OSError as e:
        print(f"[malva-tpu] index not saved ({e}); continuing", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
