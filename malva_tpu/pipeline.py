"""End-to-end pipeline orchestration: index and call phases.

Mirrors the reference's two-phase structure (reference: main.cpp:251-419
index, main.cpp:421-594 call) with the external KMC dependency replaced by
the built-in counter (malva_tpu.count) and the on-disk index stored as an
npz of the Bloom/map arrays (rank rebuilt on load, like upstream).
"""

from __future__ import annotations

import functools
import os
import sys
from dataclasses import dataclass

import numpy as np

from .utils.errors import InputError

from .count.counter import count_reads_kmers, load_kmc_dump
from .index.bloom_filter import BF
from .index.kmap import KMAP
from .io.fasta import load_reference
from .io.vcf import cleaned_header, open_variant_reader
from .models.genotype import format_variants, genotype_block
from .utils import native
from .utils.config import Config
from .utils.timing import PhaseTimer
from .variants.blocks import VB
from .variants.variant import Variant


@dataclass
class Index:
    bf: BF
    ref_bf: KMAP
    context_bf: BF


# Work-size floors for auto device routing: below these, host numpy beats
# the device path's fixed costs (index upload to device memory, jit
# compiles, padded batches).  The values are inherited and not yet
# measured on the H100.
DEVICE_MIN_REF_POSITIONS = int(os.environ.get("MALVA_DEVICE_MIN_REF", 1 << 25))
DEVICE_MIN_KMERS = int(os.environ.get("MALVA_DEVICE_MIN_KMERS", 1 << 22))
DEVICE_MIN_READ_BYTES = int(os.environ.get("MALVA_DEVICE_MIN_READ_BYTES", 1 << 26))


def _resolve_backend(cfg: Config, work: int | None = None, floor: int = 0) -> str:
    """host or device.  auto -> device when JAX's platform is not cpu,
    the Bloom size fits the device modulo contract, and the work size
    clears the floor (device fixed costs need amortizing).  A JAX that
    fails to initialise raises: a broken accelerator is an error, not a
    reason to run on the host."""
    if cfg.backend == "host":
        return "host"
    if cfg.backend != "device":
        if work is not None and work < floor:
            return "host"
        import jax

        if jax.default_backend() == "cpu":
            return "host"
        ok_size = (cfg.bf_size >= (1 << 33) and cfg.bf_size % (1 << 33) == 0
                   and (cfg.bf_size >> 33) <= 8) or (
            cfg.bf_size & (cfg.bf_size - 1) == 0 and 32 <= cfg.bf_size <= (1 << 32)
        )
        if not ok_size:
            return "host"
    _announce_devices()
    return "device"


@functools.cache
def _announce_devices() -> None:
    """One stderr line naming the devices the first device route runs on."""
    import jax

    devs = jax.devices()
    print(
        f"[malva-tpu] device route: platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)}", file=sys.stderr,
    )


# Extraction batch size (variants per native extract_group call): blocks
# accumulate until this many variants, then one native call extracts the
# whole batch (OpenMP across blocks) and the flat result feeds both
# passes.  Bounds pass-2 GT-array retention to O(batch x samples).
EXTRACT_VARS = int(os.environ.get("MALVA_EXTRACT_VARS", 4096))


class FlatExtract:
    """Flat signature-extraction result for a batch of variant blocks.

    Replaces the per-block VK_GROUP dicts: one entry per (variant, allele)
    target holding ``tgt_nsig`` signatures; ``sig_nk`` k-mers per
    signature; k-mer byte strings concatenated in ``bytes`` with per-k-mer
    ``kmer_len``.  ``tgt_var`` indexes ``all_vars`` (the batch's
    concatenated variant list).  Within-signature k-mer order is
    preserved (the reference's incremental integer mean is
    order-dependent, main.cpp:162-181); signature order within an allele
    is free (coverage is a max over signatures)."""

    __slots__ = ("all_vars", "tgt_var", "tgt_allele", "tgt_nsig", "sig_nk",
                 "kmer_len", "bytes", "_starts", "_per_kmer_ref", "_slot_of",
                 "_n_slots")

    def __init__(self, all_vars, tgt_var, tgt_allele, tgt_nsig, sig_nk,
                 kmer_len, bytes_u8):
        self.all_vars = all_vars
        self.tgt_var = tgt_var
        self.tgt_allele = tgt_allele
        self.tgt_nsig = tgt_nsig
        self.sig_nk = sig_nk
        self.kmer_len = kmer_len
        self.bytes = bytes_u8
        self._starts = None

    def _derive(self):
        if self._starts is not None:
            return
        kl = self.kmer_len
        self._starts = np.zeros(kl.shape[0] + 1, dtype=np.int64)
        np.cumsum(kl, out=self._starts[1:])
        per_sig_ref = np.repeat(self.tgt_allele == 0, self.tgt_nsig)
        self._per_kmer_ref = np.repeat(per_sig_ref, self.sig_nk)
        nonempty = kl > 0
        self._slot_of = np.cumsum(nonempty, dtype=np.int64) - 1
        self._n_slots = int(self._slot_of[-1]) + 1 if kl.shape[0] else 0

    def length_groups(self):
        """Yield (is_ref, L, kmer_indices, (n, L) matrix) per (is_ref,
        length) class of nonempty k-mers."""
        self._derive()
        kl = self.kmer_len
        for L in np.unique(kl[kl > 0]).tolist():
            len_sel = kl == L
            for is_ref in (True, False):
                idxs = np.flatnonzero(len_sel & (self._per_kmer_ref == is_ref))
                if idxs.shape[0] == 0:
                    continue
                mat = self.bytes[self._starts[idxs][:, None] + np.arange(L)]
                yield is_ref, L, idxs, mat

    def slots(self, idxs):
        """Global occurrence slots (over nonempty k-mers) of kmer_indices."""
        return self._slot_of[idxs]

    @property
    def n_slots(self):
        self._derive()
        return self._n_slots

    def sig_lens(self):
        """Nonempty-k-mer count per signature (the coverage scan's run
        lengths; empty strings count 0 and are skipped, main.cpp:162)."""
        self._derive()
        if self.sig_nk.shape[0] == 0:
            return np.zeros(0, dtype=np.int64)
        # reduceat misbehaves on empty runs (returns the neighbor, and a
        # trailing empty run indexes OOB); both engines always emit >=1
        # k-mer per signature — keep that invariant explicit
        assert (self.sig_nk > 0).all(), "zero-length signature"
        sig_starts = np.zeros(self.sig_nk.shape[0], dtype=np.int64)
        np.cumsum(self.sig_nk[:-1], out=sig_starts[1:])
        nonempty = (self.kmer_len > 0).astype(np.int64)
        if nonempty.shape[0] == 0:
            return np.zeros(self.sig_nk.shape[0], dtype=np.int64)
        return np.add.reduceat(nonempty, sig_starts)


def _unique_rows(mat: np.ndarray):
    """(unique_rows, inverse) of a uint8 matrix via 1D void unique."""
    n, L = mat.shape
    if n == 0:
        return mat, np.zeros(0, dtype=np.int64)
    v = np.ascontiguousarray(mat).view(f"V{L}").ravel()
    uniq, inv = np.unique(v, return_inverse=True)
    return uniq.view(np.uint8).reshape(-1, L), inv


def _extract_batch_flat(batch, cfg: Config) -> FlatExtract:
    """[(variants, ref_bytes), ...] -> FlatExtract via the native engine
    (utils.native.extract_group), falling back to the per-block Python
    path (blocks.VB.extract_kmers) with identical semantics."""
    all_vars = [v for variants, _ in batch for v in variants]
    _resolve_gts(all_vars)  # deferred GT parse, one native batch
    res = native.extract_group(batch, cfg.k, cfg.haploid)
    if res is not None:
        tgt_var, tgt_allele, tgt_nsig, sig_nk, kmer_len, bytes_u8 = res
        return FlatExtract(all_vars, tgt_var, tgt_allele, tgt_nsig, sig_nk,
                           kmer_len, bytes_u8)
    tgt_var: list[int] = []
    tgt_allele: list[int] = []
    tgt_nsig: list[int] = []
    sig_nk: list[int] = []
    kmer_len: list[int] = []
    chunks: list[bytes] = []
    base = 0
    for variants, ref_bytes in batch:
        vb = VB(cfg.k, float(cfg.error_rate))
        vb.variants = list(variants)
        kmers = vb.extract_kmers(ref_bytes, cfg.haploid)
        for v_idx, per_allele in kmers.items():
            for allele_idx, sigs in per_allele.items():
                tgt_var.append(base + v_idx)
                tgt_allele.append(allele_idx)
                tgt_nsig.append(len(sigs))
                for sig in sigs:
                    sig_nk.append(len(sig))
                    for kmer in sig:
                        kmer_len.append(len(kmer))
                        chunks.append(kmer)
        base += len(variants)
    return FlatExtract(
        all_vars,
        np.asarray(tgt_var, dtype=np.int32),
        np.asarray(tgt_allele, dtype=np.int32),
        np.asarray(tgt_nsig, dtype=np.int32),
        np.asarray(sig_nk, dtype=np.int32),
        np.asarray(kmer_len, dtype=np.int32),
        np.frombuffer(b"".join(chunks), dtype=np.uint8),
    )


def _iter_extract_batches(cfg: Config, refs, keep_absent: bool,
                          used_out=None, timer=None, owned=None):
    """Yield FlatExtract per EXTRACT_VARS-bounded batch of flushed blocks.

    With ``owned`` (a ``batch_idx -> bool`` predicate, distributed VCF
    passes), yields ``(batch_idx, FlatExtract)`` for owned batches ONLY:
    unowned batches skip the GT parse and extraction entirely (their
    deferred sources are dropped) — batch boundaries derive from the
    cheap record scan alone, so every process sees identical numbering."""
    ref_bytes_cache: dict[int, bytes] = {}
    batch: list[tuple[list, bytes]] = []
    nv = 0
    bi = 0

    def emit(batch):
        nonlocal bi
        b = bi
        bi += 1
        if owned is None:
            yield _extract_batch_flat(batch, cfg)
        elif owned(b):
            yield b, _extract_batch_flat(batch, cfg)
        else:
            for variants, _ in batch:
                for v in variants:
                    v._gt_src = None  # release the raw records
    for vb, ref in _iter_blocks(cfg, refs, keep_absent, used_out, timer):
        # NOTE: setdefault would re-run tobytes() (a full contig copy)
        # on every block even on cache hits.
        ref_bytes = b"" if ref is None else ref_bytes_cache.get(id(ref))
        if ref_bytes is None:
            ref_bytes = ref_bytes_cache[id(ref)] = ref.tobytes()
        batch.append((vb.variants, ref_bytes))  # vb.clear() rebinds
        nv += len(vb.variants)
        if nv >= EXTRACT_VARS:
            yield from emit(batch)
            batch = []
            nv = 0
    if batch:
        yield from emit(batch)


# Record batch size for the batched GT parse (native.parse_gt_batch,
# OpenMP across records).
PARSE_RECS = int(os.environ.get("MALVA_PARSE_RECS", 1024))


class _GtCtx:
    """Shared deferred-GT context for one VCF reader: how to resolve the
    genotype arrays of a Variant constructed with skip_gt=True."""

    __slots__ = ("selected", "n_samples", "use_batch")

    def __init__(self, reader):
        self.selected = reader.selected
        self.n_samples = len(reader.sample_names)
        all_selected = list(self.selected) == list(range(self.n_samples))
        self.use_batch = all_selected and native.load() is not None


def _resolve_gts(variants: list) -> None:
    """Parse+decode the deferred GT regions of a batch of Variants in one
    native call (OpenMP across records; malva_parse_gt_batch).  Falls back
    to the per-record path for sample subsets (the upstream ploidy-1
    wrap-around quirk reads the NEXT SELECTED sample, variant.py:104-108 —
    the batch kernel decodes over the full sample set) and for records
    the batch kernel rejects.  GT parsing is the per-record hot cost at
    cohort scale (2,504 samples), so it runs ONLY for variants whose
    extraction batch is actually processed — the distributed VCF passes
    skip it entirely for batches owned by other processes."""
    pend = [(v, *v._gt_src) for v in variants if v._gt_src is not None]
    if not pend:
        return
    all_need = [(v, rec, gt_at) for v, _ctx, rec, gt_at in pend if gt_at >= 0]
    ctx = pend[0][1]
    # chunk the native calls: an extraction batch is EXTRACT_VARS records,
    # and at cohort width the decoded GT arrays are ~1 GB per 4096x28k
    # call — PARSE_RECS-sized pieces keep allocations bounded
    for lo in range(0, len(all_need), PARSE_RECS):
        need = all_need[lo : lo + PARSE_RECS]
        res = native.parse_gt_batch(
            [rec._samples_bytes() for _, rec, _ in need],
            [g for _, _, g in need], ctx.n_samples,
        ) if (need and ctx.use_batch) else None
        if res is None:
            for v, rec, _ in need:
                v._extract_genotypes(rec, ctx.selected)
        else:
            a1, a2, ph, ok = res
            for r, (v, rec, _) in enumerate(need):
                if ok[r]:
                    v.gt_a1 = a1[r]
                    v.gt_a2 = a2[r]
                    v.phase = ph[r]
                else:
                    v._extract_genotypes(rec, ctx.selected)
    for v, _ctx, rec, gt_at in pend:
        if gt_at < 0:
            v._extract_genotypes(rec, _ctx.selected)
        v._gt_src = None


def _iter_variants(cfg: Config, reader):
    """Yield Variant per VCF record with the GT parse DEFERRED: each
    variant carries a (ctx, record, gt_field_index) source and the
    consuming extraction batch resolves them in one native batch
    (_resolve_gts).  Everything block structure needs (positions, sizes,
    has_alts/is_present from the cheap INFO parse) is materialized here."""
    ctx = _GtCtx(reader)
    selected = ctx.selected

    for rec in reader:
        if cfg.strip_chr and rec.chrom.startswith("chr"):
            rec.chrom = rec.chrom[3:]
        v = Variant(rec, selected, cfg.freq_key, cfg.uniform, skip_gt=True)
        if v.has_alts and v.is_present:
            fmt = getattr(rec, "fmt", None)  # BCF records decode GT inline
            fmt_keys = fmt.split(":") if fmt is not None else []
            if fmt is None or not len(selected) or "GT" not in fmt_keys:
                # no GT data: genotypes_arrays returns None and has_alts
                # flips False (variant.hpp:169-174) — that gates BLOCK
                # structure, so it must resolve before blocks form
                v._extract_genotypes(rec, selected)
            else:
                gt_at = fmt_keys.index("GT") if ctx.use_batch else -1
                v._gt_src = (ctx, rec, gt_at)
        yield v


def _iter_blocks(
    cfg: Config,
    refs: dict[str, np.ndarray],
    keep_absent: bool,
    used_out: list[str] | None = None,
    timer: PhaseTimer | None = None,
):
    """Yield (vb, reference_array_or_None) per flushed variant block.

    keep_absent=False mirrors the index phase (skips !is_present records,
    main.cpp:332-333); True mirrors the call phase (main.cpp:539).
    ``used_out`` collects contig names with the reference's exact state
    machine (main.cpp:323-357): the first record's contig always, then a
    new contig only when a block flush observes the change — a contig
    whose single passing variant never triggers a flush is *not* recorded
    (upstream quirk, kept).
    """
    reader = open_variant_reader(cfg.vcf_path, cfg.samples)
    vb = VB(cfg.k, float(cfg.error_rate))
    last_seq_name = None
    i = 0
    for v in _iter_variants(cfg, reader):
        i += 1
        if timer is not None and i % 5000 == 0:
            # progress heartbeat with rollback (main.cpp:317-321)
            timer.pelapsed(f"Processed {i} variants", rollback=True)
        if last_seq_name is None:
            last_seq_name = v.seq_name
            if used_out is not None:
                used_out.append(last_seq_name)
        if not v.has_alts or (not keep_absent and not v.is_present):
            continue
        if vb.empty():
            vb.add_variant(v)
            continue
        if not vb.is_near_to_last(v) or last_seq_name != v.seq_name:
            yield vb, refs.get(last_seq_name)
            vb.clear()
            if last_seq_name != v.seq_name:
                last_seq_name = v.seq_name
                if used_out is not None:
                    used_out.append(last_seq_name)
        vb.add_variant(v)
    if not vb.empty():
        yield vb, refs.get(last_seq_name)
        vb.clear()


def build_index(cfg: Config, timer: PhaseTimer | None = None) -> Index:
    timer = timer or PhaseTimer()
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer.pelapsed("Reference processed")

    bf = BF(cfg.bf_size)
    ref_bf = KMAP()
    context_bf = BF(cfg.bf_size)

    used_names: list[str] = []
    n_vars = 0
    # add_kmers_to_bf (main.cpp:122-144): allele 0 k-mers go to the exact
    # map, alternate-allele k-mers to the Bloom filter.  Both adds are
    # idempotent/commutative, so duplicate k-mers need no uniquing here.
    for flat in _iter_extract_batches(cfg, refs, keep_absent=False,
                                      used_out=used_names, timer=timer):
        n_vars += len(flat.all_vars)
        for is_ref, _L, _idxs, mat in flat.length_groups():
            if is_ref:
                ref_bf.add_keys(mat)
            else:
                bf.add_keys(mat)
    timer.pelapsed(f"Processed variants ({n_vars} in blocks)")

    bf.switch_mode()
    fill = len(bf.counts) / max(bf.size, 1)
    print(
        f"[malva-tpu/metrics] alt-BF set bits {len(bf.counts)} "
        f"(fill {fill:.2e}, est FP rate {fill:.2e}); exact map keys {len(ref_bf)}",
        file=sys.stderr,
    )
    timer.pelapsed("BF creation complete")

    # Reference context scan (main.cpp:382-401): for every ref_k-window of
    # each used contig, if the centered k-mer hits bf, record the context.
    total_ref = sum(len(refs[n]) for n in set(used_names) if n in refs)
    if _resolve_backend(cfg, total_ref, DEVICE_MIN_REF_POSITIONS) == "device":
        import jax

        refs_used = [refs[n] for n in used_names if n in refs and len(refs[n]) > 0]
        tmp = Index(bf=bf, ref_bf=ref_bf, context_bf=context_bf)
        n_dev = len(jax.devices())
        if n_dev > 1 and (cfg.bf_size // 32) % n_dev == 0:
            # multi-chip index phase: contig chunks data-parallel, context
            # bits merged by word owner (parallel.sharded_index)
            from .parallel.mesh import make_mesh
            from .parallel.sharded_index import build_context_sharded

            build_context_sharded(tmp, refs_used, cfg, make_mesh(n_dev))
        else:
            from .index.device import build_context_device

            build_context_device(tmp, refs_used, cfg)
        timer.pelapsed("Reference BF creation complete (device)")
        context_bf.switch_mode()
        print(
            f"[malva-tpu/metrics] context-BF set bits {len(context_bf.counts)}",
            file=sys.stderr,
        )
        return Index(bf=bf, ref_bf=ref_bf, context_bf=context_bf)
    off = cfg.center_off
    for seq_name in used_names:
        ref = refs.get(seq_name)
        if ref is None or len(ref) == 0:
            continue
        L = len(ref)
        if L < cfg.ref_k:
            # upstream clamps the initial substrings for short contigs
            if L > off:
                sub = ref[off : off + cfg.k][None, :]
                if bf.test_keys(sub)[0]:
                    context_bf.add_keys(ref[: cfg.ref_k][None, :])
            continue
        n_pos = L - cfg.ref_k + 1
        chunk = 1 << 20
        for start in range(0, n_pos, chunk):
            stop = min(start + chunk, n_pos)
            windows = np.lib.stride_tricks.sliding_window_view(
                ref[start : stop + cfg.ref_k - 1], cfg.ref_k
            )
            centers = windows[:, off : off + cfg.k]
            hits = bf.test_keys(centers)
            if hits.any():
                context_bf.add_keys(np.ascontiguousarray(windows[hits]))
    timer.pelapsed("Reference BF creation complete")

    context_bf.switch_mode()
    print(
        f"[malva-tpu/metrics] context-BF set bits {len(context_bf.counts)}",
        file=sys.stderr,
    )
    return Index(bf=bf, ref_bf=ref_bf, context_bf=context_bf)


def save_index(index: Index, path: str, cfg: Config | None = None) -> None:
    st = _index_state(index)
    _add_meta(st, cfg)
    _save_state(st, path)


def _add_meta(st: dict, cfg: Config | None) -> None:
    if cfg is None:
        return
    import json

    st["meta_json"] = np.frombuffer(
        json.dumps(index_fingerprint(cfg), default=str).encode(),
        dtype=np.uint8,
    )


def save_index_async(index: Index, path: str, cfg: Config | None = None):
    """Write a freshly BUILT index in a background thread (the write
    overlaps the call phase in `run`).  Counter planes are snapshotted as
    zeros — they are zero right after build, and the call phase mutates
    them in place, while a saved index must carry pristine counters.
    Returns the thread (join before exiting); write failures log one
    stderr line (the in-memory index is still good)."""
    import threading

    st = _index_state(index)
    _add_meta(st, cfg)
    for k in ("bf_counts", "ctx_counts", "kmap_vals"):
        if k in st:
            st[k] = np.zeros_like(st[k])

    def write():
        try:
            _save_state(st, path)
        except OSError as e:
            print(f"[malva-tpu] index not saved ({e}); continuing",
                  file=sys.stderr)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


_INDEX_META_FIELDS = ("bf_size", "samples", "freq_key", "uniform",
                      "haploid", "strip_chr", "fasta_path")


def _index_state(index: Index) -> dict:
    st = {}
    for name, obj in [("bf", index.bf), ("ctx", index.context_bf)]:
        for k, v in obj.state().items():
            st[f"{name}_{k}"] = v
    for k, v in index.ref_bf.state().items():
        st[f"kmap_{k}"] = v
    return st


def index_fingerprint(cfg: Config) -> dict:
    """The config fields that change index CONTENT (beyond the k/ref_k
    already encoded in the file name): Bloom geometry, sample subset,
    frequency key and flags that gate which k-mers are inserted."""
    return {f: getattr(cfg, f) for f in _INDEX_META_FIELDS}


def index_matches_config(path: str, cfg: Config):
    """(ok, why): whether a persisted index's fingerprint matches this
    run's config.  Index files predating the fingerprint (or external
    .zst imports) return ok — the caller keeps the upstream
    name-only contract for those."""
    import json
    import zipfile

    try:
        with zipfile.ZipFile(path) as zf:
            if "meta_json.npy" not in zf.namelist():
                return True, "no fingerprint (pre-round-5 index)"
            import io as _io

            arr = np.lib.format.read_array(
                _io.BytesIO(zf.read("meta_json.npy")), allow_pickle=False
            )
            meta = json.loads(bytes(arr).decode())
    except Exception as e:  # unreadable file: let load_index report it
        return True, f"fingerprint unreadable ({e})"
    want = index_fingerprint(cfg)
    for f, v in want.items():
        if f in meta and meta[f] != v:
            return False, f"{f}: {meta[f]!r} != {v!r}"
    return True, "match"


def _save_state(st: dict, path: str) -> None:
    # The Bloom word arrays are GiB-sized and mostly zero at any realistic
    # fill; zlib-inflating them dominated index load (23 s for a -b 1 pair
    # at chr scale).  Store them sparse (nonzero index + value), and write
    # the npz with per-member compression: the sparse word members STORED
    # (high-entropy, incompressible), everything else (kmap_keys is
    # ~270 MB of ACGT text at chr scale) DEFLATED at level 1.
    out = {}
    stored = set()
    for k, v in st.items():
        if k.endswith("_words"):
            nz = np.flatnonzero(v)
            out[k + "_nz"] = nz.astype(np.int64)
            out[k + "_nzv"] = np.asarray(v)[nz]
            out[k + "_len"] = np.int64(v.shape[0])
            stored.update((k + "_nz", k + "_nzv", k + "_len"))
        else:
            out[k] = v
    _write_npz_mixed(path, out, stored)


def _write_npz_mixed(path: str, arrays: dict, stored: set) -> None:
    """npz writer with per-member compression (numpy's savez is all-or-
    nothing).  np.load reads the result like any other npz."""
    import io
    import zipfile

    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", allowZip64=True) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arr), allow_pickle=False)
            if name in stored:
                zf.writestr(name + ".npy", buf.getvalue(),
                            compress_type=zipfile.ZIP_STORED)
            else:
                zf.writestr(name + ".npy", buf.getvalue(),
                            compress_type=zipfile.ZIP_DEFLATED, compresslevel=1)
    os.replace(tmp, path)  # atomic: a crashed writer leaves no index


def load_index(path: str) -> Index:
    import zipfile

    try:
        raw = dict(np.load(path))
        return _index_from_raw(raw)
    except (zipfile.BadZipFile, KeyError, ValueError, EOFError, OSError) as e:
        if isinstance(e, FileNotFoundError):
            raise
        raise InputError(
            f"{path}: not a valid malva index (truncated or corrupt: {e}); "
            f"re-run `malva-tpu index`"
        ) from e


def _index_from_raw(raw: dict) -> Index:
    st = {}
    for k, v in raw.items():
        if k.endswith("_words_nz"):
            base = k[: -len("_nz")]
            nzv = raw[base + "_nzv"]
            dense = np.zeros(int(raw[base + "_len"]), dtype=nzv.dtype)
            dense[v] = nzv
            st[base] = dense
        elif k.endswith("_words_nzv") or k.endswith("_words_len"):
            continue
        else:
            st[k] = v  # incl. dense "_words" from pre-sparse index files
    return Index(
        bf=BF.from_state(st, "bf_"),
        context_bf=BF.from_state(st, "ctx_"),
        ref_bf=KMAP.from_state(st, "kmap_"),
    )


def apply_sample_counts(
    index: Index, contexts: np.ndarray, counts: np.ndarray, cfg: Config
) -> None:
    """KMC-scan equivalent (main.cpp:487-500): for each distinct canonical
    context, add its count to the exact map always and to the alt Bloom
    filter only when the context is not a known reference context.

    ``contexts`` may be 2-bit packed uint64 rows (the counter's output
    contract: canonical, pure-ACGT) — those take the fused native path
    (no ASCII matrices ever materialize); ASCII rows (external dumps, may
    be non-canonical / non-ACGT) take the general path."""
    if contexts.dtype == np.uint64 and _apply_packed_host(
        index, contexts, counts, cfg
    ):
        return
    contexts = _as_ascii(contexts, cfg.ref_k)
    off = cfg.center_off
    centers = np.ascontiguousarray(contexts[:, off : off + cfg.k])
    index.ref_bf.increment_keys(centers, counts)
    ctx_known = index.context_bf.test_keys(contexts)
    sel = ~ctx_known
    index.bf.increment_keys(centers[sel], counts[sel])


def _apply_packed_host(
    index: Index, packed: np.ndarray, counts: np.ndarray, cfg: Config
) -> bool:
    """Packed fast path of :func:`apply_sample_counts`: one fused native
    pass computes (context hash, canonical-center hash, packed canonical
    center) per row; the Bloom updates run on hashes and the exact-map
    increments on packed binary search.  Returns False when the native
    library is unavailable (caller falls back to the ASCII path)."""
    res = native.apply_ctx_packed(packed, cfg.ref_k, cfg.k)
    if res is None:
        return False
    ctx_h, cen_h, cen_pk = res
    if not index.ref_bf.increment_packed(cen_pk, counts, cfg.k):
        return False
    if native.bf_apply_hashed(index.context_bf, index.bf, ctx_h, cen_h, counts):
        return True  # fused ctx-test + counter increment, one native pass
    ctx_known = index.context_bf.test_hashed(ctx_h)
    sel = ~ctx_known
    index.bf.increment_hashed(cen_h[sel], np.asarray(counts)[sel])
    return True


def _set_coverages_flat(index: Index, flat: FlatExtract) -> None:
    """main.cpp:151-184 over a FlatExtract batch: per-allele coverage =
    max over signatures of the incremental integer mean of the nonzero
    k-mer counts.  Queries are issued as one batch per (is_ref, length)
    over the UNIQUE k-mers; the sequential mean/max scan runs in the
    native kernel (malva_coverage)."""
    w_flat = np.zeros(flat.n_slots, dtype=np.int64)
    for is_ref, _L, idxs, mat in flat.length_groups():
        uarr, inv = _unique_rows(mat)
        vals = (
            index.ref_bf.get_counts(uarr)
            if is_ref
            else index.bf.get_counts(uarr).astype(np.int64)
        )
        w_flat[flat.slots(idxs)] = vals[inv]
    _scan_and_assign(w_flat, flat)


def _scan_and_assign(w_flat: np.ndarray, flat: FlatExtract) -> None:
    """Mean/max coverage scan over resolved k-mer weights + write-back
    into the Variant objects (main.cpp:162-181 semantics)."""
    sl = flat.sig_lens()
    an = np.asarray(flat.tgt_nsig, dtype=np.int64)
    cov = native.coverage(w_flat, sl, an)
    if cov is None:  # pure-Python mirror of native/host_kernels.cpp
        cov = np.zeros(an.shape[0], dtype=np.int64)
        sig_off = np.concatenate([[0], np.cumsum(sl)])
        s = 0
        for a, nsig in enumerate(an.tolist()):
            best = 0
            for _ in range(nsig):
                curr = 0
                n = 0
                for w in w_flat[sig_off[s] : sig_off[s + 1]].tolist():
                    if w > 0:
                        curr = (curr * n + w) // (n + 1)
                        n += 1
                s += 1
                if curr > best:
                    best = curr
            cov[a] = best
    all_vars = flat.all_vars
    for vi, ai, c in zip(flat.tgt_var.tolist(), flat.tgt_allele.tolist(),
                         cov.tolist()):
        if ai >= 0:
            all_vars[vi].set_coverage(ai, c)


def _flat_query_info(index: Index, flat: FlatExtract) -> list:
    """Sample-independent resolution of a FlatExtract's unique queries:
    Bloom bit/rank lookups, exact-map slot lookups — everything that does
    NOT touch counter values.  Batch mode runs this once per group and
    answers each sample from its counter PLANE (uint16 BF counters +
    uint32 KMAP values, see call_batch)."""
    qs = []
    for is_ref, _L, idxs, mat in flat.length_groups():
        uarr, inv = _unique_rows(mat)
        slots_a = flat.slots(idxs)
        if is_ref:
            found, kslot = index.ref_bf.get_slots(uarr)
            qs.append((True, slots_a, inv, found, kslot))
        else:
            is_set, cnt_idx = index.bf.count_slots(uarr)
            qs.append((False, slots_a, inv, is_set, cnt_idx))
    return [qs, flat.n_slots]


def _weights_from_planes(qinfo: list, bf_plane: np.ndarray,
                         kmap_plane: np.ndarray) -> np.ndarray:
    """Per-sample weight assembly from a resolved query set: gather the
    plane values (BF counters mod 2^16; KMAP values reinterpreted signed,
    as KMAP.get_counts does)."""
    qs, slot = qinfo
    w_flat = np.zeros(slot, dtype=np.int64)
    for is_ref, slots_a, uidx_a, found, idx in qs:
        vals = np.zeros(found.shape[0], dtype=np.int64)
        if is_ref:
            vals[found] = kmap_plane[idx[found]].astype(np.int32)
        else:
            vals[found] = bf_plane[idx[found]]
        w_flat[slots_a] = vals[uidx_a]
    return w_flat


def _prefetch(it, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue: the
    spill merge (disk reads + native sort/merge, GIL-released) overlaps
    the counter application (native scatter/search) instead of
    serializing bucket-by-bucket.

    The worker starts EAGERLY (on call, not on first next()): callers
    create the pass-2 extraction pipeline before the counting phase so
    its producer packs otherwise-idle cycles (extraction never reads the
    counter planes, only `_set_coverages_flat` on the consumer side
    does)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: list = []

    def worker():
        try:
            for x in it:
                q.put(x)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def gen():
        while True:
            x = q.get()
            if x is done:
                break
            yield x
        t.join()
        if err:
            raise err[0]

    return gen()


def call(cfg: Config, index: Index, out=sys.stdout, timer: PhaseTimer | None = None) -> None:
    timer = timer or PhaseTimer()
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer.pelapsed("Reference processed")

    # pass-2 extraction starts NOW, overlapped with the counting phase:
    # its producer (record scan + GT parse + native extraction) never
    # reads the counter planes — only the coverage/genotyping consumer
    # does, and that consumer starts after counting below.  The bounded
    # queue caps memory at ~depth extraction batches; in bounded-memory
    # spill mode (kmc -m4 RAM parity is the point) the default depth
    # shrinks so the queue stays small against the counting high-water
    # mark.
    pass2_depth = int(os.environ.get(
        "MALVA_PASS2_PREFETCH", 8 if cfg.spill_dir else 32))
    pass2 = _prefetch(_iter_pass2_batches(cfg, refs), depth=pass2_depth)

    if cfg.spill_dir and not (cfg.from_kmc_dump or cfg.from_kmc_db):
        # bounded-memory counting: distinct k-mers stream bucket-by-bucket
        # from disk, never materializing in RAM (kmc -m4 parity)
        from .count.spill import count_reads_kmers_spill

        try:
            nbytes = os.path.getsize(cfg.sample_path)
        except OSError:
            nbytes = 0
        on_device = (
            _resolve_backend(cfg, nbytes, DEVICE_MIN_READ_BYTES) == "device"
        )
        batches = count_reads_kmers_spill(
            cfg.sample_path, cfg.ref_k, cfg.spill_dir,
            use_device=on_device,
        )
        mesh = _call_mesh(cfg, nbytes, DEVICE_MIN_READ_BYTES)
        if mesh is not None:
            from .parallel.sharded_index import apply_sample_counts_sharded_stream

            apply_sample_counts_sharded_stream(index, batches, cfg, mesh)
        elif on_device:
            from .index.device import apply_sample_counts_stream

            apply_sample_counts_stream(index, batches, cfg)
        else:
            for keys, cnts in _prefetch(batches):
                apply_sample_counts(index, keys, cnts, cfg)
        timer.pelapsed("Sample k-mer counting + BF weights (spill"
                       + (", device)" if on_device else ")"))
    elif cfg.from_kmc_dump or cfg.from_kmc_db:
        _apply_kmc_stream(cfg, index, cfg.sample_path)
        timer.pelapsed("Sample k-mer stream + BF weights")
    else:
        contexts, counts = _sample_kmers(cfg, cfg.sample_path)
        timer.pelapsed("Sample k-mer counting")
        mesh = _call_mesh(cfg, contexts.shape[0], DEVICE_MIN_KMERS)
        route = ""
        if mesh is not None:
            from .parallel.sharded_index import apply_sample_counts_sharded_stream

            apply_sample_counts_sharded_stream(
                index, [(contexts, counts)], cfg, mesh
            )
            route = f" (device, {mesh.size}-device mesh)"
        elif _resolve_backend(cfg, contexts.shape[0], DEVICE_MIN_KMERS) == "device":
            from .index.device import apply_sample_counts_device

            apply_sample_counts_device(index, contexts, counts, cfg)
            route = " (device)"
        else:
            apply_sample_counts(index, contexts, counts, cfg)
        timer.pelapsed("BF weights created" + route)

    _genotype_and_emit(cfg, index, refs, out, timer, batches=pass2)


def _kmc_batches(cfg: Config, path: str):
    """Stream an external KMC artifact (text dump or binary DB) as
    (contexts_ascii, counts) batches — never materializing the distinct
    set (a WGS dump/database is tens of GB)."""
    if cfg.from_kmc_dump:
        from .count.counter import iter_kmc_dump

        return iter_kmc_dump(path, cfg.ref_k)
    from .io.kmc import iter_kmc_db, read_kmc_pre

    _, info = read_kmc_pre(path)
    if info["kmer_length"] != cfg.ref_k:
        raise InputError(
            f"KMC database k={info['kmer_length']} != ref_k {cfg.ref_k}"
        )
    return iter_kmc_db(path)


def _kmc_est_kmers(cfg: Config, path: str) -> int:
    """Estimated k-mer count of an external KMC artifact (device routing)."""
    if cfg.from_kmc_db:
        from .io.kmc import read_kmc_pre

        return int(read_kmc_pre(path)[1]["total_kmers"])
    try:
        return os.path.getsize(path) // (cfg.ref_k + 4)
    except OSError:
        return 0


def _call_mesh(cfg: Config, work: int, floor: int):
    """Mesh for the multi-chip call step, or None (single device, host
    routing, or Bloom word count not divisible across devices).  Mirrors
    the index phase's multi-chip routing in build_index."""
    if _resolve_backend(cfg, work, floor) != "device":
        return None
    import jax

    n = len(jax.devices())
    if n > 1 and (cfg.bf_size // 32) % n == 0:
        from .parallel.mesh import make_mesh

        return make_mesh(n)
    return None


def _apply_kmc_stream(cfg: Config, index: Index, path: str, dev=None) -> None:
    est = _kmc_est_kmers(cfg, path)
    batches = _kmc_batches(cfg, path)
    mesh = None if dev is not None else _call_mesh(cfg, est, DEVICE_MIN_KMERS)
    if mesh is not None:
        from .parallel.sharded_index import apply_sample_counts_sharded_stream

        apply_sample_counts_sharded_stream(index, batches, cfg, mesh)
    elif _resolve_backend(cfg, est, DEVICE_MIN_KMERS) == "device":
        from .index.device import apply_sample_counts_stream

        apply_sample_counts_stream(index, batches, cfg, dev=dev)
    else:
        for contexts, counts in batches:
            apply_sample_counts(index, contexts, counts, cfg)


def _sample_kmers(cfg: Config, path: str):
    """-> (contexts, counts); contexts is 2-bit packed uint64 from the
    built-in counter, or ASCII uint8 from an external KMC dump (which may
    contain non-canonical/non-ACGT rows the packed form can't carry)."""
    if cfg.from_kmc_dump:
        return load_kmc_dump(path, cfg.ref_k)
    if cfg.from_kmc_db:
        from .io.kmc import load_kmc_db

        return load_kmc_db(path, cfg.ref_k)
    try:
        nbytes = os.path.getsize(path)
    except OSError:
        nbytes = 0
    use_device = _resolve_backend(cfg, nbytes, DEVICE_MIN_READ_BYTES) == "device"
    return count_reads_kmers(path, cfg.ref_k, use_device=use_device, return_packed=True)


def _as_ascii(contexts: np.ndarray, ref_k: int) -> np.ndarray:
    from .ops.seq import unpack_2bit

    return unpack_2bit(contexts, ref_k) if contexts.dtype == np.uint64 else contexts


def _genotype_and_emit(cfg: Config, index: Index, refs, out,
                       timer: PhaseTimer, batches=None) -> None:
    reader = open_variant_reader(cfg.vcf_path, cfg.samples)
    out.write(cleaned_header(reader.meta_lines, cfg.verbose))

    n = 0
    # prefetch: the producer side (record scan + GT parse + native
    # extraction) overlaps the consumer side (coverage queries +
    # genotyping + formatting) — both halves spend most of their time in
    # GIL-releasing native kernels, so the Python halves hide behind
    # them.  ``batches`` may be a prefetch started earlier (call() hands
    # one over so extraction overlaps the counting phase too).
    if batches is None:
        batches = _prefetch(_iter_pass2_batches(cfg, refs))
    for flat in batches:
        _set_coverages_flat(index, flat)
        genotype_block(flat.all_vars, cfg.max_coverage, cfg.haploid,
                       cfg.error_rate)
        for line in format_variants(flat.all_vars, cfg.haploid, cfg.verbose):
            out.write(line + "\n")
        n += len(flat.all_vars)
    timer.pelapsed(f"VCF parsing and genotyping ({n} variants)")


_EMPTY_I32 = np.zeros(0, dtype=np.int32)
_EMPTY_BOOL = np.zeros(0, dtype=bool)


def _iter_pass2_batches(cfg: Config, refs):
    """Yield call-phase FlatExtract batches with the GT arrays dropped.

    GT arrays are consumed by extraction (haplotype enumeration);
    genotyping/output need only frequencies+coverages.  Dropping them
    right after each extraction batch keeps retention O(batch), not
    O(variants x samples) — at 1000G shape (2,504 samples) they are
    ~22 KB per variant (reference streams pass 2 in O(block),
    main.cpp:517-579)."""
    for flat in _iter_extract_batches(cfg, refs, keep_absent=True):
        for v in flat.all_vars:
            v.gt_a1 = v.gt_a2 = _EMPTY_I32
            v.phase = _EMPTY_BOOL
        yield flat


def _reset_counters(index: Index) -> None:
    index.bf.counts[:] = 0
    for k in index.ref_bf.kmers:
        index.ref_bf.kmers[k] = 0


def call_batch(
    cfg: Config,
    index: Index,
    sample_paths: list[str],
    outs: list,
    timer: PhaseTimer | None = None,
) -> None:
    """Multi-sample batch genotyping: N read sets against ONE index
    (BASELINE.json config 5).  Everything shareable is shared:

    * the index (the expensive artifact) is built/loaded once and its
      device upload is reused across samples;
    * phase A streams each sample's distinct k-mers through the query
      step into a per-sample COUNTER PLANE: uint16 rank-compressed BF
      counters (the mod-2^16 wrap is applied at read anyway) + a uint32
      exact-map value array in key order — 2 B/set-bit + 4 B/key per
      sample instead of a u32 array + full dict copy, so an N-sample
      batch stays within a fixed RAM budget even at WGS fill;
    * phase B makes ONE pass over the VCF — variant blocks are parsed,
      their signature k-mers extracted, and every query resolved to
      (bf counter index | kmap slot) ONCE per group; each sample then
      only gathers its plane values (no re-hashing per sample).

    Counter state is per-sample by construction (zeroed planes), so
    results are byte-identical to N independent `call` runs — amortizing
    the VCF parse and the 2^n signature combinatorics across samples is
    pure reuse, not a semantic change.  The index's counter state is
    unspecified after this returns."""
    timer = timer or PhaseTimer()
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer.pelapsed("Reference processed")

    # phase A: per-sample counter planes
    dev = None  # device index uploaded once, reused across samples
    planes: list[tuple[np.ndarray, dict]] = []
    for sample_path in sample_paths:
        _reset_counters(index)
        if cfg.from_kmc_dump or cfg.from_kmc_db:
            est = _kmc_est_kmers(cfg, sample_path)
            mesh = _call_mesh(cfg, est, DEVICE_MIN_KMERS)
            if mesh is not None:
                # multi-chip: stream through the routed sharded session
                # (mirrors call(); _apply_kmc_stream routes when dev=None)
                _apply_kmc_stream(cfg, index, sample_path)
            else:
                if dev is None and _resolve_backend(
                    cfg, est, DEVICE_MIN_KMERS
                ) == "device":
                    from .index.device import DeviceIndex

                    dev = DeviceIndex.from_host(index, cfg)
                _apply_kmc_stream(cfg, index, sample_path, dev=dev)
        else:
            contexts, counts = _sample_kmers(cfg, sample_path)
            mesh = _call_mesh(cfg, contexts.shape[0], DEVICE_MIN_KMERS)
            if mesh is not None:
                from .parallel.sharded_index import (
                    apply_sample_counts_sharded_stream,
                )

                apply_sample_counts_sharded_stream(
                    index, [(contexts, counts)], cfg, mesh
                )
            elif _resolve_backend(cfg, contexts.shape[0], DEVICE_MIN_KMERS) == "device":
                from .index.device import DeviceIndex, apply_sample_counts_device

                if dev is None:
                    dev = DeviceIndex.from_host(index, cfg)
                apply_sample_counts_device(index, contexts, counts, cfg, dev=dev)
            else:
                apply_sample_counts(index, contexts, counts, cfg)
        planes.append((
            index.bf.counts.astype(np.uint16),  # truncation == mod 2^16
            index.ref_bf.snapshot_values(),
        ))
        timer.pelapsed(f"Counters ready: {sample_path}")

    # phase B: one VCF pass, all samples
    reader = open_variant_reader(cfg.vcf_path, cfg.samples)
    header = cleaned_header(reader.meta_lines, cfg.verbose)
    for out in outs:
        out.write(header)
    n = 0
    for flat in _prefetch(_iter_pass2_batches(cfg, refs)):
        qinfo = _flat_query_info(index, flat)  # resolve queries ONCE
        for (bf_plane, kmap_plane), out in zip(planes, outs):
            for v in flat.all_vars:
                v.computed_gts = []
            _scan_and_assign(_weights_from_planes(qinfo, bf_plane, kmap_plane),
                             flat)
            genotype_block(flat.all_vars, cfg.max_coverage, cfg.haploid,
                           cfg.error_rate)
            for line in format_variants(flat.all_vars, cfg.haploid, cfg.verbose):
                out.write(line + "\n")
        n += len(flat.all_vars)
    timer.pelapsed(f"VCF parsing and genotyping ({n} variants x {len(planes)} samples)")
