"""Bounded-memory k-mer counting via disk spill — `kmc -m4` parity.

The in-RAM counter (count.counter) keeps every distinct canonical
ref_k-mer in host memory: fine up to cohort scale, impossible for a 30x
whole-genome read set (billions of distinct keys, mostly error
singletons).  The reference sidesteps this by shelling out to KMC with a
4 GB budget and disk spill (reference: MALVA:107 `kmc -m4`); this module
is the built-in equivalent:

1. **Distribute**: reads stream through the existing chunk counter
   (canonicalize + pack + sort + run-length — device or host), and each
   chunk's sorted distinct (key, count) runs are partitioned by a
   multiplicative hash of the packed key into N_BUCKETS spill buckets,
   written as one segment file trio per flush (keys/counts/offsets .npy,
   committed atomically via rename).
2. **Merge**: per bucket, the slices of every segment are mmap-loaded,
   concatenated, sorted, and run-length-summed; ci/cs apply per bucket.
   Peak RAM is O(total_spilled / N_BUCKETS), independent of the genome.

The result streams out bucket by bucket (an iterator of
(keys_u64, counts) batches) so the full distinct set never materializes
in RAM either — the call phase feeds the batches straight into the
device step.

Checkpoint/resume: a manifest (json, atomic rename) records the number
of committed segments and the read-batch cursor, advanced only at read
batch boundaries; on resume, segment files beyond the manifest count are
deleted (they came from a partially processed batch) and streaming
restarts at the cursor.  Batch segmentation is deterministic, so a
resumed count is byte-identical to a clean one.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..io.fasta import iter_read_batches
from ..ops.seq import upper
from .counter import _native_reads_available, _windows_of_read, _sorted_counts
from .device_count import device_seq_sorted_counts

# multiplicative spill-bucket hash over the packed words (canonical
# k-mers are NOT uniform in their prefix — never partition by raw bits)
_MIX = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xC2B2AE3D27D4EB4F),
        np.uint64(0x165667B19E3779F9), np.uint64(0x27D4EB2F165667C5))


def _bucket_of(keys_u64: np.ndarray, n_buckets: int) -> np.ndarray:
    if n_buckets <= 1:  # a 64-bit shift is platform-undefined
        return np.zeros(keys_u64.shape[0], dtype=np.int64)
    h = np.zeros(keys_u64.shape[0], dtype=np.uint64)
    for j in range(keys_u64.shape[1]):
        h ^= keys_u64[:, j] * _MIX[j % len(_MIX)]
    h *= _MIX[0]
    return (h >> np.uint64(64 - int(n_buckets).bit_length() + 1)).astype(np.int64)


class SpillStore:
    """Segmented on-disk (key, count) run store, partitioned by bucket."""

    def __init__(self, dirpath: str, n_buckets: int = 1024):
        assert n_buckets & (n_buckets - 1) == 0
        self.dir = dirpath
        self.n_buckets = n_buckets
        self.n_seg = 0
        os.makedirs(dirpath, exist_ok=True)

    def _seg_paths(self, i: int):
        return (os.path.join(self.dir, f"seg{i:06d}.keys.npy"),
                os.path.join(self.dir, f"seg{i:06d}.cnts.npy"),
                os.path.join(self.dir, f"seg{i:06d}.offs.npy"))

    def add_segment(self, keys: np.ndarray, cnts: np.ndarray) -> None:
        """Partition one chunk's distinct runs by bucket and commit as a
        segment (atomic: tmp files + rename, offsets last)."""
        from ..utils import native

        part = native.bucket_partition(keys, cnts, self.n_buckets)
        if part is not None:  # one native O(n) stable scatter
            keys, cnts, offs = part
        else:
            b = _bucket_of(keys, self.n_buckets)
            order = np.argsort(b, kind="stable")
            keys = keys[order]
            cnts = np.asarray(cnts)[order].astype(np.uint32)
            offs = np.zeros(self.n_buckets + 1, dtype=np.int64)
            np.add.at(offs, b + 1, 1)
            offs = np.cumsum(offs)
        pk, pc, po = self._seg_paths(self.n_seg)
        for path, arr in [(pk, keys), (pc, cnts), (po, offs)]:
            np.save(path + ".tmp.npy", arr)
            os.replace(path + ".tmp.npy", path)
        self.n_seg += 1

    def drop_segments_from(self, n: int) -> None:
        i = n
        while True:
            paths = self._seg_paths(i)
            if not any(os.path.exists(p) for p in paths):
                break
            for p in paths:
                if os.path.exists(p):
                    os.remove(p)
            i += 1
        self.n_seg = n

    # Records held in RAM at once during the merge (per bucket-GROUP, see
    # iter_merged).  16B/record u64-pair keys + 4B counts -> ~320 MB.
    MERGE_GROUP_RECORDS = 1 << 24

    def iter_merged(self, ci: int, cs: int):
        """Yield (keys_u64, counts_u32) per spill bucket, ci/cs applied.

        File handles are NOT held open across the merge: a real-WGS run
        makes thousands of segments (3-Gbase demo: ~210; a 30x human
        genome: >6,000) and 2 handles each would blow the default 1024-FD
        ulimit.  Instead, consecutive buckets are batched into GROUPS
        bounded by MERGE_GROUP_RECORDS, and per group each segment is
        opened once, its group byte-range read sequentially, and closed —
        peak FDs O(1), peak RAM O(group), and the reads are larger and
        sequential (friendlier than per-bucket seeks)."""
        from .counter import _merge_runs

        # offsets first (n_seg x (n_buckets+1) int64 — tiny), handles closed
        offs = []
        for i in range(self.n_seg):
            offs.append(np.load(self._seg_paths(i)[2]))
        per_bucket = np.zeros(self.n_buckets, dtype=np.int64)
        for o in offs:
            per_bucket += np.diff(o)

        def read_rows(path, lo, hi, flat=False):
            with open(path, "rb") as f:
                version = np.lib.format.read_magic(f)
                reader = (np.lib.format.read_array_header_1_0
                          if version == (1, 0)
                          else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = reader(f)
                assert not fortran
                w = shape[1] if len(shape) > 1 else 1
                f.seek(lo * dtype.itemsize * w, os.SEEK_CUR)
                raw = f.read((hi - lo) * dtype.itemsize * w)
            a = np.frombuffer(raw, dtype=dtype)
            return a if flat else a.reshape(-1, w)

        b = 0
        while b < self.n_buckets:
            # group [b, b_hi): at least one bucket, capped by record budget
            b_hi = b + 1
            total = int(per_bucket[b])
            while (b_hi < self.n_buckets
                   and total + per_bucket[b_hi] <= self.MERGE_GROUP_RECORDS):
                total += int(per_bucket[b_hi])
                b_hi += 1
            if total == 0:
                b = b_hi
                continue

            # one sequential read per segment for the whole group
            group_parts: list[list] = [[] for _ in range(b_hi - b)]
            for i in range(self.n_seg):
                o = offs[i]
                lo, hi = int(o[b]), int(o[b_hi])
                if lo == hi:
                    continue
                pk, pc, _ = self._seg_paths(i)
                keys = read_rows(pk, lo, hi)
                cnts = read_rows(pc, lo, hi, flat=True)
                for j in range(b_hi - b):
                    s, e = int(o[b + j]) - lo, int(o[b + j + 1]) - lo
                    if s < e:
                        group_parts[j].append(
                            (keys[s:e], cnts[s:e].astype(np.int64))
                        )

            for j in range(b_hi - b):
                runs = group_parts[j]
                if not runs:
                    continue
                # each slice is a sorted distinct run (chunks were sorted
                # and the bucket partition is stable) -> tree-fold of
                # linear merges instead of a full re-sort
                while len(runs) > 1:
                    nxt = []
                    for i in range(0, len(runs) - 1, 2):
                        nxt.append(_merge_runs(runs[i][0], runs[i][1],
                                               runs[i + 1][0], runs[i + 1][1]))
                    if len(runs) & 1:
                        nxt.append(runs[-1])
                    runs = nxt
                keys, summed = runs[0]
                keep = summed >= ci
                yield keys[keep], np.minimum(summed[keep], cs).astype(np.uint32)
            b = b_hi

    def cleanup(self) -> None:
        self.drop_segments_from(0)
        for f in ("manifest.json",):
            p = os.path.join(self.dir, f)
            if os.path.exists(p):
                os.remove(p)


def count_reads_kmers_spill(
    reads_path: str,
    ref_k: int,
    spill_dir: str,
    ci: int = 2,
    cs: int = 255,
    chunk_kmers: int = 1 << 23,
    n_buckets: int = 1024,
    log=sys.stderr,
    use_device: bool = False,
    resume: bool = True,
    keep_spill: bool = False,
    produce_only: bool = False,
):
    """Bounded-memory version of counter.count_reads_kmers.

    Returns an ITERATOR of (keys_u64, counts_u32) batches (one per spill
    bucket); total counts are exact and identical to the in-RAM counter's
    (order differs — bucket-major — which no consumer observes: counter
    updates are commutative).

    ``produce_only=True`` runs the counting/spill phase, marks the
    manifest done and returns None without merging — the producer half of
    the overlapped `run` (counting runs in a helper process while the
    index phase builds; the consumer later resumes with the same
    spill_dir and skips straight to the merge).
    """
    store = SpillStore(spill_dir, n_buckets)
    manifest_path = os.path.join(spill_dir, "manifest.json")
    start_batch = 0
    total_windows = 0
    produced = False  # a completed producer (possibly another process —
    # the overlapped `run` counts while the index builds) marked done
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            man = json.load(f)
        if man.get("ref_k") == ref_k and man.get("reads_path") == reads_path:
            start_batch = int(man["batch"])
            total_windows = int(man["windows"])
            produced = bool(man.get("done"))
            store.drop_segments_from(int(man["n_seg"]))
            print(
                f"[malva-tpu/spill] "
                + ("spill complete: skipping production"
                   if produced else
                   f"resuming at batch {start_batch} "
                   f"({store.n_seg} segments committed)"),
                file=log,
            )
        else:
            print("[malva-tpu/spill] manifest mismatch, restarting", file=log)
            store.cleanup()
    else:
        store.cleanup()

    def commit_manifest(batch_i: int, done: bool = False) -> None:
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "ref_k": ref_k, "reads_path": reads_path, "batch": batch_i,
                "n_seg": store.n_seg, "windows": total_windows, "done": done,
            }, f)
        os.replace(tmp, manifest_path)

    from .counter import pack_2bit, canonical  # noqa: PLC0415

    device_steps: dict[int, object] = {}
    _SEP = np.full(1, 0xFF, dtype=np.uint8)

    def _device_step_for(m: int):
        from .device_count import make_seq_sort_count_step

        size = min(1 << max(12, (max(m, 1) - 1).bit_length()), chunk_kmers)
        if size not in device_steps:
            device_steps[size] = make_seq_sort_count_step(ref_k, size)
        return size, device_steps[size]

    pending: list = []
    pending_n = 0
    native_reads = not use_device and _native_reads_available(ref_k)

    def flush():
        nonlocal pending, pending_n, total_windows
        if not pending:
            return
        if native_reads:
            from ..utils import native

            packed = native.read_kmers(pending, ref_k)
            pending = []
            pending_n = 0
            # in-place sort: packed is disposable (the partition copies)
            out = native.sort_count_inplace(packed)
            keys, cnts = out if out is not None else _sorted_counts(packed)
            if keys.shape[0]:
                total_windows += int(cnts.sum())
                store.add_segment(keys, cnts)
            return
        block = np.concatenate(pending, axis=0)
        pending = []
        pending_n = 0
        if use_device:
            n_pos = block.shape[0] - ref_k + 1
            for start in range(0, max(n_pos, 0), chunk_kmers):
                size, step = _device_step_for(min(chunk_kmers, n_pos - start))
                for s2 in range(start, min(start + chunk_kmers, n_pos), size):
                    piece = block[s2 : s2 + size + ref_k - 1]
                    keys, cnts = device_seq_sorted_counts(step, piece, size, ref_k)
                    if keys.shape[0]:
                        total_windows += int(cnts.sum())
                        store.add_segment(keys, cnts)
            return
        packed = pack_2bit(canonical(block))
        keys, cnts = _sorted_counts(packed)
        if keys.shape[0]:
            total_windows += int(cnts.sum())
            store.add_segment(keys, cnts)

    if not produced:
        last_batch = start_batch
        for batch_i, batch in enumerate(iter_read_batches(reads_path)):
            if batch_i < start_batch:
                continue
            for seq in batch:
                if use_device:
                    a = upper(np.frombuffer(seq, dtype=np.uint8))
                    if a.shape[0] >= ref_k:
                        pending.append(a)
                        pending.append(_SEP)
                        pending_n += a.shape[0]
                elif native_reads:
                    if len(seq) >= ref_k:
                        pending.append(seq)
                        pending_n += len(seq) - ref_k + 1  # upper bound
                else:
                    w = _windows_of_read(seq, ref_k)
                    if w.shape[0]:
                        pending.append(w)
                        pending_n += w.shape[0]
                if pending_n >= chunk_kmers:
                    flush()
            # batch boundary: anything flushed so far is fully committed
            flush()
            commit_manifest(batch_i + 1)
            last_batch = batch_i + 1
        commit_manifest(last_batch, done=True)

    print(
        f"[malva-tpu/spill] {total_windows} k-mer occurrences in "
        f"{store.n_seg} segments; merging {n_buckets} buckets", file=log,
    )
    if produce_only:
        return None

    def merged():
        n_distinct = 0
        n_out = 0
        for keys, cnts in store.iter_merged(ci, cs):
            n_distinct += keys.shape[0]
            n_out += keys.shape[0]
            yield keys, cnts
        print(
            f"[malva-tpu/spill] {n_out} distinct k-mers past ci={ci}", file=log,
        )
        if not keep_spill:
            store.cleanup()

    return merged()


def _produce_main(argv: list[str]) -> int:
    """Producer child entry for the overlapped `run`:
    ``python -m malva_tpu.count.spill <reads> <ref_k> <spill_dir>``.
    Counts + spills only (no merge), never touches jax — so it never
    reserves accelerator memory the parent needs."""
    import argparse

    ap = argparse.ArgumentParser(prog="malva_tpu.count.spill")
    ap.add_argument("reads")
    ap.add_argument("ref_k", type=int)
    ap.add_argument("spill_dir")
    a = ap.parse_args(argv)

    # The host counting path never needs jax, and importing it here cost
    # ~1.8 s of child startup (it was imported only to pin the platform
    # to cpu).  Guard the invariant instead: if a future change makes the
    # producer touch jax, fail loudly rather than silently opening the
    # accelerator the parent holds.
    class _NoJaxInProducer:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith("jax."):
                raise ImportError(
                    "jax must not be imported in the spill producer child "
                    "(it would open the accelerator the parent holds); "
                    "keep the producer path numpy/native-only"
                )
            return None

    sys.meta_path.insert(0, _NoJaxInProducer())
    from ..utils.native import tune_malloc

    tune_malloc()
    count_reads_kmers_spill(a.reads, a.ref_k, a.spill_dir, produce_only=True)
    return 0


if __name__ == "__main__":
    sys.exit(_produce_main(sys.argv[1:]))
