"""Streaming sample k-mer counting — the KMC replacement.

Reproduces the *effective* contract the reference consumes from a
default-flags KMC run (reference: MALVA:107 `kmc -m4 -k<refk> -t1 -fm`,
consumed at main.cpp:488-500): the distinct **canonical** ref_k-mers of
the read set, restricted to windows of pure A/C/G/T (KMC skips k-mers
containing any other symbol), with

* k-mers occurring fewer than ``ci`` times excluded (KMC default ci=2),
* counters saturated at ``cs`` (KMC default cs=255).

Counting is exact two-stage (count -> threshold/cap), not direct
accumulation, because the ci/cs effects are not linear.

The host path packs canonical k-mers 2 bits/base and counts by
sort + run-length over uint64 word columns; chunks are merged so memory
stays bounded for arbitrarily large read sets.
"""

from __future__ import annotations

import os
import sys
import numpy as np

from ..utils.errors import InputError

from ..io.fasta import iter_read_batches
from ..ops.seq import CODE_TABLE, canonical, pack_2bit, unpack_2bit, upper


def _windows_of_read(seq: bytes, k: int) -> np.ndarray:
    """All pure-ACGT k-windows of one read as (n, k) uint8 (uppercased)."""
    a = upper(np.frombuffer(seq, dtype=np.uint8))
    if len(a) < k:
        return np.zeros((0, k), dtype=np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(a, k)
    valid_base = CODE_TABLE[a] != 255
    # window valid iff all k bases valid: prefix-sum trick
    cs = np.concatenate([[0], np.cumsum(valid_base)])
    ok = (cs[k:] - cs[:-k]) == k
    return win[ok]


def _sorted_counts(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sort (N, W) uint64 rows lexicographically and run-length count."""
    if packed.shape[0] == 0:
        return packed, np.zeros(0, dtype=np.int64)
    if packed.shape[1] <= 2:
        from ..utils import native

        out = native.sort_count(packed)
        if out is not None:
            return out
    order = np.lexsort(tuple(packed[:, w] for w in range(packed.shape[1] - 1, -1, -1)))
    s = packed[order]
    diff = np.any(s[1:] != s[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(diff)[0] + 1])
    ends = np.concatenate([starts[1:], [s.shape[0]]])
    return s[starts], (ends - starts).astype(np.int64)


def _merge_runs(
    keys_a: np.ndarray, cnt_a: np.ndarray, keys_b: np.ndarray, cnt_b: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Merge two sorted distinct-key runs, summing counts."""
    if keys_a.shape[0] == 0:
        return keys_b, cnt_b
    if keys_b.shape[0] == 0:
        return keys_a, cnt_a
    if keys_a.shape[1] <= 2:
        from ..utils import native

        out = native.merge_runs(keys_a, cnt_a, keys_b, cnt_b)
        if out is not None:
            return out
    keys = np.concatenate([keys_a, keys_b])
    cnts = np.concatenate([cnt_a, cnt_b])
    order = np.lexsort(tuple(keys[:, w] for w in range(keys.shape[1] - 1, -1, -1)))
    keys = keys[order]
    cnts = cnts[order]
    diff = np.any(keys[1:] != keys[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(diff)[0] + 1])
    seg = np.concatenate([starts[1:], [keys.shape[0]]])
    summed = np.add.reduceat(cnts, starts)
    return keys[starts], summed


def _parse_dump_block(block: bytes, ref_k: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized parse of whole lines of ``KMER<ws>COUNT``.  The k-mer
    column is fixed-width (ref_k), so lines are validated by checking the
    byte at offset ref_k is whitespace; counts are parsed positionally
    (digit-by-digit over the block, <= 10 iterations)."""
    a = np.frombuffer(block, dtype=np.uint8)
    nl = np.nonzero(a == 0x0A)[0]
    starts = np.concatenate([[0], nl[:-1] + 1]) if nl.size else np.zeros(0, np.int64)
    ends = nl  # exclusive of the newline
    lens = ends - starts
    nonempty = lens > 0
    starts, ends, lens = starts[nonempty], ends[nonempty], lens[nonempty]
    if starts.size == 0:
        return np.zeros((0, ref_k), np.uint8), np.zeros(0, np.uint32)
    sep = a[np.minimum(starts + ref_k, a.shape[0] - 1)]
    bad = (lens <= ref_k) | ((sep != 0x09) & (sep != 0x20))
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        line = block[starts[i] : ends[i]]
        tok = line.split()[0] if line.split() else b""
        raise InputError(f"kmc dump k-mer length {len(tok)} != ref_k {ref_k}")
    kmers = upper(a[starts[:, None] + np.arange(ref_k)])
    # positional integer parse of the count field (stops at any non-digit,
    # so trailing \r is harmless)
    cstart = starts + ref_k + 1
    counts = np.zeros(starts.shape[0], dtype=np.uint64)
    alive = np.ones(starts.shape[0], dtype=bool)
    for j in range(20):
        p = cstart + j
        inb = p < ends
        d = np.where(inb, a[np.minimum(p, a.shape[0] - 1)], np.uint8(0))
        is_digit = (d >= 0x30) & (d <= 0x39)
        alive = alive & inb & is_digit
        if not alive.any():
            break
        counts = np.where(alive, counts * 10 + (d - 0x30), counts)
    return kmers, counts.astype(np.uint32)


def iter_kmc_dump(path: str, ref_k: int, chunk_bytes: int = 1 << 26):
    """Stream a `kmc_dump` text file (``KMER<TAB>COUNT`` per line) as
    ((M, ref_k) uint8, (M,) uint32) batches of ~chunk_bytes each — a WGS
    dump is tens of GB and must never materialize whole (the reference
    consumes the same data incrementally through the KMC API,
    main.cpp:488)."""
    import gzip

    op = gzip.open if path.endswith(".gz") else open
    carry = b""
    with op(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            block = carry + block
            cut = block.rfind(b"\n") + 1
            carry = block[cut:]
            if cut:
                yield _parse_dump_block(block[:cut], ref_k)
    if carry:
        yield _parse_dump_block(carry + b"\n", ref_k)


def load_kmc_dump(path: str, ref_k: int) -> tuple[np.ndarray, np.ndarray]:
    """Whole-file convenience wrapper over :func:`iter_kmc_dump`."""
    ks, cs = [], []
    for k_arr, c_arr in iter_kmc_dump(path, ref_k):
        ks.append(k_arr)
        cs.append(c_arr)
    if not ks:
        return np.zeros((0, ref_k), np.uint8), np.zeros(0, np.uint32)
    return np.concatenate(ks), np.concatenate(cs)


def _native_reads_available(ref_k: int) -> bool:
    """The fused native window->packed-canonical kernel covers ref_k<=64
    (keys of at most two u64 words)."""
    from ..utils import native

    return ref_k <= 64 and native.load() is not None


def count_reads_kmers(
    reads_path: str,
    ref_k: int,
    ci: int = 2,
    cs: int = 255,
    chunk_kmers: int = 1 << 25,
    log=sys.stderr,
    checkpoint: str | None = None,
    checkpoint_every_batches: int = 8,
    use_device: bool = False,
    return_packed: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Count canonical ref_k-mers of a FASTA/FASTQ file.

    Returns (contexts, counts): contexts is (M, ref_k) uint8 ASCII of the
    distinct canonical k-mers with ci <= count, counts is (M,) uint32
    saturated at cs.  With ``return_packed`` the contexts stay in the
    internal 2-bit packed form ((M, ceil(ref_k/32)) uint64) — the device
    call step consumes that directly (index.device.packed64_to_u32).

    With ``checkpoint`` set, the distinct-count store plus the read-batch
    cursor are persisted every ``checkpoint_every_batches`` read batches,
    and an interrupted run resumes from the last checkpoint (elastic
    recovery for long read streams; the batch segmentation is
    deterministic, so resumed counts equal a clean run's).
    """
    acc_keys = np.zeros((0, (ref_k + 31) // 32), dtype=np.uint64)
    acc_cnts = np.zeros(0, dtype=np.int64)
    pending: list = []
    pending_n = 0
    total_windows = 0
    start_batch = 0
    native_reads = not use_device and _native_reads_available(ref_k)

    device_steps: dict[int, object] = {}
    _SEP = np.full(1, 0xFF, dtype=np.uint8)  # read separator: invalidates
    # any window crossing a read boundary (non-ACGT, like KMC's skip rule)

    def _device_step_for(m: int):
        """Step sized to the workload (pow2-bucketed to bound recompiles) —
        a fixed-size step would pad tiny flushes to chunk_kmers lanes."""
        from .device_count import make_seq_sort_count_step

        size = min(1 << max(12, (max(m, 1) - 1).bit_length()), chunk_kmers)
        if size not in device_steps:
            device_steps[size] = make_seq_sort_count_step(ref_k, size)
        return size, device_steps[size]

    if checkpoint is not None and os.path.exists(checkpoint):
        st = np.load(checkpoint)
        if int(st["ref_k"]) == ref_k and str(st["reads_path"]) == reads_path:
            acc_keys = st["keys"]
            acc_cnts = st["cnts"]
            start_batch = int(st["batch"])
            total_windows = int(st["windows"])
            print(
                f"[malva-tpu/count] resuming from checkpoint at batch {start_batch}",
                file=log,
            )
        else:
            print("[malva-tpu/count] checkpoint mismatch, ignoring", file=log)

    def flush():
        nonlocal acc_keys, acc_cnts, pending, pending_n, total_windows
        if not pending:
            return
        if native_reads:
            from ..utils import native

            # fused native path: raw read bytes -> packed canonical keys
            # (no (windows, k) byte matrix ever materializes); the packed
            # buffer is disposable, so the sort consumes it in place and
            # the run views die at the merge — no working/output copies
            packed = native.read_kmers(pending, ref_k)
            pending = []
            pending_n = 0
            total_windows += packed.shape[0]
            out = native.sort_count_inplace(packed)
            keys, cnts = out if out is not None else _sorted_counts(packed)
            acc_keys, acc_cnts = _merge_runs(acc_keys, acc_cnts, keys, cnts)
            return
        block = np.concatenate(pending, axis=0)
        pending = []
        pending_n = 0
        if use_device:
            # block = joined raw read bytes (1 B/base to the device);
            # windows are built on-device (device_count module doc)
            from .device_count import device_seq_sorted_counts

            n_pos = block.shape[0] - ref_k + 1
            for start in range(0, max(n_pos, 0), chunk_kmers):
                size, step = _device_step_for(min(chunk_kmers, n_pos - start))
                for s2 in range(start, min(start + chunk_kmers, n_pos), size):
                    piece = block[s2 : s2 + size + ref_k - 1]
                    keys, cnts = device_seq_sorted_counts(step, piece, size, ref_k)
                    acc_keys, acc_cnts = _merge_runs(acc_keys, acc_cnts, keys, cnts)
            return
        packed = pack_2bit(canonical(block))
        keys, cnts = _sorted_counts(packed)
        acc_keys, acc_cnts = _merge_runs(acc_keys, acc_cnts, keys, cnts)

    def save_checkpoint(batch_i: int) -> None:
        if checkpoint is None:
            return
        flush()
        tmp = checkpoint + ".tmp"
        np.savez(
            tmp if tmp.endswith(".npz") else tmp,
            keys=acc_keys, cnts=acc_cnts, batch=batch_i, windows=total_windows,
            ref_k=ref_k, reads_path=reads_path,
        )
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", checkpoint)

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
                    total_windows += w.shape[0]
            if pending_n >= chunk_kmers:
                flush()
        if checkpoint is not None and (batch_i + 1) % checkpoint_every_batches == 0:
            save_checkpoint(batch_i + 1)
    flush()
    if use_device:
        total_windows = int(acc_cnts.sum())
    if checkpoint is not None and os.path.exists(checkpoint):
        os.remove(checkpoint)

    keep = acc_cnts >= ci
    keys = acc_keys[keep]
    counts = np.minimum(acc_cnts[keep], cs).astype(np.uint32)
    print(
        f"[malva-tpu/count] {total_windows} k-mer occurrences, "
        f"{acc_cnts.shape[0]} distinct, {keys.shape[0]} past ci={ci}"
        + (" (device sort-count)" if use_device else ""),
        file=log,
    )
    return (keys if return_packed else unpack_2bit(keys, ref_k)), counts
