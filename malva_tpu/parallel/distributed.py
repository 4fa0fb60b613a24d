"""Multi-host orchestration (jax.distributed).

Maps the pipeline onto a multi-process/multi-host cluster (BASELINE.json
north_star):

* every host reads its own shard of the read files (``host_shard``),
* each host counts its shard through the BOUNDED-MEMORY spill counter
  (count.spill — disk-backed, resumable, kmc -m4 parity) WITHOUT the
  ci/cs threshold (thresholding is non-linear and must happen after the
  global merge),
* distinct (key, count) runs are exchanged in lockstep rounds with
  per-HOST hash-range ownership: each batch is partitioned by owner and
  only the owner MERGES (and keeps) its slice, so per-host resident state
  is O(global_distinct / n_hosts) plus one transient exchange buffer —
  never the full distinct set (the pre-round-4 design allgathered every
  host's full store to every host),
* ci/cs apply after the merge on the owner; each host then applies its
  owned k-mers to zero-initialized counter planes, and the planes merge
  with one global sum (counter adds are commutative, mod-2^32 exact),
* rank 0 runs the genotyping pass and emits the VCF.

Exercised for real with ``process_count > 1``: tests/test_distributed.py
spawns local CPU processes with a 127.0.0.1 coordinator (Gloo
collectives) and requires the multi-process VCF byte-identical to the
single-process output.  The same entry points drive real multi-host
clusters (coordinator + process ids from the scheduler).
"""

from __future__ import annotations

import sys

import numpy as np

from ..count.counter import _merge_runs
from ..count.spill import _bucket_of
from ..utils.config import Config


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed (no-op when single-process).

    After init, every process allgathers its (num_processes, process_id)
    view and the views must agree: jax takes both as LOCAL parameters, so
    a process launched with a wrong --num-processes can otherwise join
    the cluster and silently run with a divergent world view (observed:
    a 2-vs-3 mismatch completed "successfully" with wrong ownership).
    Inconsistency raises; if the divergent views deadlock the check
    collective instead, the caller's watchdog converts the hang into a
    one-line error (Gloo collectives hang on mismatch/peer loss)."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    from jax.experimental import multihost_utils

    topo = np.asarray(multihost_utils.process_allgather(
        np.array([num_processes, process_id], dtype=np.int32)
    )).reshape(-1, 2)
    ids = topo[:, 1].tolist()
    if (topo.shape[0] != num_processes
            or not (topo[:, 0] == num_processes).all()
            or sorted(ids) != list(range(num_processes))):
        raise RuntimeError(
            f"inconsistent process topology: (num_processes, process_id) "
            f"views = {topo.tolist()}"
        )


def host_shard(paths: list[str]) -> list[str]:
    """The read files this host is responsible for (round-robin)."""
    import jax

    pid = jax.process_index()
    n = jax.process_count()
    return [p for i, p in enumerate(paths) if i % n == pid]


class _Collectives:
    """Cached global mesh + jitted exchange steps for host-side data.

    The process-level collectives ride a 1-device-per-process global mesh
    (axis "p"): host arrays go global via host_local_array_to_global_array,
    one jitted shard_map collective runs (all_to_all for the ranged
    exchange, psum for the counter-plane merge), and results come back
    host-local.  Jits are cached per padded shape (pow2-bucketed rows, so
    compile count is O(log batch))."""

    def __init__(self):
        self._mesh = None
        self._checked = False
        self._a2a = {}
        self._psum = {}

    def mesh_or_none(self):
        """The process mesh, or None when the topology doesn't give one
        device per process (then callers use the allgather fallback)."""
        if self._checked:
            return self._mesh
        self._checked = True
        import jax

        devs = np.array(jax.devices())
        if devs.size == jax.process_count():
            from jax.sharding import Mesh

            self._mesh = Mesh(devs, ("p",))
        return self._mesh

    def all_to_all(self, send: np.ndarray) -> np.ndarray | None:
        """(H, m, R)->(H, m, R): block [dst] of each src lands at dst's
        [src].  Returns None when no process mesh is available."""
        mesh = self.mesh_or_none()
        if mesh is None:
            return None
        import jax
        from jax.experimental import multihost_utils
        from jax.sharding import PartitionSpec as P

        shape = send.shape
        if shape not in self._a2a:
            self._a2a[shape] = jax.jit(jax.shard_map(
                lambda x: jax.lax.all_to_all(
                    x, "p", split_axis=0, concat_axis=0, tiled=True
                ),
                mesh=mesh, in_specs=P("p"), out_specs=P("p"),
            ))
        glob = multihost_utils.host_local_array_to_global_array(
            send, mesh, P("p")
        )
        out = self._a2a[shape](glob)
        return np.asarray(multihost_utils.global_array_to_host_local_array(
            out, mesh, P("p")
        ))

    def psum_u32(self, plane: np.ndarray) -> np.ndarray | None:
        """Element-wise mod-2^32 sum of one uint32 plane across processes
        (counter adds commute; uint32 wraparound is order-independent).
        O(plane) transient memory per host — never the O(H x plane) an
        allgather+sum holds.  None when no process mesh is available."""
        if plane.shape[0] == 0:
            return np.asarray(plane, dtype=np.uint32)
        mesh = self.mesh_or_none()
        if mesh is None:
            return None
        import jax
        from jax.experimental import multihost_utils
        from jax.sharding import PartitionSpec as P

        n = plane.shape[0]
        if n not in self._psum:
            self._psum[n] = jax.jit(jax.shard_map(
                lambda x: jax.lax.psum(x, "p"),
                mesh=mesh, in_specs=P("p"), out_specs=P(None),
            ))
        gp = multihost_utils.host_local_array_to_global_array(
            np.ascontiguousarray(plane, dtype=np.uint32)[None], mesh, P("p")
        )
        out = self._psum[n](gp)
        return np.asarray(multihost_utils.global_array_to_host_local_array(
            out, mesh, P(None)
        ))[0]


def _exchange_rows(coll: _Collectives, keys: np.ndarray, cnts: np.ndarray,
                   owner: np.ndarray, w: int, stats: dict | None = None):
    """One-round ranged exchange: every process sends each row to its
    owner and receives the rows it owns — per-destination blocks, ONE
    all_to_all, O(data) total traffic (each host receives only what it
    keeps, plus per-(src,dst) padding to the global max block).  Replaces
    the per-owner allgather loop (2H collectives/batch, every host
    receiving H x what it kept).  Falls back to that loop when no
    process mesh exists.  Returns [(keys, cnts)] received by this
    process, per source, sorted-run order preserved."""
    import jax
    from jax.experimental import multihost_utils

    H = jax.process_count()
    pid = jax.process_index()
    my_counts = np.bincount(owner, minlength=H).astype(np.int32)
    all_counts = np.asarray(
        multihost_utils.process_allgather(my_counts)
    ).reshape(H, H)  # [src, dst]
    m = int(all_counts.max())
    if m == 0:
        return []
    # pow2 row padding bounds jit compiles at O(log batch) distinct shapes
    m_pad = 1 << max(0, (m - 1).bit_length())
    R = 2 * w + 2  # key uint32 lanes + count int64 as 2 lanes
    order = np.argsort(owner, kind="stable")
    row32 = np.concatenate([
        np.ascontiguousarray(keys[order]).view(np.uint32).reshape(-1, 2 * w),
        cnts[order].astype(np.int64).view(np.uint32).reshape(-1, 2),
    ], axis=1)
    starts = np.zeros(H + 1, dtype=np.int64)
    np.cumsum(my_counts, out=starts[1:])
    send = np.zeros((H, m_pad, R), dtype=np.uint32)
    for dst in range(H):
        lo, hi = int(starts[dst]), int(starts[dst + 1])
        send[dst, : hi - lo] = row32[lo:hi]

    recv = coll.all_to_all(send)
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + 1
        stats["rows_sent"] = stats.get("rows_sent", 0) + int(keys.shape[0])
        stats["rows_padded"] = stats.get("rows_padded", 0) + H * m_pad
    if recv is None:
        # no 1-device-per-process mesh: lockstep per-owner allgather
        out = []
        for h in range(H):
            sel = owner == h
            per_proc = _allgather_runs(keys[sel], cnts[sel], w)
            if pid == h:
                out.extend(per_proc)
        if stats is not None:
            stats["fallback"] = True
        return out

    out = []
    for src in range(H):
        n = int(all_counts[src, pid])
        if n == 0:
            continue
        rows = np.ascontiguousarray(recv[src, :n])
        kk = np.ascontiguousarray(rows[:, : 2 * w]).view(np.uint64)
        cc = np.ascontiguousarray(rows[:, 2 * w :]).view(np.int64).reshape(-1)
        out.append((kk, cc))
        if stats is not None:
            stats["rows_kept"] = stats.get("rows_kept", 0) + n
    return out


def _allgather_runs(keys: np.ndarray, cnts: np.ndarray, w: int):
    """Exchange one (possibly empty) sorted run with every process.
    Returns per-process (keys, cnts) lists.  Rows pad to the max length
    across processes (allgather needs one static shape), and 64-bit
    payloads travel as uint32 lanes — under JAX's default 32-bit mode
    process_allgather silently DOWNCASTS uint64/int64 arrays, truncating
    packed k-mer words (measured, not hypothetical)."""
    import jax
    from jax.experimental import multihost_utils

    H = jax.process_count()
    n_local = np.array([keys.shape[0]], dtype=np.int32)
    all_n = np.asarray(multihost_utils.process_allgather(n_local)).reshape(-1)
    m = int(all_n.max())
    if m == 0:
        empty = np.zeros((0, w), np.uint64), np.zeros(0, np.int64)
        return [empty] * H
    kp = np.zeros((m, w), dtype=np.uint64)
    cp = np.zeros(m, dtype=np.int64)
    kp[: keys.shape[0]] = keys
    cp[: cnts.shape[0]] = cnts
    all_k32 = np.asarray(
        multihost_utils.process_allgather(kp.view(np.uint32))
    )  # (H, m, 2w)
    all_c32 = np.asarray(
        multihost_utils.process_allgather(cp.view(np.uint32).reshape(m, 2))
    )
    out = []
    for h in range(H):
        nh = int(all_n[h])
        kk = np.ascontiguousarray(all_k32[h, :nh]).view(np.uint64)
        cc = np.ascontiguousarray(all_c32[h, :nh]).view(np.int64).reshape(-1)
        out.append((kk, cc))
    return out


def _tree_merge(runs: list) -> tuple[np.ndarray, np.ndarray]:
    """Pairwise tree merge of sorted distinct (keys, counts) runs."""
    if not runs:
        raise ValueError("no runs")
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            ka, ca = runs[i]
            kb, cb = runs[i + 1]
            nxt.append(_merge_runs(ka, ca, kb, cb))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


# Ownership hash width: ranges are assigned from the spill bucket hash so
# keys within one range share no lexicographic structure (canonical
# k-mers are non-uniform in their prefix — see count.spill._bucket_of).
_OWNER_RANGES = 1024


def _allgather_padded(arr: np.ndarray):
    """process_allgather of one variable-length local array: returns
    (list of per-process arrays).  Rows pad to the global max; dtypes
    must be 32-bit (process_allgather silently downcasts 64-bit under
    JAX's default 32-bit mode — transport 64-bit payloads as lanes)."""
    from jax.experimental import multihost_utils

    assert arr.dtype.itemsize <= 4, arr.dtype
    n = np.array([arr.shape[0]], dtype=np.int32)
    all_n = np.asarray(multihost_utils.process_allgather(n)).reshape(-1)
    m = int(all_n.max())
    if m == 0:
        return [arr[:0] for _ in all_n]
    pad_shape = (m,) + arr.shape[1:]
    buf = np.zeros(pad_shape, dtype=arr.dtype)
    buf[: arr.shape[0]] = arr
    allg = np.asarray(multihost_utils.process_allgather(buf))
    return [allg[h, : int(all_n[h])] for h in range(all_n.shape[0])]


def _or_merge_words(words: np.ndarray) -> None:
    """In-place bitwise-OR of one Bloom word plane across processes:
    sparse (nonzero index, value) pairs allgather (bit adds are
    idempotent, so OR of the per-process planes equals the sequential
    single-process adds)."""
    import jax

    if jax.process_count() <= 1:
        return
    pid = jax.process_index()
    nz = np.flatnonzero(words)
    pairs = np.empty((nz.shape[0], 2), dtype=np.uint32)
    pairs[:, 0] = nz  # word index < 2^32 for any -b the CLI admits
    pairs[:, 1] = words[nz]
    for h, p in enumerate(_allgather_padded(pairs)):
        if h == pid or p.shape[0] == 0:
            continue
        words[p[:, 0].astype(np.int64)] |= p[:, 1]


def _batch_ref_keys(flat) -> tuple[np.ndarray, bytes]:
    """One batch's reference-allele KMAP keys, first-occurrence-deduped in
    the exact single-process insertion order (length_groups order: length
    ascending, row order within).  Returns (lengths int32, concat bytes)."""
    from ..ops.seq import canonical, truncate_at_nul

    groups = []
    any_nul = False
    for is_ref, _L, _idxs, mat in flat.length_groups():
        if not is_ref:
            continue
        ck = truncate_at_nul(canonical(mat))
        groups.append(ck)
        if ck.size and ck.min() == 0:
            any_nul = True
    if not groups:
        return np.zeros(0, np.int32), b""
    if len(groups) == 1 and not any_nul:
        g = np.ascontiguousarray(groups[0])
        v = g.view(f"V{g.shape[1]}").ravel()
        _, first = np.unique(v, return_index=True)
        data = g[np.sort(first)]
        return (np.full(data.shape[0], g.shape[1], np.int32),
                data.tobytes())
    # general path (NUL-truncated or multiple length classes): ordered set
    seen = set()
    keys = []
    for ck in groups:
        for row in ck:
            kb = row.tobytes().rstrip(b"\x00")
            if kb not in seen:
                seen.add(kb)
                keys.append(kb)
    return (np.asarray([len(k) for k in keys], np.int32), b"".join(keys))


def build_index_distributed(cfg: Config, timer=None):
    """Index phase sharded across processes (reference main.cpp:251-419
    done ONCE cluster-wide, not once per host): every process runs the
    cheap record scan (block/batch boundaries need only positions, sizes
    and INFO frequencies), but the expensive GT parse + signature
    extraction run only for its round-robin-owned batches.  Merges:
    Bloom bit planes OR (idempotent adds), KMAP keys unioned in the
    deterministic single-process insertion order (batch asc, in-batch
    order) — identical key ORDER everywhere is load-bearing: the counter
    merge and the pass-2 plane reads index by key position.  The
    reference context scan shards by 1M-base chunk, context bits OR."""
    import jax

    from ..index.bloom_filter import BF
    from ..index.kmap import KMAP
    from ..io.fasta import load_reference
    from ..pipeline import Index, _iter_extract_batches
    from ..utils.timing import PhaseTimer

    H = jax.process_count()
    pid = jax.process_index()
    timer = timer or PhaseTimer()
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)

    bf = BF(cfg.bf_size)
    context_bf = BF(cfg.bf_size)
    used_names: list[str] = []
    n_vars = 0
    my_keys: list[tuple[int, np.ndarray, bytes]] = []
    for bi, flat in _iter_extract_batches(
        cfg, refs, keep_absent=False, used_out=used_names,
        owned=lambda b: b % H == pid,
    ):
        n_vars += len(flat.all_vars)
        lens, data = _batch_ref_keys(flat)
        if lens.shape[0]:
            my_keys.append((bi, lens, data))
        for is_ref, _L, _idxs, mat in flat.length_groups():
            if not is_ref:
                bf.add_keys(mat)
    timer.pelapsed(f"Processed variants (host {pid}: {n_vars} in owned batches)")

    _or_merge_words(bf.words)
    ref_bf = _merged_kmap(my_keys)
    bf.switch_mode()
    if pid == 0:
        fill = len(bf.counts) / max(bf.size, 1)
        print(
            f"[malva-tpu/metrics] alt-BF set bits {len(bf.counts)} "
            f"(fill {fill:.2e}); exact map keys {len(ref_bf)}",
            file=sys.stderr,
        )
    timer.pelapsed("BF creation complete (merged)")

    # reference context scan, sharded by chunk (semantics: pipeline
    # build_index host path, main.cpp:382-401; adds are idempotent)
    off = cfg.center_off
    chunk = 1 << 20
    ci = 0
    for seq_name in used_names:
        ref = refs.get(seq_name)
        if ref is None or len(ref) == 0:
            continue
        L = len(ref)
        if L < cfg.ref_k:
            if ci % H == pid and L > off:
                sub = ref[off : off + cfg.k][None, :]
                if bf.test_keys(sub)[0]:
                    context_bf.add_keys(ref[: cfg.ref_k][None, :])
            ci += 1
            continue
        n_pos = L - cfg.ref_k + 1
        for start in range(0, n_pos, chunk):
            if ci % H == pid:
                stop = min(start + chunk, n_pos)
                windows = np.lib.stride_tricks.sliding_window_view(
                    ref[start : stop + cfg.ref_k - 1], cfg.ref_k
                )
                centers = windows[:, off : off + cfg.k]
                hits = bf.test_keys(centers)
                if hits.any():
                    context_bf.add_keys(np.ascontiguousarray(windows[hits]))
            ci += 1
    _or_merge_words(context_bf.words)
    context_bf.switch_mode()
    timer.pelapsed("Reference BF creation complete (sharded scan, merged)")
    return Index(bf=bf, ref_bf=ref_bf, context_bf=context_bf)


def _merged_kmap(my_keys: list):
    """Union the per-process per-batch key streams into one KMAP with the
    exact insertion order a single process would produce: batches
    ascending, first occurrence wins (dict insertion keeps the first
    position, like upstream kmap.hpp:108)."""
    from ..index.kmap import KMAP

    flat_meta = []  # (batch_id, key_len) rows, int32
    flat_data = []
    for bi, lens, data in my_keys:
        meta = np.empty((lens.shape[0], 2), np.int32)
        meta[:, 0] = bi
        meta[:, 1] = lens
        flat_meta.append(meta)
        flat_data.append(np.frombuffer(data, dtype=np.uint8))
    meta = (np.concatenate(flat_meta) if flat_meta
            else np.zeros((0, 2), np.int32))
    data = (np.concatenate(flat_data) if flat_data
            else np.zeros(0, np.uint8))

    metas = _allgather_padded(meta)
    datas = _allgather_padded(data)

    # global order: each batch is wholly owned by one process and every
    # stream is batch-ascending, so concatenating per-BATCH slices in
    # batch-id order reproduces the sequential single-process stream
    slices = []  # (batch_id, stream_idx, row_lo, row_hi)
    streams = []
    for m2, d in zip(metas, datas):
        if m2.shape[0] == 0:
            continue
        offs = np.zeros(m2.shape[0] + 1, np.int64)
        np.cumsum(m2[:, 1], out=offs[1:])
        si = len(streams)
        streams.append((m2, offs, d.tobytes()))
        bids = m2[:, 0]
        starts = np.flatnonzero(np.diff(bids, prepend=bids[0] - 1))
        ends = np.append(starts[1:], bids.shape[0])
        for lo, hi in zip(starts.tolist(), ends.tolist()):
            slices.append((int(bids[lo]), si, lo, hi))
    slices.sort()
    km = KMAP()
    d = km.kmers
    for _b, si, lo, hi in slices:
        m2, offs, blob = streams[si]
        lens = m2[lo:hi, 1].tolist()
        at = int(offs[lo])
        for ln in lens:
            key = blob[at : at + ln]
            at += ln
            if key not in d:
                d[key] = 0
    return km


def count_distributed(
    reads_paths: list[str], cfg: Config, ci: int = 2, cs: int = 255,
    spill_dir: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Count k-mers across processes with hash-range ownership.

    Returns THIS process's owned slice of the global distinct set as
    (keys_packed_u64, counts_u32) with ci/cs applied — the union over
    processes is exactly the single-process counter's output.  Per-host
    resident memory is O(distinct / n_hosts) + one exchange buffer;
    counting itself is disk-spilled when ``spill_dir`` is given."""
    import jax

    H = jax.process_count()
    pid = jax.process_index()

    def local_batches():
        # local raw counts: ci=1, no cap — thresholds are global
        if spill_dir is not None:
            from ..count.spill import count_reads_kmers_spill

            for path_i, path in enumerate(host_shard(reads_paths)):
                yield from count_reads_kmers_spill(
                    path, cfg.ref_k, f"{spill_dir}/h{pid}_{path_i}",
                    ci=1, cs=1 << 62,
                )
        else:
            from ..count.counter import count_reads_kmers

            for path in host_shard(reads_paths):
                k_arr, c_arr = count_reads_kmers(
                    path, cfg.ref_k, ci=1, cs=1 << 62, return_packed=True
                )
                yield k_arr, c_arr

    w = (cfg.ref_k + 31) // 32
    my_runs: list = []
    it = iter(local_batches())
    from jax.experimental import multihost_utils

    coll = _Collectives()
    stats: dict = {}
    while True:
        batch = next(it, None)
        have = np.array([0 if batch is None else 1], dtype=np.int64)
        any_have = int(
            np.asarray(multihost_utils.process_allgather(have)).sum()
        )
        if any_have == 0:
            break
        if batch is None:
            keys = np.zeros((0, w), np.uint64)
            cnts = np.zeros(0, np.int64)
        else:
            keys = np.ascontiguousarray(batch[0], dtype=np.uint64)
            cnts = np.asarray(batch[1], dtype=np.int64)
        owner = _bucket_of(keys, _OWNER_RANGES) % H if keys.shape[0] else \
            np.zeros(0, np.int64)
        # one-round exchange: per-destination blocks, one all_to_all
        for kk, cc in _exchange_rows(coll, keys, cnts, owner, w, stats):
            if kk.shape[0]:
                my_runs.append((kk, cc))
    if stats:
        print(
            f"[malva-tpu/dist] host {pid}/{H}: exchange "
            f"{stats.get('rounds', 0)} rounds x 1 all_to_all"
            f"{' (allgather fallback)' if stats.get('fallback') else ''}, "
            f"{stats.get('rows_sent', 0)} rows sent, "
            f"{stats.get('rows_kept', 0)} kept, "
            f"{stats.get('rows_padded', 0)} padded slots",
            file=sys.stderr,
        )

    if not my_runs:
        keys = np.zeros((0, w), np.uint64)
        counts = np.zeros(0, np.int64)
    else:
        keys, counts = _tree_merge(my_runs)
    keep = counts >= ci
    keys = keys[keep]
    counts = np.minimum(counts[keep], cs).astype(np.uint32)
    print(
        f"[malva-tpu/dist] host {pid}/{H}: owns {keys.shape[0]} distinct "
        f"k-mers past ci={ci}",
        file=sys.stderr,
    )
    return keys, counts


def call_distributed(cfg: Config, index, reads_paths: list[str], out,
                     spill_dir: str | None = None) -> None:
    """Full multi-process call phase (reference main.cpp:421-594 over a
    process cluster): shard-count + ranged exchange, per-host counter
    application on its owned k-mers, one global counter merge, VCF
    emission on rank 0 (``out`` is only written there)."""
    import jax
    from jax.experimental import multihost_utils

    from ..io.fasta import load_reference
    from ..pipeline import apply_sample_counts
    from ..utils.timing import PhaseTimer

    keys, counts = count_distributed(
        reads_paths, cfg, spill_dir=spill_dir
    )
    # zero-initialized planes: each host adds only its owned k-mers
    index.bf.counts[:] = 0
    for k in index.ref_bf.kmers:
        index.ref_bf.kmers[k] = 0
    if keys.shape[0]:
        apply_sample_counts(index, keys, counts, cfg)

    # global merge: counter adds commute, so summing the per-host planes
    # equals the sequential single-process application (mod-2^32 exact;
    # the 16-bit BF wrap applies at read time, after the sum — same as
    # sequential adds into one uint32 plane).  psum keeps transient
    # memory O(plane); the allgather fallback holds O(H x plane).
    coll = _Collectives()

    def merge_plane(plane: np.ndarray) -> np.ndarray:
        out = coll.psum_u32(plane)
        if out is not None:
            return out
        return np.asarray(
            multihost_utils.process_allgather(plane)
        ).astype(np.uint64).sum(axis=0).astype(np.uint32)

    index.bf.counts = merge_plane(index.bf.counts)
    vals_sum = merge_plane(index.ref_bf.snapshot_values())
    for k, v in zip(list(index.ref_bf.kmers.keys()), vals_sum.tolist()):
        index.ref_bf.kmers[k] = v

    # pass 2 sharded by extraction batch: every host has the full merged
    # counter planes, genotypes its owned batches, and rank 0 stitches
    # the per-batch VCF text in batch order (byte-identical stream)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    _genotype_and_emit_distributed(cfg, index, refs, out, PhaseTimer())


def _gather_blobs(blobs: list) -> list | None:
    """Gather per-batch (batch_id, bytes) pairs to rank 0, returned in
    batch-id order (None on other ranks).  Transport: one padded uint8
    allgather for the concatenated text + one int32 (id, len) table."""
    import jax

    data = np.frombuffer(b"".join(b for _, b in blobs), dtype=np.uint8)
    meta = np.asarray([[bi, len(b)] for bi, b in blobs],
                      dtype=np.int32).reshape(-1, 2)
    metas = _allgather_padded(meta)
    datas = _allgather_padded(data)
    if jax.process_index() != 0:
        return None
    out = []
    for m2, d in zip(metas, datas):
        blob = d.tobytes()
        at = 0
        for bi, ln in m2.tolist():
            out.append((bi, blob[at : at + ln]))
            at += ln
    out.sort(key=lambda t: t[0])
    return out


def _genotype_and_emit_distributed(cfg: Config, index, refs, out,
                                   timer) -> None:
    """Pass 2 (reference main.cpp:517-594) sharded across processes by
    extraction batch: coverage assignment, genotyping and line formatting
    run on the batch owner; rank 0 writes header + batches in order."""
    import jax

    from ..io.vcf import cleaned_header, open_variant_reader
    from ..models.genotype import format_variants, genotype_block
    from ..pipeline import (_EMPTY_BOOL, _EMPTY_I32, _iter_extract_batches,
                            _set_coverages_flat)

    H = jax.process_count()
    pid = jax.process_index()
    blobs: list[tuple[int, bytes]] = []
    n = 0
    for bi, flat in _iter_extract_batches(
        cfg, refs, keep_absent=True, owned=lambda b: b % H == pid,
    ):
        for v in flat.all_vars:  # GT arrays consumed by extraction; drop
            v.gt_a1 = v.gt_a2 = _EMPTY_I32
            v.phase = _EMPTY_BOOL
        _set_coverages_flat(index, flat)
        genotype_block(flat.all_vars, cfg.max_coverage, cfg.haploid,
                       cfg.error_rate)
        text = "".join(
            line + "\n"
            for line in format_variants(flat.all_vars, cfg.haploid, cfg.verbose)
        )
        blobs.append((bi, text.encode()))
        n += len(flat.all_vars)
    gathered = _gather_blobs(blobs)
    if pid == 0:
        reader = open_variant_reader(cfg.vcf_path, cfg.samples)
        out.write(cleaned_header(reader.meta_lines, cfg.verbose))
        for _bi, b in gathered:
            out.write(b.decode())
    timer.pelapsed(f"VCF parsing and genotyping ({n} variants on host {pid})")
