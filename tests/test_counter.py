"""KMC-equivalent counter vs a brute-force dict oracle."""

import gzip
import os

import numpy as np
import pytest

from malva_tpu.count.counter import count_reads_kmers
from malva_tpu.ops.seq import RCN_TABLE


def _rc(s: bytes) -> bytes:
    return bytes(RCN_TABLE[b] for b in s)[::-1]


def _canon(s: bytes) -> bytes:
    r = _rc(s)
    return s if s < r else r


def _oracle(reads, k, ci=2, cs=255):
    counts = {}
    for r in reads:
        r = r.upper()
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            if any(c not in b"ACGT" for c in w):
                continue
            c = _canon(w)
            counts[c] = counts.get(c, 0) + 1
    return {k_: min(v, cs) for k_, v in counts.items() if v >= ci}


def test_counter_matches_oracle(tmp_path):
    rng = np.random.default_rng(7)
    reads = []
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200).tobytes()
    for i in range(50):
        start = rng.integers(0, 150)
        read = bytearray(base[start : start + 60])
        if rng.random() < 0.3:
            read[rng.integers(0, len(read))] = ord("N")
        reads.append(bytes(read))
    fq = tmp_path / "reads.fa"
    with open(fq, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">r%d\n%s\n" % (i, r))

    contexts, counts = count_reads_kmers(str(fq), 11, ci=2, cs=255, chunk_kmers=64)
    got = {contexts[i].tobytes(): int(counts[i]) for i in range(len(counts))}
    assert got == _oracle(reads, 11)


def test_counter_gzip_fastq(tmp_path):
    reads = [b"ACGTACGTACGTACGT", b"ACGTACGTACGTACGT"]
    fq = tmp_path / "reads.fq.gz"
    with gzip.open(fq, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    contexts, counts = count_reads_kmers(str(fq), 7)
    got = {contexts[i].tobytes(): int(counts[i]) for i in range(len(counts))}
    assert got == _oracle(reads, 7)


def test_counter_ci_excludes_singletons(tmp_path):
    fq = tmp_path / "reads.fa"
    fq.write_bytes(b">a\nAAAAACC\n>b\nAAAAAGG\n")
    # 7-mers each occur once -> all excluded at ci=2
    contexts, counts = count_reads_kmers(str(fq), 7)
    assert len(counts) == 0
    contexts, counts = count_reads_kmers(str(fq), 7, ci=1)
    assert len(counts) == 2


def test_counter_checkpoint_resume(tmp_path):
    """A run resumed from a mid-stream checkpoint equals a clean run."""
    rng = np.random.default_rng(8)
    fq = tmp_path / "reads.fa"
    with open(fq, "wb") as f:
        for i in range(40):
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400).tobytes()
            f.write(b">r%d\n%s\n" % (i, seq))

    clean_k, clean_c = count_reads_kmers(str(fq), 11, ci=1)
    assert clean_c.sum() > 0

    ckpt = str(tmp_path / "count.ckpt.npz")
    # force many small batches + frequent checkpoints, interrupt midway
    # (at the batch iterator — backend-agnostic, native path included)
    import malva_tpu.count.counter as counter_mod

    orig = counter_mod.iter_read_batches

    class Boom(Exception):
        pass

    def tiny_batches(path, batch_bases=1 << 26, explode_at=None):
        for i, b in enumerate(orig(path, batch_bases=512)):
            if explode_at is not None and i == explode_at:
                raise Boom()
            yield b

    try:
        counter_mod.iter_read_batches = (
            lambda path, batch_bases=1 << 26: tiny_batches(path, explode_at=12)
        )
        try:
            count_reads_kmers(str(fq), 11, ci=1, checkpoint=ckpt, checkpoint_every_batches=2)
            assert False, "expected interruption"
        except Boom:
            pass
        import os
        assert os.path.exists(ckpt)
        counter_mod.iter_read_batches = tiny_batches
        res_k, res_c = count_reads_kmers(str(fq), 11, ci=1, checkpoint=ckpt, checkpoint_every_batches=2)
        assert not os.path.exists(ckpt)
    finally:
        counter_mod.iter_read_batches = orig

    np.testing.assert_array_equal(res_k, clean_k)
    np.testing.assert_array_equal(res_c, clean_c)


def test_device_counter_matches_host(tmp_path):
    rng = np.random.default_rng(21)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=800).tobytes()
    fq = tmp_path / "r.fa"
    with open(fq, "wb") as f:
        for i in range(60):
            s = int(rng.integers(0, 700))
            read = bytearray(base[s : s + 90])
            if rng.random() < 0.2:
                read[rng.integers(0, len(read))] = ord("N")
            f.write(b">r%d\n%s\n" % (i, bytes(read)))
    host_k, host_c = count_reads_kmers(str(fq), 43)
    dev_k, dev_c = count_reads_kmers(str(fq), 43, use_device=True, chunk_kmers=512)
    np.testing.assert_array_equal(dev_k, host_k)
    np.testing.assert_array_equal(dev_c, host_c)


def test_device_seq_counter_hard_cases(tmp_path):
    """Device (raw-sequence) counting == host path on lowercase reads,
    in-read Ns, reads shorter than ref_k, and multi-chunk streaming."""
    import numpy as np

    from malva_tpu.count.counter import count_reads_kmers

    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
    fq = tmp_path / "r.fa"
    with open(fq, "wb") as f:
        for i in range(120):
            L = int(rng.integers(5, 200))
            s = bytes(alpha[rng.integers(0, 10, size=L)])
            f.write(b">r%d\n%s\n" % (i, s))
    host_k, host_c = count_reads_kmers(str(fq), 43, ci=1)
    dev_k, dev_c = count_reads_kmers(str(fq), 43, ci=1, use_device=True, chunk_kmers=256)
    np.testing.assert_array_equal(dev_k, host_k)
    np.testing.assert_array_equal(dev_c, host_c)


@pytest.mark.parametrize("ref_k", [32, 16, 43])
def test_device_count_ref_k_multiple_of_16(tmp_path, ref_k):
    """Device counting parity when every packed-row pattern is reachable
    (ref_k % 16 == 0 used to be rejected)."""
    rng = np.random.default_rng(ref_k)
    alpha = np.frombuffer(b"ACGTN", dtype=np.uint8)
    fq = tmp_path / "reads.fa"
    with open(fq, "wb") as f:
        for i in range(60):
            seq = alpha[rng.integers(0, 5, size=90)].tobytes()
            f.write(b">r%d\n" % i + seq + b"\n")
    host_k, host_c = count_reads_kmers(
        str(fq), ref_k, ci=1, log=open(os.devnull, "w"), return_packed=True
    )
    dev_k, dev_c = count_reads_kmers(
        str(fq), ref_k, ci=1, log=open(os.devnull, "w"), return_packed=True,
        use_device=True, chunk_kmers=1 << 10,
    )
    np.testing.assert_array_equal(host_k, dev_k)
    np.testing.assert_array_equal(host_c, dev_c)


def test_wrapped_fastq_mid_file_falls_back(tmp_path):
    """A valid multi-line (wrapped) FASTQ whose first wrapped record sits
    past several fast-path yields must parse like the kseq-style parser,
    not raise: the fast path restarts the slow parser and
    skips the already-yielded (validated) reads."""
    from malva_tpu.io.fasta import iter_read_batches, iter_sequences

    p = tmp_path / "wrapped.fq"
    with open(p, "w") as f:
        for i in range(50):
            f.write(f"@r{i}\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
        # wrapped record: sequence and quality split over two lines
        f.write("@wrap\n" + "ACGT" * 5 + "\n" + "TTTT" * 5 + "\n+\n"
                + "I" * 20 + "\n" + "J" * 20 + "\n")
        for i in range(10):
            f.write(f"@s{i}\n" + "GGCC" * 10 + "\n+\n" + "I" * 40 + "\n")

    expected = [seq for _n, seq in iter_sequences(str(p))]
    # tiny batch_bases forces several yields before the wrapped record
    got = [r for b in iter_read_batches(str(p), batch_bases=200) for r in b]
    assert got == expected
    assert b"ACGT" * 5 + b"TTTT" * 5 in got  # the wrapped read, joined


def test_wrapped_fastq_all_chunk_alignments(tmp_path):
    """Boundary fuzz (code-review r5 finding 1): for EVERY chunk size,
    the fast path must never yield a read whose '+' line it has not yet
    validated — a chunk ending right after a seq line (phase==2) used to
    yield the first line of a wrapped record as a complete read."""
    from malva_tpu.io.fasta import iter_read_batches, iter_sequences

    p = tmp_path / "wrapped2.fq"
    with open(p, "w") as f:
        for i in range(12):
            f.write(f"@r{i}\n" + "ACGT" * 3 + "\n+\n" + "I" * 12 + "\n")
        f.write("@wrap\nAAAACCCC\nGGGGTTTT\n+\n" + "I" * 8 + "\n"
                + "J" * 8 + "\n")
        for i in range(6):
            f.write(f"@s{i}\n" + "GGCC" * 3 + "\n+\n" + "I" * 12 + "\n")
    expected = [seq for _n, seq in iter_sequences(str(p))]
    for chunk in range(16, 420, 7):
        got = [r for b in iter_read_batches(str(p), batch_bases=24,
                                            chunk_bytes=chunk) for r in b]
        assert got == expected, f"chunk_bytes={chunk}"
