"""KMC binary database (.kmc_pre/.kmc_suf) reader/writer gates."""

import io
import os

import numpy as np
import pytest

from malva_tpu.io.kmc import load_kmc_db, read_kmc_db, write_kmc_db
from malva_tpu.ops.seq import canonical


def _canon_kmers(n, k, seed=0):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    arr = canonical(alpha[rng.integers(0, 4, size=(n, k))])
    arr = np.unique(arr, axis=0)
    counts = rng.integers(1, 1 << 20, size=arr.shape[0]).astype(np.uint32)
    return arr, counts


@pytest.mark.parametrize("k,counter_size", [(43, 4), (43, 1), (31, 2), (21, 3)])
def test_kmc_roundtrip(tmp_path, k, counter_size):
    kmers, counts = _canon_kmers(5000, k, seed=k)
    cs_max = (1 << (8 * counter_size)) - 1
    counts = np.minimum(counts, cs_max).astype(np.uint32)
    prefix = str(tmp_path / "db")
    write_kmc_db(prefix, kmers, counts, counter_size=counter_size)
    got_k, got_c, info = read_kmc_db(prefix)
    assert info["kmer_length"] == k
    assert info["total_kmers"] == kmers.shape[0]
    assert info["both_strands"]
    # reader returns sorted records; sort the reference the same way
    order = np.lexsort(tuple(kmers[:, j] for j in range(k - 1, -1, -1)))
    np.testing.assert_array_equal(got_k, kmers[order])
    np.testing.assert_array_equal(got_c, counts[order])


def test_kmc_db_equals_text_dump(tmp_path):
    """Same (contexts, counts) through the binary DB and the text dump."""
    from malva_tpu.count.counter import load_kmc_dump

    kmers, counts = _canon_kmers(2000, 43, seed=3)
    prefix = str(tmp_path / "db")
    write_kmc_db(prefix, kmers, counts)
    dump = tmp_path / "db.txt"
    with open(dump, "wb") as f:
        for i in range(kmers.shape[0]):
            f.write(kmers[i].tobytes() + b"\t%d\n" % counts[i])
    bk, bc = load_kmc_db(prefix, 43)
    tk, tc = load_kmc_dump(str(dump), 43)
    bd = {bk[i].tobytes(): int(bc[i]) for i in range(bk.shape[0])}
    td = {tk[i].tobytes(): int(tc[i]) for i in range(tk.shape[0])}
    assert bd == td


def _write_kmc1_db(prefix, kmers, counts, lut_prefix_length=3, counter_size=2):
    """Hand-crafted KMC1 (version-0) database, built byte-by-byte from the
    published format — deliberately NOT via io.kmc.write_kmc_db (which only
    emits v2), so the reader's v0 branch is exercised against an
    independent construction.  v0 differences: no signature map between
    LUT and header, no signature_len header field, version tag 0."""
    import struct

    n, k = kmers.shape
    assert (k - lut_prefix_length) % 4 == 0
    code = np.full(256, 255, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        code[ch] = i
    codes = code[kmers].astype(np.uint64)
    assert codes.max() <= 3

    # sort by k-mer (2-bit order), as KMC stores records
    keyw = np.zeros((n, (k + 31) // 32), dtype=np.uint64)
    for j in range(k):
        keyw[:, j // 32] |= codes[:, j] << np.uint64(2 * (31 - (j % 32)))
    order = np.lexsort(tuple(keyw[:, w] for w in range(keyw.shape[1] - 1, -1, -1)))
    codes, counts = codes[order], np.asarray(counts, np.uint32)[order]

    prefix_vals = np.zeros(n, dtype=np.int64)
    for j in range(lut_prefix_length):
        prefix_vals = (prefix_vals << 2) | codes[:, j].astype(np.int64)
    n_pref = 1 << (2 * lut_prefix_length)
    per = np.zeros(n_pref, np.int64)
    np.add.at(per, prefix_vals, 1)
    lut = np.zeros(n_pref + 1, dtype="<u8")
    lut[1:] = np.cumsum(per)

    suffix_bytes = (k - lut_prefix_length) // 4
    rec = np.zeros((n, suffix_bytes + counter_size), dtype=np.uint8)
    for j in range(k - lut_prefix_length):
        rec[:, j // 4] |= codes[:, lut_prefix_length + j].astype(np.uint8) << np.uint8(
            2 * (3 - (j % 4))
        )
    for b in range(counter_size):
        rec[:, suffix_bytes + b] = (counts >> np.uint32(8 * b)).astype(np.uint8)

    header = struct.pack("<4I", k, 0, counter_size, lut_prefix_length)
    header += struct.pack("<2I", 2, 255)           # min_count, max_count
    header += struct.pack("<Q", n)
    header += bytes([0, 0, 0, 0])                  # both_strands (inverted) + pad
    header += struct.pack("<I", 0)                 # KMC1 version tag
    with open(prefix + ".kmc_pre", "wb") as f:
        f.write(b"KMCP" + lut.tobytes() + header)
        f.write(struct.pack("<I", len(header)) + b"KMCP")
    with open(prefix + ".kmc_suf", "wb") as f:
        f.write(b"KMCS" + rec.tobytes() + b"KMCS")


def test_kmc1_v0_database(tmp_path):
    """read_kmc_db on a hand-crafted KMC1 (version-0) database == the v2
    path on identical records (exercises io/kmc.py's v0 header/LUT branch,
    previously dead-untested)."""
    kmers, counts = _canon_kmers(4000, 43, seed=11)
    counts = np.minimum(counts, 0xFFFF).astype(np.uint32)  # counter_size=2
    p1, p2 = str(tmp_path / "v0"), str(tmp_path / "v2")
    _write_kmc1_db(p1, kmers, counts, lut_prefix_length=3, counter_size=2)
    write_kmc_db(p2, kmers, counts, counter_size=2)

    k0, c0, info0 = read_kmc_db(p1)
    k2, c2, info2 = read_kmc_db(p2)
    assert info0["version"] == 0 and info0["signature_len"] == 0
    assert info0["kmer_length"] == 43 and info0["both_strands"]
    np.testing.assert_array_equal(k0, k2)
    np.testing.assert_array_equal(c0, c2)

    # pipeline entry accepts the v0 database too
    lk, lc = load_kmc_db(p1, 43)
    np.testing.assert_array_equal(lk, k2)
    np.testing.assert_array_equal(lc, c2)


def test_kmc_k_mismatch(tmp_path):
    kmers, counts = _canon_kmers(100, 31, seed=1)
    prefix = str(tmp_path / "db")
    write_kmc_db(prefix, kmers, counts)
    with pytest.raises(ValueError, match="!= ref_k"):
        load_kmc_db(prefix, 43)


@pytest.fixture(scope="module")
def haploid_inputs(tmp_path_factory):
    import tarfile

    tar = "/root/reference/example/haploid.tar.gz"
    if not os.path.exists(tar):
        pytest.skip("reference example data not available")
    d = tmp_path_factory.mktemp("haploid")
    with tarfile.open(tar) as tf:
        tf.extractall(d)
    return d


@pytest.mark.slow
def test_kmc_db_pipeline_byte_identical(tmp_path, haploid_inputs):
    """call --from-kmc on a DB built from our counter's output == the
    normal in-process pipeline, byte for byte (and both == the golden)."""
    from malva_tpu.count.counter import count_reads_kmers
    from malva_tpu.pipeline import build_index, call
    from malva_tpu.utils.config import Config

    d = haploid_inputs
    contexts, counts = count_reads_kmers(
        str(d / "haploid.fq"), 43, log=open(os.devnull, "w")
    )
    prefix = str(tmp_path / "sample_db")
    write_kmc_db(prefix, contexts, counts)

    cfg = Config(
        fasta_path=str(d / "haploid.fa"),
        vcf_path=str(d / "haploid.vcf"),
        sample_path=prefix,
        bf_size=Config.bf_gb_to_bits(1),
        freq_key="AF",
        haploid=True,
        from_kmc_db=True,
    )
    index = build_index(cfg)
    out = io.StringIO()
    call(cfg, index, out)
    golden = open("/root/reference/example/haploid.malva.vcf").read()
    assert out.getvalue() == golden


def test_iter_kmc_db_streaming_matches_whole(tmp_path):
    """iter_kmc_db with a tiny batch size == whole-file read (WGS DBs are
    consumed batch-by-batch; the LUT binary search must agree with the
    repeat-based decode, including empty prefixes)."""
    from malva_tpu.io.kmc import iter_kmc_db

    kmers, counts = _canon_kmers(3000, 43, seed=7)
    prefix = str(tmp_path / "db")
    write_kmc_db(prefix, kmers, counts)
    whole_k, whole_c, _ = read_kmc_db(prefix)
    got_k, got_c = [], []
    for bk, bc in iter_kmc_db(prefix, batch_kmers=257):
        assert bk.shape[0] <= 257
        got_k.append(bk)
        got_c.append(bc)
    np.testing.assert_array_equal(np.concatenate(got_k), whole_k)
    np.testing.assert_array_equal(np.concatenate(got_c), whole_c)


def test_iter_kmc_dump_streaming(tmp_path):
    """Chunked text-dump parse == whole-file parse; counts parsed
    positionally; lowercase uppercased; CRLF tolerated; bad k raises."""
    import gzip

    from malva_tpu.count.counter import iter_kmc_dump, load_kmc_dump

    kmers, counts = _canon_kmers(997, 43, seed=3)
    path = tmp_path / "d.txt"
    with open(path, "wb") as f:
        for i in range(kmers.shape[0]):
            row = kmers[i].tobytes()
            if i % 3 == 0:
                row = row.lower()
            eol = b"\r\n" if i % 5 == 0 else b"\n"
            f.write(row + b"\t" + str(counts[i]).encode() + eol)
    whole_k, whole_c = load_kmc_dump(str(path), 43)
    np.testing.assert_array_equal(whole_k, kmers)
    np.testing.assert_array_equal(whole_c, counts)
    got = list(iter_kmc_dump(str(path), 43, chunk_bytes=301))
    np.testing.assert_array_equal(np.concatenate([k for k, _ in got]), kmers)
    np.testing.assert_array_equal(np.concatenate([c for _, c in got]), counts)

    gz = tmp_path / "d.txt.gz"
    with open(path, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    gz_k, gz_c = load_kmc_dump(str(gz), 43)
    np.testing.assert_array_equal(gz_k, kmers)
    np.testing.assert_array_equal(gz_c, counts)

    bad = tmp_path / "bad.txt"
    bad.write_bytes(b"ACGT\t5\n")
    with pytest.raises(ValueError):
        load_kmc_dump(str(bad), 43)


def test_kmc_stream_pipeline_byte_identical(tmp_path, haploid_inputs):
    """call with --from-kmc consuming the DB as a STREAM (batched) equals
    the whole-array path byte-for-byte."""
    from malva_tpu import pipeline
    from malva_tpu.count.counter import count_reads_kmers
    from malva_tpu.utils.config import Config

    d = haploid_inputs
    fa, vcf, fq = str(d / "haploid.fa"), str(d / "haploid.vcf"), str(d / "haploid.fq")
    kmers, counts = count_reads_kmers(fq, 43, log=open(os.devnull, "w"))
    prefix = str(tmp_path / "db")
    write_kmc_db(prefix, kmers, counts)

    base = dict(fasta_path=fa, vcf_path=vcf, k=35, ref_k=43,
                bf_size=1 << 33, freq_key="AF", haploid=True, backend="host")
    outs = []
    for _ in range(2):
        cfg = Config(sample_path=prefix, from_kmc_db=True, **base)
        idx = pipeline.build_index(cfg)
        buf = io.StringIO()
        pipeline.call(cfg, idx, out=buf)
        outs.append(buf.getvalue())
    # second run consumed via the whole-array loader
    cfg = Config(sample_path=prefix, from_kmc_db=True, **base)
    idx = pipeline.build_index(cfg)
    from malva_tpu.io.kmc import load_kmc_db

    contexts, cnts = load_kmc_db(prefix, 43)
    pipeline.apply_sample_counts(idx, contexts, cnts, cfg)
    buf = io.StringIO()
    pipeline._genotype_and_emit(cfg, idx, pipeline.load_reference(fa, False), buf,
                                pipeline.PhaseTimer())
    assert outs[0] == outs[1] == buf.getvalue()
