"""Error-path hardening: bad inputs fail with a
one-line `[malva-tpu] ERROR:` on stderr — the reference's explicit
`ERROR:` exit contract (main.cpp:262-281) — never a traceback; plus the
KMC round-trip fuzz over counter_size x lut_prefix_length."""

import io
import os
import sys

import numpy as np
import pytest

from malva_tpu import cli
from malva_tpu.io.kmc import read_kmc_db, write_kmc_db


def _run_cli(argv, capsys):
    rc = cli.main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _err_lines(err):
    return [l for l in err.splitlines() if l.startswith("ERROR:")]


def test_missing_input_files(tmp_path, capsys):
    rc, out, err = _run_cli(
        ["call", "-b", "1", str(tmp_path / "no.fa"), str(tmp_path / "no.vcf"),
         str(tmp_path / "no.fq")],
        capsys,
    )
    assert rc == 1
    assert len(_err_lines(err)) == 1
    assert out == ""  # stdout stays pure VCF: nothing on failure


def test_corrupt_index_npz(tmp_path, capsys):
    fa = tmp_path / "r.fa"
    fa.write_text(">c\n" + "ACGT" * 30 + "\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        '##INFO=<ID=AF,Number=A,Type=Float,Description="af">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "c\t60\t.\tA\tC\t.\t.\tAF=0.5\tGT\t0|1\n"
    )
    fq = tmp_path / "s.fq"
    fq.write_text("@r\n" + "ACGT" * 30 + "\n+\n" + "I" * 120 + "\n")
    idx = tmp_path / "v.vcf.c43.k35.malvax.npz"
    idx.write_bytes(b"PK\x03\x04garbage-not-a-real-zip")
    rc, out, err = _run_cli(
        ["call", "-b", "1", str(fa), str(vcf), str(fq)], capsys
    )
    assert rc == 1
    lines = _err_lines(err)
    assert len(lines) == 1 and "not a valid malva index" in lines[0]


def test_truncated_vcf_record(tmp_path, capsys):
    fa = tmp_path / "r.fa"
    fa.write_text(">c\n" + "ACGT" * 30 + "\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "c\t60\t.\tA\tC\t.\t.\tAF=0.5\tGT\t0|1\n"
        "c\t70\t.\tA\tC\t.\t."  # mid-record truncation
    )
    fq = tmp_path / "s.fq"
    fq.write_text("@r\n" + "ACGT" * 30 + "\n+\n" + "I" * 120 + "\n")
    rc, out, err = _run_cli(
        ["run", "-b", "1", str(fa), str(vcf), str(fq)], capsys
    )
    assert rc == 1
    lines = _err_lines(err)
    assert len(lines) == 1 and "truncated VCF record" in lines[0]


def test_truncated_malvax_stream(tmp_path, capsys):
    fa = tmp_path / "r.fa"
    fa.write_text(">c\n" + "ACGT" * 30 + "\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "c\t60\t.\tA\tC\t.\t.\tAF=0.5\tGT\t0|1\n"
    )
    fq = tmp_path / "s.fq"
    fq.write_text("@r\n" + "ACGT" * 30 + "\n+\n" + "I" * 120 + "\n")
    try:
        import zstandard
    except ImportError:
        pytest.skip("zstandard unavailable")
    z = tmp_path / "v.vcf.c43.k35.malvax.zst"
    z.write_bytes(zstandard.ZstdCompressor().compress(b"\x01\x00\x00"))
    rc, out, err = _run_cli(
        ["call", "--malvax", "-b", "1", str(fa), str(vcf), str(fq)], capsys
    )
    assert rc == 1
    assert len(_err_lines(err)) == 1


def test_kmc_db_with_wrong_k(tmp_path, capsys):
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(0)
    kmers = alpha[rng.integers(0, 4, size=(32, 21))]
    write_kmc_db(str(tmp_path / "db"), kmers, np.full(32, 3, np.uint32))
    fa = tmp_path / "r.fa"
    fa.write_text(">c\n" + "ACGT" * 30 + "\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "c\t60\t.\tA\tC\t.\t.\tAF=0.5\tGT\t0|1\n"
    )
    rc, out, err = _run_cli(
        ["run", "--from-kmc", "-b", "1", str(fa), str(vcf),
         str(tmp_path / "db")],
        capsys,
    )
    assert rc == 1
    lines = _err_lines(err)
    assert len(lines) == 1 and "k=21" in lines[0]


def test_kmc_pre_truncated(tmp_path, capsys):
    (tmp_path / "db.kmc_pre").write_bytes(b"KMCP\x00\x01")
    (tmp_path / "db.kmc_suf").write_bytes(b"KMCS")
    fa = tmp_path / "r.fa"
    fa.write_text(">c\n" + "ACGT" * 30 + "\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "c\t60\t.\tA\tC\t.\t.\tAF=0.5\tGT\t0|1\n"
    )
    rc, out, err = _run_cli(
        ["run", "--from-kmc", "-b", "1", str(fa), str(vcf),
         str(tmp_path / "db")],
        capsys,
    )
    assert rc == 1
    assert len(_err_lines(err)) == 1


@pytest.mark.parametrize("counter_size", [1, 2, 3, 4])
@pytest.mark.parametrize("lut_offset", [0, 4, 8])
def test_kmc_roundtrip_counter_and_lut_sizes(tmp_path, counter_size,
                                             lut_offset):
    """KMC DB round-trip fuzz over counter_size x lut_prefix_length:
    write -> read must preserve the exact (k-mer, count)
    set for every supported layout.  KMC stores suffixes in 4-base bytes,
    so lut_prefix must satisfy k == lut_prefix (mod 4)."""
    rng = np.random.default_rng(100 * counter_size + lut_offset)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    n, k = 257, 27
    lut_prefix = k % 4 + lut_offset  # 3, 7, 11
    kmers = np.unique(
        alpha[rng.integers(0, 4, size=(n, k))].view(f"V{k}").ravel()
    ).view(np.uint8).reshape(-1, k)
    hi = (1 << (8 * counter_size)) - 1
    counts = rng.integers(1, min(hi, 1 << 20) + 1,
                          size=kmers.shape[0]).astype(np.uint32)
    p = str(tmp_path / "db")
    write_kmc_db(p, kmers, counts, lut_prefix_length=lut_prefix,
                 counter_size=counter_size)
    rk, rc, info = read_kmc_db(p)
    assert info["counter_size"] == counter_size
    assert info["lut_prefix_length"] == lut_prefix
    got = {bytes(a): int(c) for a, c in zip(rk, rc)}
    want = {bytes(a): int(c) for a, c in zip(kmers, counts)}
    assert got == want


def _mini_inputs(tmp_path, pos="60", qual=".", gt="0|1"):
    fa = tmp_path / "r.fa"
    fa.write_text(">c\n" + "ACGT" * 30 + "\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        '##INFO=<ID=AF,Number=A,Type=Float,Description="af">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        f"c\t{pos}\t.\tA\tC\t{qual}\t.\tAF=0.5\tGT\t{gt}\n"
    )
    fq = tmp_path / "s.fq"
    fq.write_text("@r\n" + "ACGT" * 30 + "\n+\n" + "I" * 120 + "\n")
    return fa, vcf, fq


@pytest.mark.parametrize("kw", [{"pos": "abc"}, {"qual": "junk"},
                                {"gt": "0|x"}])
def test_malformed_vcf_field_one_line_error(tmp_path, capsys, kw):
    """Malformed POS/QUAL/GT values are user input, not internal bugs:
    one ERROR line, exit 1, never a traceback (code-review r5 finding 2)."""
    fa, vcf, fq = _mini_inputs(tmp_path, **kw)
    rc, out, err = _run_cli(
        ["run", "-b", "1", str(fa), str(vcf), str(fq)], capsys
    )
    assert rc == 1, err
    assert len(_err_lines(err)) == 1, err
    assert out == ""


def test_stale_index_fingerprint_rebuilds(tmp_path, capsys):
    """A persisted index is keyed only by (vcf, ref_k, k); a later run
    with different index-shaping options must rebuild, not silently
    reuse (code-review r5 finding 3)."""
    fa, vcf, fq = _mini_inputs(tmp_path)
    args = ["run", "-b", "1", str(fa), str(vcf), str(fq)]
    assert cli.main(args) == 0
    out1 = capsys.readouterr().out
    # different -u changes frequencies -> index content
    assert cli.main(args + ["-u"]) == 0
    cap = capsys.readouterr()
    assert "rebuilding" in cap.err and "reusing index" not in cap.err
    # and same-options rerun still reuses
    assert cli.main(args) == 0
    cap = capsys.readouterr()
    assert "rebuilding" in cap.err or "reusing index" in cap.err
