"""Committed diploid regression gate.

The fixture in tests/data/diploid was generated with tests/fuzz_gen.py
(seed 20260817: 90 diploid records over a 6 kb contig, 8 samples, het /
hom-alt / multi-allelic calls with a spread of GQ values); golden.vcf is
the output of the reference genotyper compiled as the test oracle.  This
covers the diploid ground that the reference repo's missing chr20
example data would have covered, without requiring a compiler.
"""

import io
import os

import pytest

from malva_tpu.pipeline import build_index, call
from malva_tpu.utils.config import Config

D = os.path.join(os.path.dirname(__file__), "data", "diploid")


@pytest.mark.slow
def test_diploid_golden_bit_identical():
    cfg = Config(
        fasta_path=os.path.join(D, "ref.fa"),
        vcf_path=os.path.join(D, "vars.vcf"),
        sample_path=os.path.join(D, "reads.fa"),
        bf_size=Config.bf_gb_to_bits(1),
    )
    index = build_index(cfg)
    out = io.StringIO()
    call(cfg, index, out)
    golden = open(os.path.join(D, "golden.vcf")).read()
    assert out.getvalue() == golden


@pytest.mark.slow
def test_batch_matches_independent_calls(tmp_path):
    """call_batch over [sampleA, sampleA] == two independent calls."""
    from malva_tpu.pipeline import call_batch

    cfg = Config(
        fasta_path=os.path.join(D, "ref.fa"),
        vcf_path=os.path.join(D, "vars.vcf"),
        sample_path=os.path.join(D, "reads.fa"),
        bf_size=Config.bf_gb_to_bits(1),
    )
    index = build_index(cfg)
    o1, o2 = io.StringIO(), io.StringIO()
    call_batch(cfg, index, [os.path.join(D, "reads.fa")] * 2, [o1, o2])
    golden = open(os.path.join(D, "golden.vcf")).read()
    assert o1.getvalue() == golden
    assert o2.getvalue() == golden


@pytest.mark.slow
def test_batch_device_backend_reuses_index(tmp_path):
    """Device-backend batch genotyping (one uploaded index, counter state
    rebuilt from host per sample) == golden for every sample."""
    from malva_tpu.pipeline import call_batch

    cfg = Config(
        fasta_path=os.path.join(D, "ref.fa"),
        vcf_path=os.path.join(D, "vars.vcf"),
        sample_path=os.path.join(D, "reads.fa"),
        bf_size=Config.bf_gb_to_bits(1),
        backend="device",
    )
    index = build_index(cfg)
    o1, o2 = io.StringIO(), io.StringIO()
    call_batch(cfg, index, [os.path.join(D, "reads.fa")] * 2, [o1, o2])
    golden = open(os.path.join(D, "golden.vcf")).read()
    assert o1.getvalue() == golden
    assert o2.getvalue() == golden


def test_device_backend_end_to_end():
    """Full pipeline with backend='device' (device ref scan + device
    sort-count + packed call step, all plain XLA) == golden: the route
    `run --backend device` takes on a GPU, here on JAX's CPU backend."""
    cfg = Config(
        fasta_path=os.path.join(D, "ref.fa"),
        vcf_path=os.path.join(D, "vars.vcf"),
        sample_path=os.path.join(D, "reads.fa"),
        bf_size=Config.bf_gb_to_bits(1),
        backend="device",
    )
    index = build_index(cfg)
    out = io.StringIO()
    call(cfg, index, out)
    golden = open(os.path.join(D, "golden.vcf")).read()
    assert out.getvalue() == golden


def test_batch_distinct_samples_match_serial(tmp_path):
    """call_batch over DISTINCT read sets == independent calls, byte for
    byte (exercises the per-sample counter planes + shared VCF pass)."""
    import numpy as np

    from malva_tpu.pipeline import call_batch

    def _cfg():
        return Config(
            fasta_path=os.path.join(D, "ref.fa"),
            vcf_path=os.path.join(D, "vars.vcf"),
            sample_path=os.path.join(D, "reads.fa"),
            bf_size=Config.bf_gb_to_bits(1),
        )

    rng = np.random.default_rng(99)
    samples = []
    src = open(os.path.join(D, "reads.fa"), "rb").read().splitlines()
    for s in range(3):
        # mutate a few read bases so counters genuinely differ per sample
        lines = []
        for ln in src:
            if ln.startswith(b">") or rng.random() > 0.5:
                lines.append(ln)
                continue
            b = bytearray(ln)
            for _ in range(3):
                b[rng.integers(0, len(b))] = ord("ACGT"[rng.integers(0, 4)])
            lines.append(bytes(b))
        p = tmp_path / f"s{s}.fa"
        p.write_bytes(b"\n".join(lines) + b"\n")
        samples.append(str(p))

    cfg = _cfg()
    index = build_index(cfg)
    serial = []
    for p in samples:
        c = _cfg()
        c.sample_path = p
        from malva_tpu.pipeline import _reset_counters

        _reset_counters(index)
        out = io.StringIO()
        call(c, index, out)
        serial.append(out.getvalue())

    _reset_counters(index)
    index2 = build_index(cfg)
    outs = [io.StringIO() for _ in samples]
    call_batch(cfg, index2, samples, outs)
    for got, want in zip(outs, serial):
        assert got.getvalue() == want
