"""Device path on the card.  Each test takes the ``gpu`` fixture, which
skips unless JAX's backend is a GPU; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import io
import os

import numpy as np
import pytest

from malva_tpu.index.bloom_filter import BF
from malva_tpu.index.device import apply_sample_counts_device, build_context_device
from malva_tpu.index.kmap import KMAP
from malva_tpu.ops.seq import canonical
from malva_tpu.pipeline import Index, apply_sample_counts, build_index, call
from malva_tpu.utils.config import Config

D = os.path.join(os.path.dirname(__file__), "data", "diploid")
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def _index(cfg, rng):
    bf, km, ctx = BF(cfg.bf_size), KMAP(), BF(cfg.bf_size)
    alt = ALPHA[rng.integers(0, 4, size=(3000, cfg.k))]
    ref = canonical(ALPHA[rng.integers(0, 4, size=(3000, cfg.k))])
    bf.add_keys(alt)
    km.add_keys(ref)
    ctx.add_keys(ALPHA[rng.integers(0, 4, size=(2000, cfg.ref_k))])
    bf.switch_mode()
    ctx.switch_mode()
    return Index(bf=bf, ref_bf=km, context_bf=ctx), alt, ref


@pytest.mark.gpu
def test_call_step_on_gpu_matches_host(gpu):
    cfg = Config(k=35, ref_k=43, bf_size=1 << 24)
    host, alt, ref = _index(cfg, np.random.default_rng(1))
    dev, _, _ = _index(cfg, np.random.default_rng(1))
    rng = np.random.default_rng(2)
    contexts = ALPHA[rng.integers(0, 4, size=(20000, cfg.ref_k))]
    contexts[:2000, 4:39] = alt[:2000]
    contexts[2000:4000, 4:39] = ref[:2000]
    contexts = canonical(contexts)
    counters = rng.integers(1, 255, size=contexts.shape[0]).astype(np.uint32)
    apply_sample_counts(host, contexts, counters, cfg)
    apply_sample_counts_device(dev, contexts, counters, cfg, batch=4096)
    np.testing.assert_array_equal(host.bf.counts, dev.bf.counts)
    assert host.ref_bf.kmers == dev.ref_bf.kmers


@pytest.mark.gpu
def test_ref_scan_on_gpu_matches_host(gpu):
    cfg = Config(k=35, ref_k=43, bf_size=1 << 24)
    rng = np.random.default_rng(3)
    contig = ALPHA[rng.integers(0, 4, size=200_000)]
    host, _, _ = _index(cfg, rng)
    for s in range(1000, 190_000, 7919):
        host.bf.add_keys(contig[s + 4 : s + 39][None, :])
    dev = Index(bf=host.bf, ref_bf=KMAP(), context_bf=BF(cfg.bf_size))
    win = np.lib.stride_tricks.sliding_window_view(contig, cfg.ref_k)
    want = BF(cfg.bf_size)
    want.add_keys(np.ascontiguousarray(win[host.bf.test_keys(win[:, 4:39])]))
    build_context_device(dev, [contig], cfg, chunk=1 << 16)
    np.testing.assert_array_equal(want.words, dev.context_bf.words)


@pytest.mark.gpu
def test_device_backend_golden_on_gpu(gpu):
    cfg = Config(
        fasta_path=os.path.join(D, "ref.fa"),
        vcf_path=os.path.join(D, "vars.vcf"),
        sample_path=os.path.join(D, "reads.fa"),
        bf_size=Config.bf_gb_to_bits(1),
        backend="device",
    )
    out = io.StringIO()
    call(cfg, build_index(cfg), out)
    with open(os.path.join(D, "golden.vcf")) as f:
        assert out.getvalue() == f.read()
