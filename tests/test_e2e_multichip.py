"""Full-pipeline multi-device E2E parity.

Runs the COMPLETE product pipeline (count -> index -> call) twice on the
haploid example inputs: once with the host backend on one device, once
with backend=device on the 8-virtual-device CPU mesh — which routes the
index-phase context scan through parallel.sharded_index.build_context_
sharded AND the call-phase query/update through the routed
apply_sample_counts_sharded_stream (pipeline._call_mesh).  The two VCFs
must be byte-identical: the multi-chip path is the product path, not a
test-only step (reference semantics: main.cpp:251-594).
"""

import io
import os
import tarfile

import pytest

from malva_tpu.pipeline import build_index, call
from malva_tpu.utils.config import Config

REF_EXAMPLE = "/root/reference/example"


@pytest.fixture(scope="module")
def haploid_inputs(tmp_path_factory):
    tar = os.path.join(REF_EXAMPLE, "haploid.tar.gz")
    if not os.path.exists(tar):
        pytest.skip("reference example data not available")
    d = tmp_path_factory.mktemp("haploid_mc")
    with tarfile.open(tar) as tf:
        tf.extractall(d)
    return d


def _cfg(d, backend):
    return Config(
        fasta_path=str(d / "haploid.fa"),
        vcf_path=str(d / "haploid.vcf"),
        sample_path=str(d / "haploid.fq"),
        bf_size=1 << 26,  # 2^21 words: divisible by 8 shards, light on CPU
        freq_key="AF",
        haploid=True,
        backend=backend,
    )


@pytest.mark.slow
def test_full_pipeline_mesh_vs_single_device(haploid_inputs, monkeypatch):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    d = haploid_inputs
    monkeypatch.setenv("MALVA_SHARD_BATCH", str(1 << 14))
    # force the device floors down so the tiny example routes to the mesh
    monkeypatch.setattr("malva_tpu.pipeline.DEVICE_MIN_REF_POSITIONS", 0)
    monkeypatch.setattr("malva_tpu.pipeline.DEVICE_MIN_KMERS", 0)
    monkeypatch.setattr("malva_tpu.pipeline.DEVICE_MIN_READ_BYTES", 0)

    host_out = io.StringIO()
    cfg_h = _cfg(d, "host")
    call(cfg_h, build_index(cfg_h), host_out)

    mesh_out = io.StringIO()
    cfg_m = _cfg(d, "device")
    call(cfg_m, build_index(cfg_m), mesh_out)

    assert mesh_out.getvalue() == host_out.getvalue()
    assert mesh_out.getvalue().count("\n") > 400  # all 418 records emitted


@pytest.mark.slow
def test_call_batch_routes_mesh(haploid_inputs, monkeypatch):
    """call_batch routes phase A through the routed sharded session when a
    mesh is attached (same routing contract as call)."""
    import jax

    from malva_tpu.pipeline import call_batch

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    d = haploid_inputs
    monkeypatch.setenv("MALVA_SHARD_BATCH", str(1 << 14))
    monkeypatch.setattr("malva_tpu.pipeline.DEVICE_MIN_REF_POSITIONS", 0)
    monkeypatch.setattr("malva_tpu.pipeline.DEVICE_MIN_KMERS", 0)
    monkeypatch.setattr("malva_tpu.pipeline.DEVICE_MIN_READ_BYTES", 0)

    cfg_h = _cfg(d, "host")
    index = build_index(cfg_h)
    host_outs = [io.StringIO(), io.StringIO()]
    call_batch(cfg_h, index, [str(d / "haploid.fq")] * 2, host_outs)

    cfg_m = _cfg(d, "device")
    index_m = build_index(cfg_m)
    mesh_outs = [io.StringIO(), io.StringIO()]
    call_batch(cfg_m, index_m, [str(d / "haploid.fq")] * 2, mesh_outs)

    for h, m in zip(host_outs, mesh_outs):
        assert m.getvalue() == h.getvalue()
        assert m.getvalue().count("\n") > 400
