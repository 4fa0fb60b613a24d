"""Overlapped `run`: counting runs in a helper process while the index
phase builds.  Output must be byte-identical to the
serial path — the overlap only reorders work between disjoint inputs."""

import os
import tarfile

import pytest

from malva_tpu import cli

REF_EXAMPLE = "/root/reference/example"


@pytest.fixture(scope="module")
def haploid_inputs(tmp_path_factory):
    tar = os.path.join(REF_EXAMPLE, "haploid.tar.gz")
    if not os.path.exists(tar):
        pytest.skip("reference example data not available")
    d = tmp_path_factory.mktemp("overlap")
    with tarfile.open(tar) as tf:
        tf.extractall(d)
    return d


@pytest.mark.slow
def test_overlapped_run_matches_golden(haploid_inputs, tmp_path, capsys,
                                       monkeypatch):
    d = haploid_inputs
    monkeypatch.setenv("MALVA_OVERLAP_MIN_BYTES", "1")  # force the overlap
    args = ["run", "-1", "-b", "1", "-f", "AF",
            str(d / "haploid.fa"), str(d / "haploid.vcf"),
            str(d / "haploid.fq")]
    assert cli.main(args) == 0
    cap = capsys.readouterr()
    assert "counting overlapped with index build" in cap.err
    golden = open(os.path.join(REF_EXAMPLE, "haploid.malva.vcf")).read()
    assert cap.out == golden
    os.remove(str(d / "haploid.vcf") + ".c43.k35.malvax.npz")


@pytest.mark.slow
def test_overlap_disabled_env(haploid_inputs, tmp_path, capsys, monkeypatch):
    d = haploid_inputs
    monkeypatch.setenv("MALVA_OVERLAP_MIN_BYTES", "1")
    monkeypatch.setenv("MALVA_NO_OVERLAP", "1")
    args = ["run", "-1", "-b", "1", "-f", "AF",
            str(d / "haploid.fa"), str(d / "haploid.vcf"),
            str(d / "haploid.fq")]
    assert cli.main(args) == 0
    cap = capsys.readouterr()
    assert "counting overlapped" not in cap.err
    golden = open(os.path.join(REF_EXAMPLE, "haploid.malva.vcf")).read()
    assert cap.out == golden
    os.remove(str(d / "haploid.vcf") + ".c43.k35.malvax.npz")


def test_auto_spill_dir_prefers_shm(monkeypatch):
    """Small spills land on /dev/shm (block-device writeback throttles
    np.save to ~100 MB/s on this VM class); huge estimates and the
    MALVA_SPILL_SHM=0 opt-out fall back to the default temp dir."""
    import shutil

    if not os.path.isdir("/dev/shm") or not os.access("/dev/shm", os.W_OK):
        pytest.skip("no /dev/shm")
    d = cli._auto_spill_dir(1 << 20)
    try:
        assert d.startswith("/dev/shm/")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    # absurd size estimate: must NOT pick shm
    d2 = cli._auto_spill_dir(1 << 60)
    try:
        assert not d2.startswith("/dev/shm/")
    finally:
        shutil.rmtree(d2, ignore_errors=True)
    monkeypatch.setenv("MALVA_SPILL_SHM", "0")
    d3 = cli._auto_spill_dir(1 << 20)
    try:
        assert not d3.startswith("/dev/shm/")
    finally:
        shutil.rmtree(d3, ignore_errors=True)


def test_producer_child_never_imports_jax(haploid_inputs, tmp_path):
    """The counting helper must never open the accelerator the parent
    holds: its entry installs an import guard that raises on any jax import.
    A clean rc=0 run proves the host counting path honors it."""
    import subprocess
    import sys

    d = haploid_inputs
    spill = tmp_path / "spill"
    p = subprocess.run(
        [sys.executable, "-m", "malva_tpu.count.spill",
         str(d / "haploid.fq"), "43", str(spill)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.dirname(os.path.abspath(cli.__file__)))},
    )
    assert p.returncode == 0, p.stderr
    assert "k-mer occurrences" in p.stderr
