"""Real multi-process jax.distributed runs.

Spawns local CPU processes with a 127.0.0.1 coordinator — genuinely
exercising jax.distributed.initialize, host_shard, the one-round
all_to_all hash-range (key, count) exchange, and the psum counter-plane
merge with ``process_count > 1`` — and requires the rank-0 VCF
byte-identical to the committed reference golden (splitting the read set
across processes does not change the global k-mer multiset, so output
must not change).
"""

import os
import socket
import subprocess
import sys
import tarfile

import pytest

REF_EXAMPLE = "/root/reference/example"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def split_inputs(tmp_path_factory):
    tar = os.path.join(REF_EXAMPLE, "haploid.tar.gz")
    if not os.path.exists(tar):
        pytest.skip("reference example data not available")
    d = tmp_path_factory.mktemp("dist")
    with tarfile.open(tar) as tf:
        tf.extractall(d)
    # split the FASTQ into four read files (4 lines per record)
    lines = open(d / "haploid.fq").read().splitlines(keepends=True)
    recs = [lines[i : i + 4] for i in range(0, len(lines), 4)]
    for part in range(4):
        with open(d / f"reads{part}.fq", "w") as f:
            for r in recs[part::4]:
                f.writelines(r)
    return d


def _launch(d, tmp_path, n_procs, spill, out):
    port = _free_port()
    procs = []
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)  # one device per process
    reads = [str(d / f"reads{p}.fq") for p in range(4)]
    for pid in range(n_procs):
        args = [
            sys.executable, os.path.join(REPO, "tools", "run_distributed.py"),
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(n_procs), "--process-id", str(pid),
            "--out", str(out), "-1", "-b", "1", "-f", "AF",
        ]
        if spill:
            args += ["--spill-dir", str(tmp_path / f"spill{pid}")]
        args += [str(d / "haploid.fa"), str(d / "haploid.vcf")] + reads
        procs.append(subprocess.Popen(
            args, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
        ))
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        errs.append(err.decode(errors="replace"))
        assert p.returncode == 0, errs
    return errs


def _args(d, port, n_procs, pid, out, extra=()):
    return [
        sys.executable, os.path.join(REPO, "tools", "run_distributed.py"),
        "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", str(n_procs), "--process-id", str(pid),
        "--out", str(out), "-1", "-b", "1", "-f", "AF", *extra,
        str(d / "haploid.fa"), str(d / "haploid.vcf"),
    ] + [str(d / f"reads{p}.fq") for p in range(4)]


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.slow
def test_peer_death_aborts_with_one_line_error(split_inputs, tmp_path):
    """Gloo collectives hang forever when a peer dies mid-run; the
    --timeout watchdog converts that into a one-line ERROR exit."""
    import signal
    import time

    d = split_inputs
    port = _free_port()
    out = tmp_path / "dead.vcf"
    p0 = subprocess.Popen(_args(d, port, 2, 0, out, ("--timeout", "25")),
                          env=_env(), stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE)
    p1 = subprocess.Popen(_args(d, port, 2, 1, out, ("--timeout", "25")),
                          env=_env(), stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
    time.sleep(5)
    p1.send_signal(signal.SIGKILL)
    _, err0 = p0.communicate(timeout=120)
    p1.wait(timeout=30)
    assert p0.returncode != 0
    lines = [l for l in err0.decode(errors="replace").splitlines()
             if l.startswith("ERROR:")]
    assert len(lines) == 1 and "exceeded" in lines[0], err0.decode()


@pytest.mark.slow
def test_mismatched_topology_no_hang(split_inputs, tmp_path):
    """Processes launched with inconsistent --num-processes must not hang:
    init fails with a one-line ERROR or the watchdog fires."""
    d = split_inputs
    port = _free_port()
    out = tmp_path / "mismatch.vcf"
    p0 = subprocess.Popen(_args(d, port, 2, 0, out, ("--timeout", "20")),
                          env=_env(), stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE)
    p1 = subprocess.Popen(_args(d, port, 3, 1, out, ("--timeout", "20")),
                          env=_env(), stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE)
    errs = []
    for p in (p0, p1):
        _, err = p.communicate(timeout=120)
        errs.append((p.returncode, err.decode(errors="replace")))
    # at least one side must fail loudly, and any failure is one-line
    assert any(rc != 0 for rc, _ in errs), errs
    for rc, err in errs:
        if rc != 0:
            lines = [l for l in err.splitlines() if l.startswith("ERROR:")]
            assert len(lines) == 1, err


@pytest.mark.slow
def test_rerun_after_mid_run_kill_matches_golden(split_inputs, tmp_path):
    """Kill both processes mid-run, rerun with the SAME spill dirs and
    output path: the rerun must complete and be byte-identical (spill
    manifests resume or restart deterministically)."""
    import signal
    import time

    d = split_inputs
    out = tmp_path / "resume.vcf"
    spills = [("--spill-dir", str(tmp_path / f"rspill{p}")) for p in (0, 1)]
    port = _free_port()
    procs = [
        subprocess.Popen(_args(d, port, 2, p, out, spills[p]), env=_env(),
                         stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for p in (0, 1)
    ]
    time.sleep(6)
    for p in procs:
        p.send_signal(signal.SIGKILL)
    for p in procs:
        p.wait(timeout=30)
    port = _free_port()
    procs = [
        subprocess.Popen(_args(d, port, 2, p, out, spills[p]), env=_env(),
                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for p in (0, 1)
    ]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode(errors="replace")
    golden = open(os.path.join(REF_EXAMPLE, "haploid.malva.vcf")).read()
    assert out.read_text() == golden


@pytest.mark.slow
@pytest.mark.parametrize("n_procs,spill", [(2, False), (2, True), (4, False), (4, True)])
def test_multi_process_pipeline_matches_golden(split_inputs, n_procs, spill,
                                               tmp_path):
    out = tmp_path / f"dist{n_procs}_{int(spill)}.vcf"
    errs = _launch(split_inputs, tmp_path, n_procs, spill, out)
    golden = open(os.path.join(REF_EXAMPLE, "haploid.malva.vcf")).read()
    assert out.read_text() == golden
    # the exchange must take the one-round all_to_all path (not the
    # per-owner allgather fallback), and its traffic is logged
    for err in errs:
        ex = [l for l in err.splitlines() if "exchange" in l]
        assert ex, err
        assert "all_to_all" in ex[0] and "fallback" not in ex[0], ex[0]
        assert "rows sent" in ex[0]
