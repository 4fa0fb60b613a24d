"""Backend routing, the compile-cache helper and chip_smoke.py's refusal
to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from malva_tpu import pipeline
from malva_tpu.utils import compile_cache
from malva_tpu.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_resolve_backend_propagates_jax_failure(monkeypatch):
    """auto must not hide a broken accelerator behind a host run."""
    import jax

    def broken():
        raise RuntimeError("CUDA initialisation failed")

    monkeypatch.setattr(jax, "default_backend", broken)
    with pytest.raises(RuntimeError, match="CUDA initialisation failed"):
        pipeline._resolve_backend(Config(backend="auto"), work=10, floor=1)
    # explicit choices and work below the floor never ask JAX
    assert pipeline._resolve_backend(Config(backend="host")) == "host"
    assert pipeline._resolve_backend(Config(backend="auto"), 0, 1) == "host"


@pytest.mark.parametrize("backend,want", [("auto", "host"), ("host", "host"),
                                          ("device", "device")])
def test_resolve_backend_on_cpu_jax(backend, want):
    """On a JAX whose platform is cpu, auto picks the exact host path."""
    assert pipeline._resolve_backend(Config(backend=backend), 10, 1) == want


def test_compile_cache_respects_env(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.CACHE_ENV, "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """Under JAX_PLATFORMS=cpu, from the repo or copied on its own, the
    smoke script exits non-zero and never prints its success line (a
    stand-in nvidia-smi lets it get as far as asking JAX)."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    smi = tmp_path / "bin" / "nvidia-smi"
    smi.parent.mkdir()
    smi.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    smi.chmod(0o755)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PATH=f"{smi.parent}{os.pathsep}{os.environ.get('PATH', '')}")
    r = subprocess.run([sys.executable, str(script)], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert ("checkout of the repo" if alone else "need 1 GPU") in r.stderr
