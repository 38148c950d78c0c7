#!/usr/bin/env python3
"""Persistent compile-cache placement: ``JAX_COMPILATION_CACHE_DIR`` is used
exactly as given; without it the fixed checkout-local ``.jax_cache`` (with a
per-ISA subdirectory for CPU-backend processes); no entry point passes a path
of its own."""

import ast
import os

import jax
import pytest

from sspv_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def recorded(monkeypatch):
    """Capture jax.config updates instead of applying them, so the test
    never re-points the worker's real compilation cache."""
    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    return calls


def test_env_dir_used_verbatim(monkeypatch, tmp_path, recorded):
    target = str(tmp_path / "x")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    assert cache.enable_persistent_cache() == target
    assert recorded["jax_compilation_cache_dir"] == target
    assert recorded["jax_persistent_cache_min_compile_time_secs"] == 0.0
    assert os.listdir(target) == []  # no per-ISA subdirectory inside it


def test_default_is_checkout_cache(monkeypatch, recorded):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.enable_persistent_cache()
    root = os.path.join(REPO, ".jax_cache")
    assert cache.default_cache_dir() == root
    # the suite runs on the CPU backend: the ISA-scoped subdirectory
    assert got == os.path.join(root, f"cpu-{cache.host_isa_fingerprint()}")
    assert recorded["jax_compilation_cache_dir"] == got


def test_empty_env_falls_back_to_checkout(monkeypatch, recorded):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    got = cache.enable_persistent_cache()
    assert got.startswith(os.path.join(REPO, ".jax_cache"))


def _entry_files():
    out = ["bench.py", "chip_smoke.py", "__graft_entry__.py"]
    for d in ("sspv_tpu", "examples", "tools"):
        for root, _dirs, names in os.walk(os.path.join(REPO, d)):
            out += [os.path.relpath(os.path.join(root, n), REPO)
                    for n in names if n.endswith(".py")]
    return sorted(out)


def _cache_calls(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "id", None) or getattr(fn, "attr", None)
            if name == "enable_persistent_cache":
                yield node


@pytest.mark.parametrize("path", [
    p for p in _entry_files() if any(True for _ in _cache_calls(p))
])
def test_callers_pass_no_cache_path(path):
    for call in _cache_calls(path):
        assert not call.args and not call.keywords, (path, call.lineno)


@pytest.mark.parametrize("entry", [
    "bench.py", "chip_smoke.py", "__graft_entry__.py", "sspv_tpu/serve.py",
    "sspv_tpu/batch.py", "sspv_tpu/warmup.py", "sspv_tpu/analyze.py",
    "sspv_tpu/main.py",
])
def test_entry_points_enable_the_cache(entry):
    assert any(True for _ in _cache_calls(entry)), entry
