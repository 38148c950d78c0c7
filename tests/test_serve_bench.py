#!/usr/bin/env python3
"""The serving benchmark example must run end-to-end on the CPU backend —
it is the harness for the HTTP-serving numbers."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "serve_bench.py")


def test_serve_bench_cpu():
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, SCRIPT, "--clients", "1,2", "--seconds", "1",
         "--requests", "2", "--fmt", "npz"],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.strip()]
    assert [r["clients"] for r in lines] == [1, 2]
    for r in lines:
        assert r["errors"] == []
        assert r["requests"] == 2 * r["clients"]
        assert r["p50_ms"] and r["p50_ms"] > 0
