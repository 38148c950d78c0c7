#!/usr/bin/env python3
"""Import hygiene: ``import sspv_tpu`` must not initialize a JAX backend.

A module-level ``jnp`` constant forces device/backend initialization at
import time, which makes the whole package unimportable when the device is
unavailable or held by another process, and makes every tool that only
parses arguments pay the device start-up. Importing must stay a pure-host
operation.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_does_not_initialize_backend():
    # A fresh subprocess with a clean PYTHONPATH (so nothing pre-imports jax)
    # is the only reliable probe.
    code = (
        f"import sys; sys.path.insert(0, {REPO!r})\n"
        "import sspv_tpu\n"
        "import sspv_tpu.ops, sspv_tpu.runtime, sspv_tpu.parallel\n"
        "import jax._src.xla_bridge as xb\n"
        "assert not xb._backends, f'backends initialized: {list(xb._backends)}'\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        cwd=REPO,
        env={"PYTHONPATH": "", "JAX_PLATFORMS": "cpu",
             "PATH": os.environ.get("PATH", "")},
    )
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
