#!/usr/bin/env python3
"""Which accelerator a measurement ran on.

Measurement entry points (``bench.py``, ``chip_smoke.py``) call
:func:`require_gpu` before their first device computation: a run that finds
no GPU fails instead of quietly timing the CPU backend, and every result
they print names the device it came from.
"""

from __future__ import annotations

import subprocess

__all__ = ["nvidia_smi_identity", "require_gpu"]

_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def nvidia_smi_identity() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (one
    line per card), or a short reason when ``nvidia-smi`` cannot be run.
    Runs in a child process, so it touches no JAX state."""
    try:
        out = subprocess.run(
            _SMI_QUERY, capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    if out.returncode != 0:
        return f"nvidia-smi failed (rc={out.returncode}): {out.stderr.strip()}"
    return out.stdout.strip()


def require_gpu() -> dict:
    """Return ``{"platform", "kind", "count"}`` for JAX's devices; raise
    ``SystemExit`` with a clear message when the first device is not a GPU."""
    import jax

    devices = jax.devices()
    d0 = devices[0]
    if d0.platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's first device is {d0.platform!r} "
            f"({d0.device_kind}); this measurement runs only on a GPU"
        )
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devices)}
