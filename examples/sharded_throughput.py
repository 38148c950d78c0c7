#!/usr/bin/env python3
"""Multi-device throughput demonstration.

Processes a batch of signals data-parallel over all visible devices via
``sspv_tpu.parallel.BatchPipeline`` and reports aggregate
audio-seconds/sec. On a multi-GPU host the batch shards over the GPUs; on
a CPU-only box it exercises the same code over a virtual CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/sharded_throughput.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    from sspv_tpu.parallel import BatchPipeline, make_mesh
    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    dp = mesh.devices.shape[0]
    print(f"devices={n_dev} mesh={dict(zip(mesh.axis_names, mesh.devices.shape))}")

    per_signal_s = 60.0
    sr = 16000
    rng = np.random.default_rng(0)
    batch = max(dp, n_dev)
    signals = rng.normal(0, 2000, (batch, int(per_signal_s * sr))).astype(np.float32)

    bp = BatchPipeline(mesh)
    block, states = bp.process_batch(signals)  # compile + run
    jax.block_until_ready(block)

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        block, _ = bp.process_batch(signals)
        jax.block_until_ready(block)
        times.append(time.perf_counter() - t0)
    best = min(times)
    total_audio = batch * per_signal_s
    print(
        f"batch={batch} x {per_signal_s}s audio in {best*1000:.1f}ms -> "
        f"{total_audio/best:.0f}x real-time aggregate "
        f"({total_audio/best/n_dev:.0f}x per device)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
