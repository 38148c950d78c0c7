#!/usr/bin/env python3
"""Probe how per-call overhead amortizes with signal length.

If the fixed per-call cost (executable launch, output materialization) is a
large fraction of the pipelined call time, longer signals raise
audio-seconds/sec further. Times the flagship ``process_signal_device``
at several signal lengths with the same pipelined methodology as bench.py:

    python tools/length_probe.py 3600 7200 14400

One JSON line per length. Each new length is one extra compile (the scan
body is shared, so compiles are not pathological), kept in the persistent
cache.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def main(argv):
    lengths = [float(a) for a in argv] or [3600.0, 7200.0]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp

    from bench import synth_signal
    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline
    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    pipe = FeaturePipeline(FeatureConfig())
    state0 = pipe.initial_state()

    for seconds in lengths:
        # shipped dispatch form (bench.py since r4): the host-formed
        # (n+1, hop) rows view uploads in the tiled 2-D layout
        sig_np = synth_signal(seconds)
        rows = pipe.host_rows_view(sig_np)
        sig = jax.device_put(jnp.asarray(rows if rows is not None else sig_np))
        del sig_np
        t0 = time.perf_counter()
        block, _ = pipe.process_signal_device(sig, state0)
        jax.block_until_ready(block)
        _ = int(jax.device_get(block.vad[-1]))
        compile_s = time.perf_counter() - t0

        reps = 8
        tails = []
        t0 = time.perf_counter()
        for _ in range(reps):
            block, _ = pipe.process_signal_device(sig, state0)
            tails.append(block.vad[-1])
        _ = int(jax.device_get(jnp.stack(tails).sum()))
        pipelined = (time.perf_counter() - t0) / reps
        print(
            json.dumps(
                {
                    "seconds": seconds,
                    "pipelined_time_s": round(pipelined, 5),
                    "audio_x_realtime": round(seconds / pipelined, 1),
                    "first_call_s": round(compile_s, 2),
                    "backend": jax.default_backend(),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main(sys.argv[1:])
