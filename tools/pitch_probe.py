#!/usr/bin/env python3
"""Probe pitch-track throughput vs dispatch length.

The scan-blocked hop-phase pitch path (ops/pitch.py) removed the memory cap
that pinned the pitch benchmark at 3600 s/call; this probe measures how the
fixed per-call cost (launch, outputs) amortizes as the dispatch length
grows, with the same pipelined methodology as bench.py:

    python tools/pitch_probe.py 3600 14400

One JSON line per length. The VAD gate is all-ones: gating is a final
elementwise ``where`` over outputs, so the timed compute is identical to a
real gate while keeping the probe independent of the feature pipeline.
Each new length is one compile, kept in the persistent cache (the scan body
is shared across lengths).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def main(argv):
    lengths = [float(a) for a in argv] or [3600.0, 14400.0]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp

    from bench import synth_signal
    from sspv_tpu.ops.pitch import SCAN_BLOCK_FRAMES, pitch_track_signal_jit
    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    sr = 16000
    pitch_fn = pitch_track_signal_jit()

    for seconds in lengths:
        sig = jax.device_put(jnp.asarray(synth_signal(seconds)))
        n = 1 + (int(seconds * sr) - 320) // 160
        vad = jnp.ones((n,), jnp.int32)

        t0 = time.perf_counter()
        f0, conf = pitch_fn(sig, vad, np.float32(0.3))
        jax.block_until_ready(f0)
        _ = float(jax.device_get(f0[-1]))
        compile_s = time.perf_counter() - t0

        reps = 8
        tails = []
        t0 = time.perf_counter()
        for _ in range(reps):
            f0, conf = pitch_fn(sig, vad, np.float32(0.3))
            tails.append(f0[-1] + conf[-1])
        _ = float(jax.device_get(jnp.stack(tails).sum()))
        pipelined = (time.perf_counter() - t0) / reps

        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            f0, conf = pitch_fn(sig, vad, np.float32(0.3))
            jax.block_until_ready(f0)
            _ = float(jax.device_get(f0[-1]))
            times.append(time.perf_counter() - t0)
        serialized = min(times)

        best = min(pipelined, serialized)
        print(json.dumps({
            "seconds_per_call": seconds,
            "frames": n,
            "scanned": n > SCAN_BLOCK_FRAMES,
            "pipelined_time_s": round(pipelined, 5),
            "serialized_time_s": round(serialized, 5),
            "audio_s_per_s": round(seconds / best, 1),
            "first_call_s": round(compile_s, 2),
            "backend": jax.default_backend(),
        }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
