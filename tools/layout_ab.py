#!/usr/bin/env python3
"""Same-phase A/B of the signal-view decomposition for the offline path.

"hop_phase" (default layout): frame i = concat(rows[i], rows[i+1]) of the
(F+1, hop) view -> every spectrum matmul contracts over K=hop=160, and the
two half-frame products are added. "frame_parity": even-index frames are
one contiguous (F/2, frame_size) reshape and odd-index frames another ->
K=frame_size=320, same FLOPs, no duplicated samples materialized, per-frame
outputs interleaved at the end.

Interleaved A/B/A/B rounds in one process (same device state), plus oracle
NMSE per layout on a 600 s slice through the actual timed program.

Usage: python tools/layout_ab.py [seconds_per_call] [rounds]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv) -> int:
    seconds = float(argv[0]) if argv else 14400.0
    rounds = int(argv[1]) if len(argv) > 1 else 4
    variants = argv[2].split(",") if len(argv) > 2 else [
        "hop_phase", "frame_parity"
    ]

    import jax
    import jax.numpy as jnp

    from bench import _nmse, _oracle_features, synth_signal
    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline
    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    sr = 16000
    sig_np = synth_signal(seconds, sr)
    sig = jax.device_put(jnp.asarray(sig_np))

    pipes = {v: FeaturePipeline(FeatureConfig(view_layout=v)) for v in variants}

    # warm + view-path oracle parity on the first 600 s of the timed block
    view_s = min(600, int(seconds))
    vf = 1 + (view_s * sr - 320) // 160
    want_v = _oracle_features(sig_np[: view_s * sr])
    nmse = {}
    blocks = {}
    for v, pipe in pipes.items():
        block, _ = pipe.process_signal_device(sig, pipe.initial_state())
        jax.block_until_ready(block)
        _ = int(jax.device_get(block.vad[-1]))
        nmse[v] = {
            k: _nmse(np.asarray(jax.device_get(getattr(block, k)[:vf])), want_v[k])
            for k in ("energy", "zcr", "entropy", "mfcc")
        }
        blocks[v] = block

    if len(variants) == 2:
        a, b = (blocks[v] for v in variants)
        flips = int(jax.device_get(jnp.sum(a.vad != b.vad)))
        print(json.dumps({"vad_flips_between_layouts": flips,
                          "frames": int(a.vad.shape[0])}), flush=True)

    reps = 8
    for r in range(rounds):
        for v, pipe in pipes.items():
            state0 = pipe.initial_state()
            tails = []
            t0 = time.perf_counter()
            for _ in range(reps):
                block, _ = pipe.process_signal_device(sig, state0)
                tails.append(block.vad[-1])
            _ = int(jax.device_get(jnp.stack(tails).sum()))
            dt = (time.perf_counter() - t0) / reps
            print(json.dumps({
                "variant": v,
                "round": r,
                "seconds_per_call": seconds,
                "ms_per_call": round(dt * 1e3, 2),
                "audio_x_realtime": round(seconds / dt, 1),
                "nmse_max": float(f"{max(nmse[v].values()):.3e}"),
                "nmse": {k: float(f"{x:.3e}") for k, x in nmse[v].items()},
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
