#!/usr/bin/env python3
"""Micro-benchmark of the streaming-VAD building blocks on the current backend.

The VAD stage does trivial FLOPs, so its cost is op count / lowering, not
arithmetic. The suspects, timed here in isolation at the real block shape
(SCAN_BLOCK_FRAMES = 32768 frames, history 256):

  conv          jnp.convolve(ext, ones(256), "valid")   (fallback impl)
  reduce_window lax.reduce_window add over a 256 window
  blocked       two-level block-cumsum sliding sum (12 fused elementwise ops)
  matmul        im2col windows @ ones vector (MXU)
  cummax        the hangover associative_scan(max)
  vad_full      the complete streaming_vad stage as shipped

Each prints one JSON line with pipelined per-call time over 32 in-flight
dispatches (small programs; methodology of bench.py).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def timeit(fn, args, reps=32):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)  # compile
    outs = []
    t0 = time.perf_counter()
    for _ in range(reps):
        outs.append(fn(*args))
    for o in outs:
        jax.block_until_ready(o)
    # force real completion (remote backends can ack early)
    leaves = jax.tree_util.tree_leaves(outs[-1])
    float(np.asarray(jax.device_get(leaves[0])).ravel()[0])
    return (time.perf_counter() - t0) / reps


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    from jax import lax

    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    F, H = 32768, 256
    rng = np.random.default_rng(0)
    ext_np = np.abs(rng.normal(1e8, 5e9, (H + F,))).astype(np.float32)
    ext = jax.device_put(jnp.asarray(ext_np))
    vadi = jax.device_put(jnp.asarray(rng.integers(0, 2, (F,)).astype(bool)))

    def report(name, t, extra=None):
        print(json.dumps({"variant": name, "time_us": round(t * 1e6, 1),
                          **(extra or {})}), flush=True)

    @jax.jit
    def conv(x):
        return jnp.convolve(x, jnp.ones((H,), jnp.float32), mode="valid")[:F]

    @jax.jit
    def reduce_window(x):
        return lax.reduce_window(
            x, np.float32(0), lax.add, (H,), (1,), "valid"
        )[:F]

    from sspv_tpu.ops import vad as vad_ops

    @jax.jit
    def blocked(x):
        # the shipped implementation (direct two-level cumsums), so recorded
        # numbers always describe the code that ships
        return vad_ops._blocked_trailing_sums(x, F, H)

    @jax.jit
    def matmul(x):
        idx = jnp.arange(F)[:, None] + jnp.arange(H)[None, :]
        win = x[idx]
        return win @ jnp.ones((H,), jnp.float32)

    @jax.jit
    def cummax(v):
        idx = jnp.arange(F, dtype=jnp.int32)
        seeds = jnp.where(v, idx, jnp.int32(-(2**30)))
        return lax.associative_scan(jnp.maximum, seeds)

    ref = np.asarray(jax.device_get(conv(ext)))
    for name, fn, args in [
        ("conv", conv, (ext,)),
        ("reduce_window", reduce_window, (ext,)),
        ("blocked", blocked, (ext,)),
        ("matmul", matmul, (ext,)),
        ("cummax", cummax, (vadi,)),
    ]:
        t = timeit(fn, args)
        extra = None
        if name in ("reduce_window", "blocked", "matmul"):
            got = np.asarray(jax.device_get(fn(*args)))
            rel = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)))
            extra = {"max_rel_vs_conv": float(f"{rel:.3e}")}
        report(name, t, extra)

    # the full shipped VAD stage at block shape

    e = jax.device_put(jnp.asarray(np.abs(rng.normal(1e8, 5e9, (F,))).astype(np.float32)))
    z = jax.device_put(jnp.asarray(rng.uniform(0, 0.5, (F,)).astype(np.float32)))
    h = jax.device_put(jnp.asarray(rng.uniform(0, 1, (F,)).astype(np.float32)))
    st = jax.tree_util.tree_map(jax.device_put, vad_ops.initial_vad_state())

    def make_vad_full(impl):
        @jax.jit
        def vad_full(e, z, h, st):
            return vad_ops.streaming_vad(
                e, z, h, st,
                energy_threshold=1e9, zcr_threshold=0.3,
                entropy_voice_max=0.6,
                use_adaptive=True, adaptive_alpha=0.8,
                trailing_impl=impl,
            )
        return vad_full

    # "blocked" is what the shipped pipeline passes (FeatureConfig default);
    # streaming_vad's own default is the conv fallback, so spell both out
    report("vad_full_blocked", timeit(make_vad_full("blocked"), (e, z, h, st)))
    report("vad_full_conv", timeit(make_vad_full("conv"), (e, z, h, st)))
    print(json.dumps({"backend": jax.default_backend(), "F": F, "H": H}))


if __name__ == "__main__":
    main()
