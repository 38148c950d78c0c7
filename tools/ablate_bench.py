#!/usr/bin/env python3
"""Stage & precision ablation for the flagship offline path.

Times variants of the signal-view pipeline on the current backend to locate
where device time goes (DFT matmuls vs spectral tail vs VAD prefix ops) and
what matmul precision buys:

    python tools/ablate_bench.py [seconds]      # default 3600

Each variant prints one JSON line: pipelined per-call time over ``reps``
in-flight dispatches (the steady-state methodology of bench.py) plus, for
precision variants, feature NMSE vs the NumPy oracle so speedups can be
weighed against the <=1e-5 parity gate.

One-time cost: every variant is a distinct program to compile; results land
in the persistent cache so re-runs are cheap.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def pipelined_time(dispatch, consume, reps=4):
    dispatch_out = dispatch()
    consume(dispatch_out)  # warm-up / compile
    import jax

    outs = []
    t0 = time.perf_counter()
    for _ in range(reps):
        outs.append(dispatch())
    # force completion of every rep before stopping the clock
    for o in outs:
        consume(o)
    return (time.perf_counter() - t0) / reps


def main(argv):
    seconds = float(argv[0]) if argv else 3600.0
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    from jax import lax

    from sspv_tpu.utils.cache import enable_persistent_cache
    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline

    enable_persistent_cache()

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    sr = 16000
    # THE bench signal (bench.synth_signal) so every tool's rows are
    # measured on the same input — a local copy had silently dropped the
    # 260 Hz second harmonic
    from bench import synth_signal

    sig_np = synth_signal(seconds, sr)
    sig = jax.device_put(jnp.asarray(sig_np))

    def report(name, per_call, extra=None):
        print(
            json.dumps(
                {
                    "variant": name,
                    "time_s": round(per_call, 5),
                    "audio_x_realtime": round(seconds / per_call, 1),
                    **(extra or {}),
                }
            ),
            flush=True,
        )

    def stage_variant(pipe, stage):
        """Scan-structured like the real path, reduced to one scalar out."""
        hop = pipe.cfg.hop_size
        b = pipe.SCAN_BLOCK_FRAMES

        def impl(signal):
            n = 1 + (int(signal.shape[0]) - pipe.cfg.frame_size) // hop
            rows = signal[: (n + 1) * hop].reshape(n + 1, hop)
            nb = -(-n // b)
            pad_rows = nb * b + 1 - (n + 1)
            if pad_rows:
                rows = jnp.pad(rows, ((0, pad_rows), (0, 0)))
            starts = jnp.arange(nb, dtype=jnp.int32) * b
            valid = (jnp.arange(nb * b, dtype=jnp.int32) < n).reshape(nb, b)
            state0 = pipe.initial_state()

            def step(st, inp):
                start, va = inp
                rb = lax.dynamic_slice(rows, (start, 0), (b + 1, hop))
                if stage in ("spectrum", "spectrum_pair"):
                    # "spectrum" = whatever basis layout the pipeline ships
                    # (merged by default since r3); "spectrum_pair" = the two
                    # narrow (hop, n_bins) bases layout it replaced
                    top, bot = rb[:-1], rb[1:]
                    hi = pipe._precision
                    wm, wnyq, wc, ws = pipe._spectrum_bases("mfcc")
                    if stage == "spectrum" and wm is not None:
                        half = wm.shape[1] // 2
                        m = jnp.matmul(top, jnp.asarray(wm[:hop]), precision=hi) + jnp.matmul(
                            bot, jnp.asarray(wm[hop:]), precision=hi)
                        nyq = jnp.matmul(top, jnp.asarray(wnyq[:hop]), precision=hi) + jnp.matmul(
                            bot, jnp.asarray(wnyq[hop:]), precision=hi)
                        return st, (
                            jnp.sum(m[:, :half] * m[:, :half] + m[:, half:] * m[:, half:])
                            + jnp.sum(nyq * nyq)
                        )
                    re = jnp.matmul(top, jnp.asarray(wc[:hop]), precision=hi) + jnp.matmul(
                        bot, jnp.asarray(wc[hop:]), precision=hi)
                    im = jnp.matmul(top, jnp.asarray(ws[:hop]), precision=hi) + jnp.matmul(
                        bot, jnp.asarray(ws[hop:]), precision=hi)
                    return st, jnp.sum(re * re + im * im)
                feats = pipe._features_from_rows(rb)
                if stage == "features":
                    return st, sum(jnp.sum(v) for v in feats.values())
                blk, new_st = pipe._vad_stage(feats, st, va)
                return new_st, jnp.sum(blk.vad)

            _, outs = lax.scan(step, state0, (starts, valid))
            return jnp.sum(outs)

        return jax.jit(impl)

    def run_stage(pipe, stage, name, extra=None):
        fn = stage_variant(pipe, stage)
        per = pipelined_time(
            lambda: fn(sig), lambda o: float(jax.device_get(o)), reps=4
        )
        report(name, per, extra)

    def run_full(pipe, name, extra=None):
        state0 = pipe.initial_state()

        def dispatch():
            block, _ = pipe.process_signal_device(sig, state0)
            return block.vad[-1]

        per = pipelined_time(dispatch, lambda o: int(jax.device_get(o)), reps=4)
        report(name, per, extra)

    def parity(pipe):
        import oracle as _  # noqa: F401  (ensures tests dir import works)
        from bench import _oracle_features, _nmse

        sub = sig_np[: 30 * sr]
        want = _oracle_features(sub)
        # device path = the signal-VIEW path (what run_full times) —
        # process_signal would gate every variant on the frames path instead
        got, _st = pipe.process_signal_device(jnp.asarray(sub, jnp.float32))
        got = jax.device_get(got)
        return {
            "nmse_max": float(
                f"{max(_nmse(got.energy, want['energy']), _nmse(got.zcr, want['zcr']), _nmse(got.entropy, want['entropy']), _nmse(got.mfcc, want['mfcc'])):.3e}"
            )
        }

    base = FeaturePipeline(FeatureConfig())
    # shipped config; named "full_shipped" so it cannot collide with the
    # precision="default" variant below
    run_full(base, "full_shipped")
    run_stage(base, "spectrum", "spectrum_only")
    run_stage(base, "spectrum_pair", "spectrum_pair_only")
    run_stage(base, "features", "features_no_vad")
    run_stage(base, "vad", "features_plus_vad")

    # DFT basis layout A/B: the shipped default is "merged" (one
    # (frame, n_fft) basis + Nyquist matvec, inside full_shipped above);
    # "pair" is the two-(frame, 257)-bases layout it replaced
    pair = FeaturePipeline(FeatureConfig(dft_layout="pair"))
    run_full(pair, "full_dft_pair", parity(pair))

    # precision variants via the FeatureConfig knob: retrace, measure,
    # and report parity headroom
    for prec in ("highest", "default"):
        pipe = FeaturePipeline(FeatureConfig(precision=prec))
        run_full(pipe, f"full_{prec}", parity(pipe))

    # scan-block sensitivity
    for blk in (16384, 65536):
        old_b = FeaturePipeline.SCAN_BLOCK_FRAMES
        FeaturePipeline.SCAN_BLOCK_FRAMES = blk
        try:
            pipe = FeaturePipeline(FeatureConfig())
            run_full(pipe, f"full_scanblock_{blk}")
        finally:
            FeaturePipeline.SCAN_BLOCK_FRAMES = old_b

    print(json.dumps({"backend": jax.default_backend(), "seconds": seconds}))


if __name__ == "__main__":
    main(sys.argv[1:])
