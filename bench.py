#!/usr/bin/env python3
"""Benchmark: audio-seconds/sec/chip for the full 16 kHz frame→MFCC→VAD
pipeline, plus normalized feature MSE vs the NumPy/SciPy reference formulas.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Baseline target (BASELINE.md): >=1000x real-time per chip at <=1e-5 feature
MSE (normalized per feature: MSE / mean-square of the reference value).

Methodology: a long synthetic speech-like signal is placed in device memory
once (a steady-state streaming engine keeps transfers off the critical path
via double buffering); the timed region is the complete jitted pipeline —
on-device framing, windowed spectrum, mel/DCT matmuls, entropy, adaptive VAD
with trailing history, hangover smoothing — i.e. everything the reference's
per-frame loop does (engine.py:240-311), batched.

Runs only on a GPU: with no GPU it exits non-zero before measuring. The JSON
line names the device (JAX's platform, device kind and count) and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def synth_signal(seconds: float, sr: int = 16000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    sig = rng.normal(0, 40, n)
    # alternating 0.5 s voiced (harmonic) / unvoiced (noise) segments
    seg = ((t * 2).astype(int) % 4)
    voiced = seg == 1
    noise = seg == 2
    sig = np.where(voiced, 6000 * np.sin(2 * np.pi * 130 * t) + 2000 * np.sin(2 * np.pi * 260 * t), sig)
    sig = np.where(noise, rng.normal(0, 2000, n), sig)
    return sig.astype(np.float32)


def main() -> None:
    from sspv_tpu.utils.device import nvidia_smi_identity, require_gpu

    smi = nvidia_smi_identity()
    device = require_gpu()

    import jax
    import jax.numpy as jnp

    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline

    # 16 h of audio per dispatch: the lax.scan keeps compile cost
    # length-independent while the fixed per-call cost (launch, output
    # buffers) amortizes. The one in-flight signal buffer is 3.7 GB.
    seconds = float(os.environ.get("RTP_BENCH_SECONDS", "57600"))
    sr = 16000
    sig_np = synth_signal(seconds, sr)

    pipe = FeaturePipeline(FeatureConfig())
    # Upload the HOST-formed (n+1, hop) rows view (free numpy reshape): the
    # device program then starts in the 2-D layout instead of paying an
    # on-device 1-D->2-D relayout copy.
    rows_np = pipe.host_rows_view(sig_np)
    assert rows_np is not None
    sig = jax.device_put(jnp.asarray(rows_np))
    state0 = pipe.initial_state()

    # warm-up / compile; assert the production-default blocked trailing-sum
    # branch (not the conv fallback) is what this benchmark compiles
    from sspv_tpu.ops import vad as vad_ops

    blocked_before = vad_ops.BLOCKED_TRACE_COUNT
    block, _ = pipe.process_signal_device(sig, state0)
    jax.block_until_ready(block)
    _ = int(jax.device_get(block.vad[-1]))
    vad_impl = (
        "blocked" if vad_ops.BLOCKED_TRACE_COUNT > blocked_before else "conv"
    )
    assert vad_impl == pipe.cfg.vad_trailing_impl == "blocked", vad_impl

    # Steady-state throughput: keep the dispatch pipeline full (async jax
    # dispatch; this is how the streaming engine feeds the device) and
    # force end-to-end completion at the end by consuming a scalar that
    # depends on EVERY rep's output.
    #
    # N rounds of measurement: one sample is not a defensible headline. The
    # rounds interleave with the pitch rounds below (same drift exposure for
    # both metrics); "value" stays the best round, the median is reported
    # beside it.
    rounds, reps = 5, 4

    def measure_features() -> float:
        tails = []
        t0 = time.perf_counter()
        for _ in range(reps):
            block, _ = pipe.process_signal_device(sig, state0)
            tails.append(block.vad[-1])
        _ = int(jax.device_get(jnp.stack(tails).sum()) // reps)
        return (time.perf_counter() - t0) / reps

    # pitch stage (BASELINE.json configs[2]: "autocorrelation pitch-period
    # detection on VAD-gated voiced segments"): the jitted signal-level
    # track — on-device framing + Wiener-Khinchin matmul ACF + banded peak
    # pick — gated on the composite VAD the main pipeline just produced.
    from sspv_tpu.ops.pitch import pitch_track_signal_jit

    # the jitted production callable — the same cached wrapper the serving
    # layer and batch CLI dispatch through (one program per shape)
    pitch_fn = pitch_track_signal_jit()

    # Pitch dispatches the SAME signal as the headline pipeline; it scans
    # over SCAN_BLOCK_FRAMES row blocks to bound its materialized
    # DFT/power/ACF intermediates at ~150 MB.
    pitch_seconds = seconds
    pn = int(pitch_seconds * sr)
    pitch_frames = 1 + (pn - 320) // 160
    # same rows view (pitch_seconds == seconds: the rows cover exactly pn
    # samples); pitch consumes the 2-D layout natively
    assert pn == rows_np.size
    sig_p = sig
    vad_gate = block.vad[:pitch_frames]
    f0, _ = pitch_fn(sig_p, vad_gate, np.float32(0.3))  # compile/warm
    jax.block_until_ready(f0)

    def measure_pitch() -> float:
        tails = []
        t0 = time.perf_counter()
        for _ in range(reps):
            f0, conf = pitch_fn(sig_p, vad_gate, np.float32(0.3))
            tails.append(f0[-1] + conf[-1])
        _ = float(jax.device_get(jnp.stack(tails).sum()))
        return (time.perf_counter() - t0) / reps

    # Interleaved measurement rounds: features/pitch alternate so clock
    # drift lands on both metrics equally.
    feat_times, pitch_times = [], []
    for _ in range(rounds):
        feat_times.append(measure_features())
        pitch_times.append(measure_pitch())

    # Serialized per-dispatch latency: one dispatch, one sync, one scalar
    # fetch.
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        block, _ = pipe.process_signal_device(sig, state0)
        jax.block_until_ready(block)
        _ = int(jax.device_get(block.vad[-1]))
        times.append(time.perf_counter() - t0)
    serialized = min(times)
    t0 = time.perf_counter()
    f0, conf = pitch_fn(sig_p, vad_gate, np.float32(0.3))
    jax.block_until_ready(f0)
    _ = float(jax.device_get(f0[-1]))
    pitch_serialized = time.perf_counter() - t0

    def stats(samples, serial) -> dict:
        s = sorted(samples)
        # true median (average the middle pair when len is even — s[len//2]
        # would skew value_median and the spread normalization upward)
        mid = len(s) // 2
        med = s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])
        best = min(s[0], serial)
        # Two spread figures: the full range, and a stall-robust core spread
        # over the rounds excluding the single worst (with 5 rounds that is
        # the 4-round range). The per-round times are emitted verbatim so
        # either figure can be audited.
        core = s[:-1] if len(s) > 2 else s
        return {
            "best": best,
            "median": med,
            "spread_pct": 100.0 * (s[-1] - s[0]) / med if med else 0.0,
            "core_spread_pct": (
                100.0 * (core[-1] - core[0]) / med if med else 0.0
            ),
            "times_s": [round(x, 5) for x in s],
        }

    fstats = stats(feat_times, serialized)
    pstats = stats(pitch_times, pitch_serialized)
    pipelined = min(feat_times)
    best = fstats["best"]
    audio_sec_per_sec = seconds / best
    pitch_best = pstats["best"]
    pitch_audio_sec_per_sec = pitch_seconds / pitch_best
    voiced_f0 = np.asarray(jax.device_get(f0))
    voiced_f0 = voiced_f0[voiced_f0 > 0]

    # parity: normalized MSE vs the NumPy oracle on a 30 s slice through
    # the frames path (the streaming engine's path)
    check_s = 30
    sub = sig_np[: check_s * sr]
    want = _oracle_features(sub)
    got_block, _ = pipe.process_signal(sub)
    mses = {
        "energy": _nmse(got_block.energy, want["energy"]),
        "zcr": _nmse(got_block.zcr, want["zcr"]),
        "entropy": _nmse(got_block.entropy, want["entropy"]),
        "mfcc": _nmse(got_block.mfcc, want["mfcc"]),
    }

    # view-path parity: the timed headline program is the hop-phase signal
    # view whose matmuls honor cfg.precision — gate IT against the oracle, on the first 600 s of the very block
    # the timing loop produced. Per-frame features are frame-local and the
    # VAD state starts identical, so the long block's prefix equals a
    # standalone 600 s run; 30 s is too short for precision effects to
    # surface (XLA lowers small matmuls differently).
    view_s = 600
    vf = 1 + (view_s * sr - 320) // 160
    want_v = _oracle_features(sig_np[: view_s * sr])
    view_mses = {
        k: _nmse(np.asarray(jax.device_get(getattr(block, k)[:vf])), want_v[k])
        for k in ("energy", "zcr", "entropy", "mfcc")
    }
    max_mse = max(max(mses.values()), max(view_mses.values()))

    # pitch parity on the same slice: banded-ACF NMSE of the on-device
    # matmul (Wiener-Khinchin) form vs the oracle's direct sliding sums
    # (tests/oracle.py:autocorrelation semantics, time_features.py:73-76
    # in the reference), and F0 agreement between the two ACF impls.
    from sspv_tpu.ops.pitch import pitch_from_frames
    from sspv_tpu.ops.time_features import autocorrelation_via_dft

    pframes = _frame_raw(sub)[:2000]
    lag_max = 319
    acf_dft = np.asarray(jax.device_get(autocorrelation_via_dft(pframes, lag_max)))
    acf_ref = _oracle_acf(pframes, lag_max)
    pitch_acf_nmse = _nmse(acf_dft, acf_ref)
    f0_d = np.asarray(jax.device_get(
        pitch_from_frames(pframes, sr, acf_impl="direct")[0]))
    f0_m = np.asarray(jax.device_get(
        pitch_from_frames(pframes, sr, acf_impl="dft")[0]))
    pitch_f0_match = float(np.mean(f0_d == f0_m))

    print(
        json.dumps(
            {
                "metric": "audio_seconds_per_sec_per_chip_frame_mfcc_vad",
                "value": round(audio_sec_per_sec, 1),
                "unit": "audio-s/s/chip",
                "vs_baseline": round(audio_sec_per_sec / 1000.0, 3),
                "realtime_factor": round(audio_sec_per_sec, 1),
                "feature_nmse_max": float(f"{max_mse:.3e}"),
                "feature_nmse": {k: float(f"{v:.3e}") for k, v in mses.items()},
                "feature_nmse_view": {
                    k: float(f"{v:.3e}") for k, v in view_mses.items()
                },
                "matmul_precision": pipe.cfg.precision,
                "frames_per_call": int(np.asarray(block.energy).shape[0]),
                "best_time_s": round(best, 5),
                "pipelined_time_s": round(pipelined, 5),
                "serialized_time_s": round(serialized, 5),
                "value_median": round(seconds / fstats["median"], 1),
                "median_time_s": round(fstats["median"], 5),
                "spread_pct": round(fstats["spread_pct"], 1),
                "core_spread_pct": round(fstats["core_spread_pct"], 1),
                "round_times_s": fstats["times_s"],
                "rounds": rounds,
                "reps_per_round": reps,
                "pitch_audio_sec_per_sec": round(pitch_audio_sec_per_sec, 1),
                "pitch_time_s": round(pitch_best, 5),
                "pitch_median": round(pitch_seconds / pstats["median"], 1),
                "pitch_spread_pct": round(pstats["spread_pct"], 1),
                "pitch_core_spread_pct": round(pstats["core_spread_pct"], 1),
                "pitch_round_times_s": pstats["times_s"],
                "pitch_acf_nmse": float(f"{pitch_acf_nmse:.3e}"),
                "pitch_f0_impl_match": round(pitch_f0_match, 4),
                "pitch_voiced_frames": int(voiced_f0.size),
                "vad_trailing_impl_compiled": vad_impl,
                "device": device,
                "nvidia_smi": smi,
                "xla_flags": os.environ.get("XLA_FLAGS", ""),
            }
        )
    )


def _nmse(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12))


def _frame_raw(sig: np.ndarray, frame: int = 320, hop: int = 160) -> np.ndarray:
    n = 1 + (len(sig) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    return sig[idx].astype(np.float32)


def _oracle_acf(frames: np.ndarray, max_lag: int) -> np.ndarray:
    """Direct sliding-sum ACF (reference time_features.py:73-76 semantics)."""
    x = frames.astype(np.float32)
    cols = [np.sum(x * x, axis=1)]
    for lag in range(1, max_lag + 1):
        cols.append(np.sum(x[:, :-lag] * x[:, lag:], axis=1))
    return np.stack(cols, axis=1)


def _oracle_features(sig: np.ndarray) -> dict:
    """NumPy/SciPy reference-formula features (engine.py per-frame semantics)."""
    from scipy.fftpack import dct as scipy_dct

    frame, hop, sr = 320, 160, 16000
    n = 1 + (len(sig) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    w = (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(frame) / (frame - 1))).astype(np.float32)
    frames = sig[idx].astype(np.float32) * w
    energy = np.sum(frames**2, axis=1)
    signs = np.sign(frames)
    zcr = np.sum(np.abs(np.diff(signs, axis=1)) > 0, axis=1) / frame

    spec = np.abs(np.fft.rfft(frames, n=512)) ** 2
    # mel filterbank (frequency_features.py:47-105 semantics)
    m = lambda f: 2595 * np.log10(1 + np.asarray(f, float) / 700.0)
    inv = lambda v: 700 * (10 ** (v / 2595.0) - 1)
    pts = inv(np.linspace(m(0.0), m(sr / 2), 28))
    bins = np.floor(513 * pts / sr).astype(int)
    fb = np.zeros((26, 257), np.float32)
    for i in range(1, 27):
        lo, c, hi = bins[i - 1], bins[i], bins[i + 1]
        if c == lo:
            c += 1
        if hi == c:
            hi += 1
        fb[i - 1, lo:c] = (np.arange(lo, c) - lo) / (c - lo)
        fb[i - 1, c:hi] = (hi - np.arange(c, hi)) / (hi - c)
    mel = np.maximum(spec @ fb.T, 1e-10)
    mfcc = scipy_dct(np.log(mel), type=2, axis=1, norm="ortho")[:, :13]
    lift = 1.0 + 11.0 * np.sin(np.pi * np.arange(13) / 22.0)
    mfcc = mfcc * lift

    s = spec.sum(axis=1, keepdims=True)
    norm = np.divide(spec, s, out=np.zeros_like(spec), where=s > 0)
    norm = np.maximum(norm, 1e-12)
    entropy = -np.sum(norm * np.log(norm), axis=1) / np.log(257)
    return {"energy": energy, "zcr": zcr, "entropy": entropy, "mfcc": mfcc}


if __name__ == "__main__":
    main()
