#!/usr/bin/env python3
"""The XLA signal-view path — the one offline path on every backend —
against the float64 oracle at the geometries and edge sizes users hit:
odd and tiny frame counts, padded tails, other DFT/mel/cepstrum widths, the
Hanning gate, and the view pitch track against the direct ACF."""

import numpy as np
import pytest

import oracle
from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline
from sspv_tpu.ops.windows import hamming_window


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def _rows(signal, hop=160):
    n = 1 + (len(signal) - 2 * hop) // hop
    return signal[: (n + 1) * hop].astype(np.float32).reshape(n + 1, hop)


def _oracle_frames(sig, n):
    return oracle.framing(sig, 320, 160, hamming_window(320))[:n]


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_view_features_match_oracle(precision):
    rng = np.random.default_rng(7)
    sig = rng.normal(0, 3000, 160 * 801).astype(np.float32)  # 800 frames
    pipe = FeaturePipeline(FeatureConfig(precision=precision))
    out = pipe._features_from_rows(_rows(sig))
    frames = _oracle_frames(sig, 800)
    assert out["energy"].shape == (800,) and out["mfcc"].shape == (800, 13)
    assert _nmse(out["energy"], oracle.short_time_energy(frames)) < 1e-7
    np.testing.assert_allclose(
        np.asarray(out["zcr"]), oracle.zero_crossing_rate(frames), atol=1e-6
    )
    assert _nmse(out["mfcc"], oracle.mfcc(frames, 16000, lifter=22)) < 1e-7
    assert _nmse(out["entropy"], oracle.spectral_entropy(frames, 512)) < 1e-7


@pytest.mark.parametrize("n_frames", [1, 2, 3, 255, 257, 511, 513])
def test_view_signal_edge_frame_counts(n_frames):
    rng = np.random.default_rng(21 + n_frames)
    # a partial trailing frame's worth of samples: dropped, as streaming does
    sig = rng.normal(0, 1000, 160 * (n_frames + 1) + 77).astype(np.float32)
    pipe = FeaturePipeline(FeatureConfig())
    block, state = pipe.process_signal_device(sig)
    assert np.asarray(block.energy).shape == (n_frames,)
    assert int(state.count) == min(n_frames, pipe.cfg.history_len)
    frames = _oracle_frames(sig, n_frames)
    assert np.all(np.isfinite(np.asarray(block.mfcc)))
    assert _nmse(block.mfcc, oracle.mfcc(frames, 16000, lifter=22)) < 1e-7
    ref, _ = pipe.process_signal(sig)  # materialized-frames path
    np.testing.assert_array_equal(np.asarray(block.vad), np.asarray(ref.vad))


@pytest.mark.parametrize("n_fft,n_filt,n_ceps", [
    (320, 26, 13), (1024, 40, 20), (512, 20, 8), (512, 40, 40),
])
def test_view_other_geometries(n_fft, n_filt, n_ceps):
    rng = np.random.default_rng(31)
    sig = rng.normal(0, 2500, 160 * 65).astype(np.float32)  # 64 frames
    pipe = FeaturePipeline(FeatureConfig(
        n_fft=n_fft, entropy_n_fft=n_fft, num_filters=n_filt,
        num_ceps=n_ceps,
    ))
    out = pipe._features_from_rows(_rows(sig))
    frames = _oracle_frames(sig, 64)
    want = oracle.mfcc(frames, 16000, n_fft=n_fft, num_filters=n_filt,
                       num_ceps=n_ceps, lifter=22)
    assert out["mfcc"].shape == (64, n_ceps)
    assert _nmse(out["mfcc"], want) < 1e-7
    assert _nmse(out["entropy"], oracle.spectral_entropy(frames, n_fft)) < 1e-7


def test_hanning_window_skips_the_view_path():
    """hanning has zero endpoints, so sign(x*w) != sign(x) at them and the
    raw-sign ZCR identity of the view path fails: the dispatchers must
    take the materialized-frames path, which still matches the oracle."""
    pipe = FeaturePipeline(FeatureConfig(window_type="hanning"))
    rng = np.random.default_rng(5)
    sig = rng.normal(0, 2000, 160 * 101).astype(np.float32)
    assert pipe.host_rows_view(sig) is None
    block, _ = pipe.process_signal_device(sig)
    frames = oracle.framing(sig, 320, 160, np.asarray(pipe._window))[:100]
    np.testing.assert_allclose(
        np.asarray(block.zcr), oracle.zero_crossing_rate(frames), atol=1e-6
    )
    assert _nmse(block.energy, oracle.short_time_energy(frames)) < 1e-7


@pytest.mark.parametrize("scan_block", [0, 96])
def test_view_pitch_matches_direct_acf(scan_block):
    """The hop-phase matmul-ACF track, unscanned and scan-blocked, against
    the frames path with the direct sliding-sum ACF: identical F0 picks
    away from lag ties, and the 130 Hz tone found."""
    from sspv_tpu.ops.pitch import pitch_from_frames, pitch_track_signal

    sr = 16000
    t = np.arange(3 * sr) / sr
    rng = np.random.default_rng(11)
    sig = np.where(
        ((t * 2).astype(int) % 4) == 1,
        5000 * np.sin(2 * np.pi * 130 * t),
        rng.normal(0, 40, t.size),
    ).astype(np.float32)
    n = 1 + (sig.size - 320) // 160
    f0, _ = pitch_track_signal(sig, np.ones(n, np.int32),
                               min_confidence=float("-inf"),
                               scan_block=scan_block)
    frames = np.stack([sig[i * 160: i * 160 + 320] for i in range(n)])
    f0_direct, _ = pitch_from_frames(frames, sr, acf_impl="direct")
    assert np.mean(np.asarray(f0) == np.asarray(f0_direct)) >= 0.999
    voiced = np.asarray(f0)[((np.arange(n) * 160 / sr * 2).astype(int) % 4) == 1]
    assert abs(np.median(voiced) - 130.0) < 5.0
