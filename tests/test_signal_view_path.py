#!/usr/bin/env python3
"""The frame-free signal-view offline path (hop-phase matmuls) must match the
frames-based path and the sequential oracle bit-for-bit on VAD and to float
tolerance on features."""

import numpy as np
import jax.numpy as jnp

from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline

import oracle


def nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def make_sig(n=16000 * 2, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    sig = rng.normal(0, 50, n)
    sig[4000:9000] += np.sin(2 * np.pi * 140 * t[4000:9000]) * 7000
    sig[9000:14000] += rng.normal(0, 2500, 5000)
    return sig.astype(np.float32)


def test_view_path_matches_frames_path():
    sig = make_sig()
    pipe = FeaturePipeline(FeatureConfig())
    # view path (default geometry, hamming)
    got, got_state = pipe.process_signal_device(sig)
    # frames path, same features/VAD via explicit frames
    frames = pipe.stream_frames(sig)
    want, want_state = pipe.process_block(frames, pipe.initial_state())

    np.testing.assert_array_equal(np.asarray(got.vad), np.asarray(want.vad))
    np.testing.assert_array_equal(
        np.asarray(got.vad_adaptive), np.asarray(want.vad_adaptive)
    )
    # integer crossing counts must agree exactly
    np.testing.assert_allclose(
        np.asarray(got.zcr) * 320, np.asarray(want.zcr) * 320, atol=1e-3
    )
    assert nmse(got.energy, want.energy) < 1e-10
    assert nmse(got.mfcc, want.mfcc) < 1e-9
    assert nmse(got.entropy, want.entropy) < 1e-10
    assert int(got_state.last_voiced) == int(want_state.last_voiced)
    assert int(got_state.count) == int(want_state.count)


def test_view_path_scan_blocks_match(monkeypatch):
    sig = make_sig(seed=5)
    pipe_scan = FeaturePipeline(FeatureConfig())
    monkeypatch.setattr(pipe_scan, "SCAN_BLOCK_FRAMES", 48)
    got, _ = pipe_scan.process_signal_device(sig)

    pipe_one = FeaturePipeline(FeatureConfig())
    want, _ = pipe_one.process_signal_device(sig)
    np.testing.assert_array_equal(np.asarray(got.vad), np.asarray(want.vad))
    assert nmse(got.energy, want.energy) < 1e-12
    assert nmse(got.mfcc, want.mfcc) < 1e-9


def test_view_path_matches_oracle_vad():
    sig = make_sig(seed=9)
    pipe = FeaturePipeline(FeatureConfig())
    got, _ = pipe.process_signal_device(sig)

    w = oracle.hamming(320)
    frames = (pipe.stream_frames(sig) * w).astype(np.float32)
    e = oracle.short_time_energy(frames)
    z = oracle.zero_crossing_rate(frames)
    h = oracle.spectral_entropy(frames, 512)
    ref = oracle.EngineVadOracle()
    want_vad, want_adp = ref.run_all(e, z, h)
    np.testing.assert_array_equal(np.asarray(got.vad), want_vad)
    np.testing.assert_array_equal(np.asarray(got.vad_adaptive), want_adp)
    # exact integer crossings vs oracle
    np.testing.assert_allclose(np.asarray(got.zcr), z, atol=1e-6)
    assert nmse(got.mfcc, oracle.mfcc(frames, 16000, lifter=22)) < 1e-5


def test_zero_endpoint_window_falls_back():
    # hanning has zero endpoints -> sign trick invalid -> frames path
    cfg = FeatureConfig(window_type="hanning")
    pipe = FeaturePipeline(cfg)
    assert not pipe._window_strictly_positive()
    sig = make_sig(seed=11)
    got, _ = pipe.process_signal_device(sig)
    frames = pipe.stream_frames(sig)
    want, _ = pipe.process_block(frames, pipe.initial_state())
    np.testing.assert_array_equal(np.asarray(got.vad), np.asarray(want.vad))


def test_non_dividing_geometry_falls_back():
    # frame_size != 2*hop (even though hop divides frame) must use the frames
    # path with correct frame composition
    for frame, hop in [(320, 80), (320, 100), (300, 150)]:
        if frame == 2 * hop:
            continue
        cfg = FeatureConfig(frame_size=frame, hop_size=hop)
        pipe = FeaturePipeline(cfg)
        sig = make_sig(seed=13)[:8000]
        got, _ = pipe.process_signal_device(sig)
        frames = pipe.stream_frames(sig)
        want, _ = pipe.process_block(frames, pipe.initial_state())
        np.testing.assert_array_equal(
            np.asarray(got.vad), np.asarray(want.vad), err_msg=f"{frame}/{hop}"
        )
        np.testing.assert_allclose(
            np.asarray(got.energy), np.asarray(want.energy), rtol=1e-6
        )


def test_frame_parity_layout_matches_frames_path():
    """The frame-parity view layout reuses the frames-path math per parity,
    so energy/zcr (elementwise) and both VAD streams must match the frames
    path EXACTLY; entropy/mfcc may reassociate at the matmul-tiling level
    (batch-size-dependent reduction order), bounded well inside the oracle
    gate. Covers odd and even frame counts and the single-block path."""
    rng = np.random.default_rng(21)
    for n in (320, 480, 481, 999, 16001, 40321):
        sig = (
            rng.normal(0, 1000, n) + 5000 * np.sin(np.arange(n) * 0.05)
        ).astype(np.float32)
        pp = FeaturePipeline(
            FeatureConfig(view_layout="frame_parity")
        )
        hp = FeaturePipeline(FeatureConfig())
        got, gst = pp.process_signal_device(sig, pp.initial_state())
        frames = hp.stream_frames(sig)
        want, wst = hp.process_block(frames, hp.initial_state())
        np.testing.assert_array_equal(np.asarray(got.energy), np.asarray(want.energy))
        np.testing.assert_array_equal(np.asarray(got.zcr), np.asarray(want.zcr))
        np.testing.assert_array_equal(np.asarray(got.vad), np.asarray(want.vad))
        np.testing.assert_array_equal(
            np.asarray(got.vad_adaptive), np.asarray(want.vad_adaptive)
        )
        assert nmse(got.entropy, want.entropy) < 1e-10
        assert nmse(got.mfcc, want.mfcc) < 1e-9
        assert int(gst.last_voiced) == int(wst.last_voiced)
        assert int(gst.count) == int(wst.count)


def test_frame_parity_layout_scan_blocks(monkeypatch):
    """Parity layout under the lax.scan long path: block-local parity is a
    valid partition, so scanned output must match the single-block program."""
    sig = make_sig(seed=23)
    pipe_scan = FeaturePipeline(
        FeatureConfig(view_layout="frame_parity")
    )
    monkeypatch.setattr(pipe_scan, "SCAN_BLOCK_FRAMES", 48)
    got, _ = pipe_scan.process_signal_device(sig)
    pipe_one = FeaturePipeline(
        FeatureConfig(view_layout="frame_parity")
    )
    want, _ = pipe_one.process_signal_device(sig)
    np.testing.assert_array_equal(np.asarray(got.vad), np.asarray(want.vad))
    assert nmse(got.energy, want.energy) < 1e-12
    assert nmse(got.mfcc, want.mfcc) < 1e-9


def test_frame_parity_layout_matches_oracle_vad():
    sig = make_sig(seed=25)
    pipe = FeaturePipeline(FeatureConfig(view_layout="frame_parity"))
    got, _ = pipe.process_signal_device(sig)
    w = oracle.hamming(320)
    frames = (pipe.stream_frames(sig) * w).astype(np.float32)
    e = oracle.short_time_energy(frames)
    z = oracle.zero_crossing_rate(frames)
    h = oracle.spectral_entropy(frames, 512)
    ref = oracle.EngineVadOracle()
    want_vad, want_adp = ref.run_all(e, z, h)
    np.testing.assert_array_equal(np.asarray(got.vad), want_vad)
    np.testing.assert_array_equal(np.asarray(got.vad_adaptive), want_adp)
    np.testing.assert_allclose(np.asarray(got.zcr), z, atol=1e-6)
    assert nmse(got.mfcc, oracle.mfcc(frames, 16000, lifter=22)) < 1e-5
