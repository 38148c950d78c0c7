#!/usr/bin/env python3
"""Pitch detection: known-frequency tones recover their F0; VAD gating zeros
unvoiced frames; noise yields low confidence."""

import numpy as np

from sspv_tpu.ops.pitch import pitch_from_frames, pitch_track


def tone_frames(freq, n_frames=20, frame_size=320, sr=16000):
    t = np.arange(n_frames * 160 + frame_size) / sr
    sig = np.sin(2 * np.pi * freq * t).astype(np.float32)
    idx = np.arange(frame_size)[None, :] + 160 * np.arange(n_frames)[:, None]
    return sig[idx]


def test_pitch_recovers_tone_frequency():
    for freq in (100.0, 150.0, 220.0, 330.0):
        frames = tone_frames(freq)
        f0, conf = pitch_from_frames(frames, 16000)
        f0 = np.asarray(f0)
        # lag quantization: expected resolution ~ f^2/sr
        tol = freq * freq / 16000 + 1.0
        assert np.all(np.abs(f0 - freq) < tol), (freq, f0[:3])
        # low F0 peaks sit at lag ~ frame_size/2 where the un-normalized ACF
        # overlap is halved, so confidence bottoms out near 0.5
        assert np.all(np.asarray(conf) >= 0.45)


def test_acf_dft_matches_direct():
    """The Wiener-Khinchin matmul ACF must agree with the unrolled direct
    sums (reference semantics) to float32-matmul accuracy on realistic
    amplitudes, across lag counts including non-multiple-of-128 paddings."""
    from sspv_tpu.ops.time_features import (
        autocorrelation_via_dft,
        calculate_short_time_autocorrelation,
    )

    rng = np.random.default_rng(3)
    frames = rng.normal(0, 3000, (64, 320)).astype(np.float32)
    for max_lag in (319, 200, 32):
        direct = np.asarray(calculate_short_time_autocorrelation(frames, max_lag))
        dft = np.asarray(autocorrelation_via_dft(frames, max_lag))
        assert dft.shape == direct.shape == (64, max_lag + 1)
        nmse = np.mean((dft - direct) ** 2) / np.mean(direct**2)
        assert nmse < 1e-9, (max_lag, nmse)


def test_acf_dft_degenerate_shapes():
    from sspv_tpu.ops.time_features import autocorrelation_via_dft

    assert np.asarray(
        autocorrelation_via_dft(np.zeros((0, 320), np.float32), 10)
    ).shape == (0, 11)


def test_pitch_dft_impl_same_track():
    """Both ACF impls must pick the same F0 on clean tones, and the full
    signal-level jitted path must agree with the frames-level path."""
    from sspv_tpu.ops.pitch import pitch_track_signal

    for freq in (100.0, 220.0, 330.0):
        frames = tone_frames(freq)
        f0_d, _ = pitch_from_frames(frames, 16000, acf_impl="direct")
        f0_f, _ = pitch_from_frames(frames, 16000, acf_impl="dft")
        np.testing.assert_allclose(np.asarray(f0_d), np.asarray(f0_f))

    n_frames = 50
    sig = np.sin(
        2 * np.pi * 180.0 * np.arange(n_frames * 160 + 160) / 16000
    ).astype(np.float32)
    vad = np.ones(n_frames, np.int32)
    idx = np.arange(320)[None, :] + 160 * np.arange(n_frames)[:, None]
    f0_sig, conf_sig = pitch_track_signal(sig, vad)
    f0_frames, conf_frames = pitch_track(sig[idx], vad, 16000, acf_impl="dft")
    # the signal path's hop-phase matmuls reassociate float sums vs the
    # frames path at the ~1e-7 level; peaks on a clean tone are identical
    np.testing.assert_allclose(np.asarray(f0_sig), np.asarray(f0_frames))
    np.testing.assert_allclose(
        np.asarray(conf_sig), np.asarray(conf_frames), rtol=1e-5
    )


def test_pitch_vad_gating_and_noise_confidence():
    rng = np.random.default_rng(0)
    voiced = tone_frames(120.0, n_frames=10)
    noise = rng.normal(0, 1.0, (10, 320)).astype(np.float32)
    frames = np.concatenate([voiced, noise])
    vad = np.array([1] * 10 + [0] * 10)
    f0, conf = pitch_track(frames, vad, 16000)
    f0 = np.asarray(f0)
    assert np.all(f0[:10] > 0)
    assert np.all(f0[10:] == 0)
    # tone frames should be far more periodic than noise frames
    assert np.mean(np.asarray(conf)[:10]) > np.mean(np.asarray(conf)[10:])


def test_empty_lag_band_raises_cleanly():
    """fmax too low for the frame length must be a clear ValueError, not an
    argmax-over-empty-slice trace error (or inf garbage from the kernel)."""
    import pytest

    from sspv_tpu.ops.pitch import pitch_from_frames, pitch_track_signal

    frames = np.random.default_rng(0).normal(0, 100, (4, 32)).astype(np.float32)
    with pytest.raises(ValueError, match="empty pitch lag band"):
        pitch_from_frames(frames, 16000)  # 32-sample frames can't reach 50 Hz
    sig = np.random.default_rng(1).normal(0, 100, 16000).astype(np.float32)
    vad = np.ones((99,), np.int32)
    with pytest.raises(ValueError, match="empty pitch lag band"):
        # lag_min = 16000/50 = 320 > lag_max 319
        pitch_track_signal(sig, vad, fmin=30.0, fmax=50.0)


def test_basis_caches_are_mutation_proof():
    from sspv_tpu.ops import bases

    wc, ws = bases.windowed_dft_bases(320, 512, "hamming")
    wc2, _ = bases.windowed_dft_bases(320, 512, "hamming")
    wc[0, 0] += 99.0
    assert wc2[0, 0] != wc[0, 0]
    c, s = bases.dft_bases(320, 512)
    c[0, 0] += 99.0
    c2, _ = bases.dft_bases(320, 512)
    assert c2[0, 0] != c[0, 0]
    m, nyq = bases.merged_windowed_dft_bases(320, 512, "hamming")
    m[0, 0] += 99.0
    m2, _ = bases.merged_windowed_dft_bases(320, 512, "hamming")
    assert m2[0, 0] != m[0, 0]


def test_scan_blocked_track_is_bit_identical():
    """The lax.scan-blocked long-signal pitch path must equal the unscanned
    program bitwise: blocking splits only the frame (row) axis, never the
    matmul contraction axis, so per-frame numerics are untouched — including
    with a block size that does not divide the frame count (padded tail
    frames are sliced off) and through the default-block dispatch."""
    import numpy as np

    from sspv_tpu.ops.pitch import pitch_track_signal

    rng = np.random.default_rng(7)
    sr = 16000
    t = np.arange(6 * sr) / sr
    sig = (
        3000 * np.sin(2 * np.pi * 137 * t) + rng.normal(0, 400, t.size)
    ).astype(np.float32)
    n = 1 + (sig.size - 320) // 160
    vad = (rng.random(n) > 0.3).astype(np.int32)

    f0_u, c_u = pitch_track_signal(sig, vad, scan_block=0)  # unscanned
    for block in (64, 97):  # dividing-ish and odd non-dividing
        f0_s, c_s = pitch_track_signal(sig, vad, scan_block=block)
        np.testing.assert_array_equal(np.asarray(f0_s), np.asarray(f0_u))
        np.testing.assert_array_equal(np.asarray(c_s), np.asarray(c_u))
    # n (599) < SCAN_BLOCK_FRAMES: the default dispatch compiles the direct
    # form, so short/streaming callers keep their existing programs
    f0_d, c_d = pitch_track_signal(sig, vad)
    np.testing.assert_array_equal(np.asarray(f0_d), np.asarray(f0_u))
    np.testing.assert_array_equal(np.asarray(c_d), np.asarray(c_u))


def test_scan_blocked_track_under_vmap(monkeypatch):
    """The batch CLI vmaps pitch_track_signal over a (B, L) corpus batch;
    for big buckets the scanned path now runs UNDER vmap (dynamic_slice and
    lax.scan both batch), and each row must equal its standalone unscanned
    track."""
    import numpy as np
    import jax

    from sspv_tpu.ops import pitch as pitch_mod

    rng = np.random.default_rng(23)
    sr = 16000
    L = int(2.53 * sr)  # odd length: n=251 frames, not a block multiple
    t = np.arange(L) / sr
    batch = np.stack([
        (4000 * np.sin(2 * np.pi * f * t) + rng.normal(0, 300, L))
        for f in (110.0, 180.0, 260.0)
    ]).astype(np.float32)
    n = 1 + (L - 320) // 160
    vads = (rng.random((3, n)) > 0.25).astype(np.int32)

    monkeypatch.setattr(pitch_mod, "SCAN_BLOCK_FRAMES", 64)
    vmapped = jax.jit(jax.vmap(
        lambda s, v: pitch_mod.pitch_track_signal(s, v, 320, 160, sr)
    ))
    f0_b, conf_b = vmapped(batch, vads)

    for row in range(3):
        f0_r, conf_r = pitch_mod.pitch_track_signal(
            batch[row], vads[row], scan_block=0
        )
        np.testing.assert_array_equal(
            np.asarray(f0_b[row]), np.asarray(f0_r)
        )
        np.testing.assert_array_equal(
            np.asarray(conf_b[row]), np.asarray(conf_r)
        )


def test_amdf_pitch_recovers_tone_frequency():
    from sspv_tpu.ops.pitch import pitch_from_frames_amdf

    for freq in (100.0, 150.0, 220.0, 330.0):
        frames = tone_frames(freq)
        f0, conf = pitch_from_frames_amdf(frames, 16000)
        f0 = np.asarray(f0)
        tol = freq * freq / 16000 + 1.0
        assert np.all(np.abs(f0 - freq) < tol), (freq, f0[:3])
        # a clean tone's AMDF valley reaches (near) zero -> deep valley
        assert np.all(np.asarray(conf) >= 0.5), (freq, np.asarray(conf).min())


def test_amdf_agrees_with_acf_on_voiced_frames():
    from sspv_tpu.ops.pitch import pitch_from_frames_amdf

    frames = tone_frames(180.0, n_frames=30)
    acf_f0, _ = pitch_from_frames(frames, 16000)
    amdf_f0, _ = pitch_from_frames_amdf(frames, 16000)
    # independent estimators, same lag grid: at most one lag step apart
    assert np.all(np.abs(np.asarray(acf_f0) - np.asarray(amdf_f0)) < 5.0)


def test_amdf_noise_and_silence_confidence():
    from sspv_tpu.ops.pitch import pitch_from_frames_amdf, pitch_track_amdf

    rng = np.random.default_rng(0)
    noise = rng.normal(0, 1000, (12, 320)).astype(np.float32)
    _, conf_noise = pitch_from_frames_amdf(noise, 16000)
    frames = tone_frames(150.0, n_frames=12)
    _, conf_tone = pitch_from_frames_amdf(frames, 16000)
    assert np.asarray(conf_noise).mean() < np.asarray(conf_tone).mean()
    # all-zero frames: valley depth exactly 0 (no fake confidence)
    zero = np.zeros((3, 320), np.float32)
    _, conf_zero = pitch_from_frames_amdf(zero, 16000)
    np.testing.assert_array_equal(np.asarray(conf_zero), 0.0)
    # VAD gating zeroes unvoiced frames regardless of confidence
    vad = np.array([1, 0] * 6, np.int32)
    f0, _ = pitch_track_amdf(frames, vad, 16000)
    f0 = np.asarray(f0)
    assert np.all(f0[vad == 0] == 0.0) and np.all(f0[vad == 1] > 0.0)


def test_amdf_empty_band_raises():
    import pytest

    from sspv_tpu.ops.pitch import pitch_from_frames_amdf

    with pytest.raises(ValueError):
        pitch_from_frames_amdf(np.zeros((2, 64), np.float32), 16000, 20.0, 40.0)


def test_amdf_lag_start_band_matches_full_slice():
    """calculate_average_magnitude_difference(lag_start=k) must equal the
    sliced full-range op (bit-exact: same per-lag subgraphs, fewer of them),
    so the banded AMDF the pitch tracker traces is the reference AMDF's
    columns."""
    from sspv_tpu.ops.time_features import (
        calculate_average_magnitude_difference as amdf,
    )

    rng = np.random.default_rng(13)
    frames = rng.normal(0, 1.0, (5, 320)).astype(np.float32)
    full = np.asarray(amdf(frames, 320))  # lags 1..320 (reference surface)
    band = np.asarray(amdf(frames, 320, lag_start=40))  # lags 40..320
    assert band.shape == (5, 281)
    np.testing.assert_array_equal(band, full[:, 39:])
    # degenerate: empty band
    assert np.asarray(amdf(frames, 10, lag_start=11)).shape == (5, 0)
