#!/usr/bin/env python3
"""Golden-value parity of the JAX ops against the NumPy/SciPy oracle.

Gate: normalized MSE (MSE / mean-square of the oracle value, with an absolute
floor for near-zero features) <= 1e-5, per BASELINE.md.
"""

import numpy as np
import pytest

from sspv_tpu import ops
from sspv_tpu.ops import bases

import oracle


def nmse(got, want, floor=1e-12):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    denom = max(np.mean(want**2), floor)
    return np.mean((got - want) ** 2) / denom


@pytest.fixture(scope="module")
def speech_like():
    rng = np.random.default_rng(42)
    sr = 16000
    t = np.arange(sr * 2) / sr
    sig = np.zeros_like(t, dtype=np.float64)
    sig += np.where((t >= 0.5) & (t < 1.0), np.sin(2 * np.pi * 120 * t) * 8000, 0)
    sig += np.where((t >= 1.0) & (t < 1.5), rng.normal(0, 2500, t.shape), 0)
    sig += rng.normal(0, 20, t.shape)  # noise floor everywhere
    return sig.astype(np.float32)


@pytest.fixture(scope="module")
def frames(speech_like):
    w = oracle.hamming(320)
    return oracle.framing(speech_like, 320, 160, w)


def test_window_parity():
    w = ops.hamming_window(320)
    assert nmse(w, oracle.hamming(320)) < 1e-10
    assert w.dtype == np.float32


def test_preemphasis_parity(speech_like):
    got = np.asarray(ops.preemphasis(speech_like, 0.97))
    want = oracle.preemphasis(speech_like, 0.97)
    assert nmse(got, want) < 1e-10


def test_framing_parity(speech_like):
    got = np.asarray(ops.framing(speech_like, 320, 160, "hamming"))
    want = oracle.framing(speech_like, 320, 160, oracle.hamming(320))
    assert got.shape == want.shape
    assert nmse(got, want) < 1e-10


def test_framing_counts():
    # frame-count formula incl. degenerate cases (preprocessing.py:71-76)
    for length in [1, 100, 319, 320, 321, 480, 481, 1000, 16000]:
        sig = np.random.randn(length).astype(np.float32)
        got = np.asarray(ops.framing(sig, 320, 160))
        want = oracle.framing(sig, 320, 160, oracle.hamming(320))
        assert got.shape == want.shape, length
        if want.size:
            assert nmse(got, want) < 1e-10
    assert np.asarray(ops.framing(np.zeros(0, np.float32), 320, 160)).shape == (0, 320)


def test_framing_nondivisible_hop(speech_like):
    # hop that does not divide frame_size exercises the gather path
    got = np.asarray(ops.framing(speech_like[:5000], 400, 147, "hanning"))
    sig = speech_like[:5000]
    n = np.arange(400)
    w = (0.5 * (1 - np.cos(2 * np.pi * n / 399))).astype(np.float32)
    want = oracle.framing(sig, 400, 147, w)
    assert got.shape == want.shape
    assert nmse(got, want) < 1e-10


def test_energy_zcr_parity(frames):
    assert nmse(ops.calculate_short_time_energy(frames), oracle.short_time_energy(frames)) < 1e-10
    got_z = np.asarray(ops.calculate_zero_crossing_rate(frames))
    want_z = oracle.zero_crossing_rate(frames)
    # sign-change counting is exact integer arithmetic — counts must match
    # exactly; the final /frame_size may differ by 1 ulp (XLA lowers division
    # by a constant to a reciprocal multiply).
    np.testing.assert_array_equal(
        np.round(got_z * frames.shape[1]), np.round(want_z * frames.shape[1])
    )
    np.testing.assert_allclose(got_z, want_z, atol=1e-6)


def test_autocorrelation_parity(frames):
    sub = frames[:50]
    got = np.asarray(ops.calculate_short_time_autocorrelation(sub, 100))
    want = oracle.autocorrelation(sub, 100)
    assert got.shape == (50, 101)
    assert nmse(got, want) < 1e-8


def test_autocorrelation_dft_parity(frames):
    """The matmul ACF (Wiener-Khinchin) against the same NumPy oracle as
    the direct form — the fast path must satisfy the identical parity gate."""
    from sspv_tpu.ops.time_features import autocorrelation_via_dft

    sub = frames[:50]
    for max_lag in (100, 319):
        got = np.asarray(autocorrelation_via_dft(sub, max_lag))
        want = oracle.autocorrelation(sub, max_lag)
        assert got.shape == (50, max_lag + 1)
        assert nmse(got, want) < 1e-8


def test_amdf_parity(frames):
    sub = frames[:50]
    got = np.asarray(ops.calculate_average_magnitude_difference(sub, 80))
    want = oracle.amdf(sub, 80)
    assert got.shape == (50, 80)
    assert nmse(got, want) < 1e-8


def test_mel_filterbank_parity():
    got = bases.mel_filterbank_np(26, 512, 16000)
    want = oracle.mel_filterbank(26, 512, 16000)
    assert got.shape == (26, 257)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # custom fmin/fmax and a deliberately degenerate low-resolution case
    got2 = bases.mel_filterbank_np(40, 256, 8000, fmin=50.0, fmax=3800.0)
    want2 = oracle.mel_filterbank(40, 256, 8000, fmin=50.0, fmax=3800.0)
    np.testing.assert_allclose(got2, want2, atol=1e-6)


def test_dct_matrix_matches_scipy():
    from scipy.fftpack import dct as scipy_dct

    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 26)).astype(np.float64)
    want = scipy_dct(x, type=2, axis=1, norm="ortho")[:, :13]
    got = x @ bases.dct_ortho_matrix(26, 13).astype(np.float64)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_mfcc_parity(frames):
    got = np.asarray(ops.compute_mfcc(frames, 16000, n_fft=512, num_filters=26, num_ceps=13))
    want = oracle.mfcc(frames, 16000)
    assert got.shape == want.shape
    assert nmse(got, want) < 1e-5


def test_spectral_entropy_parity(frames):
    got = np.asarray(ops.calculate_spectral_entropy(frames, 512))
    want = oracle.spectral_entropy(frames, 512)
    assert nmse(got, want) < 1e-6


def test_fixed_vad_parity(frames):
    e = oracle.short_time_energy(frames)
    z = oracle.zero_crossing_rate(frames)
    got = np.asarray(ops.voice_activity_detection(e, z, 1000.0, 0.3))
    want = oracle.fixed_vad(e, z, 1000.0, 0.3)
    np.testing.assert_array_equal(got, want)


def test_adaptive_vad_parity(frames):
    rng = np.random.default_rng(1)
    e = oracle.short_time_energy(frames)
    z = oracle.zero_crossing_rate(frames)
    e_hist = rng.uniform(10, 1e6, 100).astype(np.float32)
    z_hist = rng.uniform(0.0, 0.4, 100).astype(np.float32)
    for alpha in [0.0, 0.5, 0.8, 3.0]:
        got = np.asarray(
            ops.adaptive_voice_activity_detection(e, z, e_hist, z_hist, alpha=alpha)
        )
        want = oracle.adaptive_vad(e, z, e_hist, z_hist, alpha=alpha)
        np.testing.assert_array_equal(got, want)
    # empty history falls back to the current batch mean
    got = np.asarray(
        ops.adaptive_voice_activity_detection(
            e, z, np.zeros((0,), np.float32), np.zeros((0,), np.float32)
        )
    )
    want = oracle.adaptive_vad(e, z, [], [])
    np.testing.assert_array_equal(got, want)


def test_pipeline_features_parity(speech_like):
    from sspv_tpu.ops.pipeline import FeaturePipeline, FeatureConfig

    pipe = FeaturePipeline(FeatureConfig())
    raw = oracle.framing(speech_like, 320, 160, np.ones(320, np.float32))
    windowed = (raw * oracle.hamming(320)).astype(np.float32)
    feats = pipe.features(raw)
    assert nmse(feats["energy"], oracle.short_time_energy(windowed)) < 1e-6
    np.testing.assert_allclose(
        np.asarray(feats["zcr"]), oracle.zero_crossing_rate(windowed), atol=1e-6
    )
    assert nmse(feats["mfcc"], oracle.mfcc(windowed, 16000, lifter=22)) < 1e-5
    assert nmse(feats["entropy"], oracle.spectral_entropy(windowed, 512)) < 1e-6


def test_dft_layout_merged_vs_pair(speech_like):
    """The merged DFT basis (bases.merged_windowed_dft_bases) and
    the pair layout compute the same per-bin dot products; compiled
    reductions may reassociate, so agreement is pinned tightly but not
    bitwise. Both layouts must independently clear the oracle gates."""
    from sspv_tpu.ops.pipeline import FeaturePipeline, FeatureConfig

    raw = oracle.framing(speech_like, 320, 160, np.ones(320, np.float32))
    windowed = (raw * oracle.hamming(320)).astype(np.float32)
    pm = FeaturePipeline(FeatureConfig(dft_layout="merged"))
    pp = FeaturePipeline(FeatureConfig(dft_layout="pair"))
    assert pm._wm is not None and pp._wm is None
    fa, fb = pm.features(raw), pp.features(raw)
    for key in ("energy", "zcr", "entropy", "mfcc"):
        a, b = np.asarray(fa[key]), np.asarray(fb[key])
        assert nmse(a, b) < 1e-12, key
    for feats in (fa, fb):
        assert nmse(feats["mfcc"], oracle.mfcc(windowed, 16000, lifter=22)) < 1e-5
        assert nmse(feats["entropy"], oracle.spectral_entropy(windowed, 512)) < 1e-6

    # signal-view (hop-phase) path: whole-signal offline results agree too,
    # including the VAD decisions on this corpus
    ra, _ = pm.process_signal(speech_like)
    rb, _ = pp.process_signal(speech_like)
    assert nmse(np.asarray(ra.mfcc), np.asarray(rb.mfcc)) < 1e-12
    assert nmse(np.asarray(ra.entropy), np.asarray(rb.entropy)) < 1e-12
    np.testing.assert_array_equal(np.asarray(ra.vad), np.asarray(rb.vad))


def test_dft_layout_merged_nyquist_and_dc_columns():
    """The peeled Nyquist column equals the +/-1-alternating window row-wise,
    and the merged basis's im half starts with the all-zero DC sin column."""
    from sspv_tpu.ops import bases
    from sspv_tpu.ops.windows import get_window

    merged, nyq = bases.merged_windowed_dft_bases(320, 512, "hamming")
    assert merged.shape == (320, 512) and nyq.shape == (320,)
    w = get_window("hamming", 320).astype(np.float64)
    signs = np.cos(-np.pi * np.arange(320))  # cos(-pi*n) = (-1)^n
    np.testing.assert_allclose(nyq, (w * signs).astype(np.float32), atol=0)
    np.testing.assert_array_equal(merged[:, 256], np.zeros(320, np.float32))


def test_dft_layout_odd_nfft_falls_back_to_pair():
    from sspv_tpu.ops.pipeline import FeaturePipeline, FeatureConfig

    pipe = FeaturePipeline(
        FeatureConfig(dft_layout="merged", n_fft=511, entropy_n_fft=511)
    )
    assert pipe._wm is None  # pair bases serve odd n_fft
    rng = np.random.default_rng(3)
    raw = rng.standard_normal((16, 320)).astype(np.float32) * 1000
    feats = pipe.features(raw)
    assert np.asarray(feats["mfcc"]).shape == (16, 13)


@pytest.mark.parametrize(
    "frame_size,n_fft,ent_n_fft",
    [
        (320, 256, 256),    # n_fft < frame_size (basis truncates input)
        (320, 512, 1024),   # distinct even entropy spectrum
        (320, 512, 511),    # merged mfcc basis + pair entropy fallback
        (256, 1024, 1024),  # heavy zero-padding
        (400, 512, 512),    # 25 ms frames (frame > n_fft rows kept)
    ],
)
def test_dft_layout_geometry_fuzz(frame_size, n_fft, ent_n_fft):
    """Merged and pair layouts agree (and both clear the oracle gates)
    across frame/FFT geometries, including truncation, zero-padding, and
    the odd-entropy-n_fft partial fallback."""
    from sspv_tpu.ops.pipeline import FeaturePipeline, FeatureConfig

    rng = np.random.default_rng(frame_size + n_fft + ent_n_fft)
    raw = (rng.standard_normal((32, frame_size)) * 2000).astype(np.float32)
    kw = dict(frame_size=frame_size, hop_size=frame_size // 2,
              n_fft=n_fft, entropy_n_fft=ent_n_fft)
    pm = FeaturePipeline(FeatureConfig(dft_layout="merged", **kw))
    pp = FeaturePipeline(FeatureConfig(dft_layout="pair", **kw))
    fa, fb = pm.features(raw), pp.features(raw)
    for key in ("energy", "zcr", "entropy", "mfcc"):
        assert nmse(np.asarray(fa[key]), np.asarray(fb[key])) < 1e-12, key
    windowed = (raw * oracle.hamming(frame_size)).astype(np.float32)
    want_mfcc = oracle.mfcc(windowed, 16000, n_fft=n_fft, lifter=22)
    want_ent = oracle.spectral_entropy(windowed, ent_n_fft)
    for feats in (fa, fb):
        assert nmse(np.asarray(feats["mfcc"]), want_mfcc) < 1e-5
        assert nmse(np.asarray(feats["entropy"]), want_ent) < 1e-6


def test_compute_mfcc_empty_keeps_caller_num_ceps():
    """Reference shape parity: the empty early-return uses the caller's
    num_ceps even when it exceeds num_filters (the reference clamps only
    on the non-empty path)."""
    import jax.numpy as jnp

    from sspv_tpu import ops

    out = ops.compute_mfcc(
        jnp.zeros((0, 320)), 16000, num_filters=26, num_ceps=40
    )
    assert out.shape == (0, 40)
