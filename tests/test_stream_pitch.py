#!/usr/bin/env python3
"""Fused streaming pitch (FeaturePipeline.stream_pitch): real-time F0 at
frame-block latency, one device dispatch per block.

Contracts:
- yielded blocks are bit-identical to FeaturePipeline.stream's under the
  same chunking (the fused program must not perturb the feature path);
- the concatenated F0 bit-matches the offline frames-path track
  (ops/pitch.pitch_track with the Wiener-Khinchin matmul ACF — the
  matmul form the fused program compiles; autocorrelation_via_dft's
  parity vs the reference loop is gated in bench.py) on the streaming VAD —
  i.e. chunking and bucket padding are invisible to the pitch decision.
  Confidence is compared at rtol=1e-5: XLA tiles the ACF matmuls per block
  shape, reassociating the contraction at the ulp level (same treatment as
  test_parallel.test_pitch_track_under_mesh); the banded argmax (f0) is
  unchanged by it.
"""

import numpy as np

from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline
from sspv_tpu.ops.pitch import pitch_track


def _speechy(seconds: float, sr: int = 16000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    seg = (t * 2).astype(int) % 4
    sig = rng.normal(0, 40, n)
    sig = np.where(seg == 1, 7000 * np.sin(2 * np.pi * 135 * t), sig)
    sig = np.where(seg == 2, rng.normal(0, 2200, n), sig)
    return sig.astype(np.float32)


def _chunk(sig: np.ndarray, sizes) -> list:
    out, pos, i = [], 0, 0
    while pos < len(sig):
        s = sizes[i % len(sizes)]
        out.append(sig[pos : pos + s])
        pos += s
        i += 1
    return out


def test_stream_pitch_matches_stream_and_offline_track():
    sig = _speechy(3.0)
    pipe = FeaturePipeline(FeatureConfig())
    for sizes in ([1600], [777, 4096, 123], [160000]):
        chunks = _chunk(sig, sizes)
        plain = list(pipe.stream(iter(chunks)))
        fused = list(pipe.stream_pitch(iter(chunks)))
        assert len(plain) == len(fused)
        for want, (got, f0, conf) in zip(plain, fused):
            for k in ("energy", "zcr", "entropy", "mfcc", "vad",
                      "vad_adaptive"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(got, k)), np.asarray(getattr(want, k)),
                    err_msg=f"{k} sizes={sizes}",
                )
            assert f0.shape == conf.shape == np.asarray(want.vad).shape

        # offline comparator: reference-semantics frames-path track gated on
        # the streaming VAD (bit-identical to the full-signal run)
        vad = np.concatenate([np.asarray(b.vad) for b in plain])
        frames = pipe.stream_frames(sig)[: vad.shape[0]]
        want_f0, want_conf = pitch_track(frames, vad, acf_impl="dft")
        got_f0 = np.concatenate([f for _, f, _ in fused])
        got_conf = np.concatenate([c for _, _, c in fused])
        np.testing.assert_array_equal(got_f0, np.asarray(want_f0))
        np.testing.assert_allclose(
            got_conf, np.asarray(want_conf), rtol=1e-5
        )
        # the voiced tone is actually tracked
        v = got_f0[got_f0 > 0]
        assert v.size and abs(np.median(v) - 135) < 10


def test_stream_pitch_random_chunking_fuzz():
    """Random chunk-size sequences (the space the fixed cases can't cover):
    the F0 decision stream must be invariant to how the audio arrives."""
    pipe = FeaturePipeline(FeatureConfig())
    sig = _speechy(2.0, seed=11)
    want = None
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        sizes = rng.integers(150, 9000, size=24).tolist()
        fused = list(pipe.stream_pitch(iter(_chunk(sig, sizes))))
        f0 = np.concatenate([f for _, f, _ in fused])
        vad = np.concatenate([np.asarray(b.vad) for b, _, _ in fused])
        if want is None:
            frames = pipe.stream_frames(sig)[: vad.shape[0]]
            want = np.asarray(pitch_track(frames, vad, acf_impl="dft")[0])
        np.testing.assert_array_equal(f0, want[: f0.shape[0]], err_msg=str(seed))


def test_stream_pitch_band_and_threshold():
    """Non-default band + strict threshold: traced threshold must gate
    identically to the offline track's static one; the band key compiles a
    separate fused program (bounded cache)."""
    sig = _speechy(1.5, seed=3)
    pipe = FeaturePipeline(FeatureConfig())
    kw = dict(fmin=90.0, fmax=250.0, min_confidence=0.55)
    fused = list(pipe.stream_pitch(iter([sig]), **kw))
    vad = np.concatenate([np.asarray(b.vad) for b, _, _ in fused])
    frames = pipe.stream_frames(sig)[: vad.shape[0]]
    want_f0, want_conf = pitch_track(
        frames, vad, fmin=kw["fmin"], fmax=kw["fmax"],
        min_confidence=kw["min_confidence"], acf_impl="dft",
    )
    got_f0 = np.concatenate([f for _, f, _ in fused])
    np.testing.assert_array_equal(got_f0, np.asarray(want_f0))
    np.testing.assert_allclose(
        np.concatenate([c for _, _, c in fused]), np.asarray(want_conf),
        rtol=1e-5,
    )
    assert (90.0, 250.0) in pipe._block_pitch_jits
    assert (50.0, 400.0) not in pipe._block_pitch_jits


def test_stream_pitch_tracks_a_chirp():
    """A 100->280 Hz glissando: the streamed F0 track must follow the
    instantaneous frequency within ACF lag-bin resolution (~coarse at the
    top of the band: bin spacing grows with f^2/sr), frame by frame."""
    sr = 16000
    secs = 2.0
    t = np.arange(int(secs * sr)) / sr
    f_inst = 100 + (280 - 100) * (t / secs)
    phase = 2 * np.pi * np.cumsum(f_inst) / sr
    sig = (9000 * np.sin(phase)).astype(np.float32)

    pipe = FeaturePipeline(FeatureConfig())
    fused = list(pipe.stream_pitch(iter([sig[:16000], sig[16000:]])))
    f0 = np.concatenate([f for _, f, _ in fused])
    centers = 320 / 2 / sr + np.arange(f0.shape[0]) * 160 / sr
    expect = 100 + (280 - 100) * (centers / secs)
    voiced = f0 > 0
    assert voiced.mean() > 0.9  # a loud tone should be voiced throughout
    # lag-bin quantization: at 280 Hz neighboring lags are ~5 Hz apart;
    # allow one bin plus the half-frame frequency sweep (~9 Hz)
    err = np.abs(f0[voiced] - expect[voiced])
    assert np.percentile(err, 95) < 12.0, float(np.percentile(err, 95))
    # monotone trend: the track's start and end straddle the sweep
    assert np.median(f0[voiced][:20]) < 115
    assert np.median(f0[voiced][-20:]) > 255
