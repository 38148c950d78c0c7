#!/usr/bin/env python3
"""process_signal_auto: bucketed-length processing must match exact-length
processing bit-for-bit on VAD and share compiled programs across lengths."""

import numpy as np

from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline


def test_auto_matches_exact_across_lengths():
    rng = np.random.default_rng(21)
    pipe = FeaturePipeline(FeatureConfig())
    for n in [16000, 23456, 31999, 32000 * 3, 16000 * 9]:
        sig = rng.normal(0, 3000, n).astype(np.float32)
        got, got_st = pipe.process_signal_auto(sig)
        want, want_st = pipe.process_signal_device(sig)
        nf = np.asarray(want.vad).size
        assert np.asarray(got.vad).size == nf, n
        np.testing.assert_array_equal(
            np.asarray(got.vad), np.asarray(want.vad), err_msg=str(n)
        )
        np.testing.assert_allclose(
            np.asarray(got.energy), np.asarray(want.energy), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(got.mfcc), np.asarray(want.mfcc), atol=2e-3
        )
        # carried state must be identical (padding masked out)
        assert int(got_st.count) == int(want_st.count)
        assert int(got_st.last_voiced) == int(want_st.last_voiced)
        np.testing.assert_allclose(
            np.asarray(got_st.energy_buf), np.asarray(want_st.energy_buf), rtol=1e-5
        )


def test_auto_bucket_reuse():
    """Two different lengths inside one bucket must reuse the same padded
    shape (and therefore the same compiled program)."""
    import jax

    pipe = FeaturePipeline(FeatureConfig())
    seen_shapes = []
    orig = pipe._process_signal_masked_impl

    def spy(padded, state, true_n):
        seen_shapes.append(padded.shape)
        return orig(padded, state, true_n)

    # the jitted callable is created in __init__; re-wrap it around the spy
    # (the spy body runs only at trace time, so entries == compiles)
    pipe._signal_masked_jit = jax.jit(spy)
    rng = np.random.default_rng(22)
    pipe.process_signal_auto(rng.normal(0, 100, 17000).astype(np.float32))
    pipe.process_signal_auto(rng.normal(0, 100, 30000).astype(np.float32))
    # the spy only runs at trace time: one entry for two lengths proves the
    # second call reused the compiled 2 s-bucket program. The bucketed
    # dispatch ships the host-formed rows view (32000 samples -> (200, 160))
    # so the program starts in the tiled 2-D layout.
    assert seen_shapes == [(200, 160)]


def test_auto_int16_input_bit_identical_to_f32():
    """int16 input ships as int16 (half the host->device bytes) and casts
    to float32 on device — outputs must be bit-identical to pre-cast f32
    input, in both the bucketed and the oversized/exact-length paths."""
    pipe = FeaturePipeline(FeatureConfig())
    rng = np.random.default_rng(7)
    for n_samples in (17000, 33000):
        sig16 = (rng.normal(0, 3000, n_samples)).astype(np.int16)
        a, _ = pipe.process_signal_auto(sig16)
        b, _ = pipe.process_signal_auto(sig16.astype(np.float32))
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    # device path (exact-length program)
    sig16 = (rng.normal(0, 3000, 16000)).astype(np.int16)
    a, _ = pipe.process_signal_device(sig16)
    b, _ = pipe.process_signal_device(sig16.astype(np.float32))
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_pitch_signal_auto_exact_bucket_with_ceil_vad():
    """A signal landing exactly on a bucket boundary with a non-hop-aligned
    tail used to crash pitch_signal_auto: the ceil-framed vad (from
    process_signal pad_tail) has one more frame than the floor-framed padded
    signal. Outputs must come back at len(vad) with a zero tail."""
    import jax

    sr = 22050
    cfg = FeatureConfig(sample_rate=sr)
    pipe = FeaturePipeline(cfg)
    rng = np.random.default_rng(7)
    sig = (rng.normal(0, 1000, 2 * sr)).astype(np.float32)  # == 2 s bucket
    assert (len(sig) - cfg.frame_size) % cfg.hop_size != 0
    block, _ = pipe.process_signal(sig)
    jax.block_until_ready(block)
    vad = np.asarray(block.vad)
    f0, conf = pipe.pitch_signal_auto(sig, vad)
    assert f0.shape == vad.shape and conf.shape == vad.shape
    # the extra ceil frame has no signal support: reported unvoiced
    assert f0[-1] == 0.0


def test_num_ceps_clamped_to_num_filters():
    """num_ceps > num_filters must clamp (a length-N DCT-II has N coeffs),
    matching compute_mfcc and the reference's full-DCT-then-slice."""
    pipe = FeaturePipeline(FeatureConfig(num_ceps=30, num_filters=26))
    assert pipe.cfg.num_ceps == 26
    block, _ = pipe.process_signal(np.random.default_rng(0)
                                   .normal(0, 500, 16000).astype(np.float32))
    assert np.asarray(block.mfcc).shape[1] == 26


def test_oversized_signals_share_quantized_programs():
    """Signals beyond the largest bucket quantize to multiples of it (one
    program per quantum, not one exact-length compile per distinct length)
    and stay exactly equal to the unpadded path."""
    import jax

    pipe = FeaturePipeline(FeatureConfig())
    pipe.SIGNAL_BUCKET_SECONDS = (1, 2)  # shrink so "oversized" is cheap
    rng = np.random.default_rng(3)
    for seconds in (2.3, 3.7):  # both quantize to the 4 s = 2*2 s quantum
        n = int(seconds * 16000)
        sig = rng.normal(0, 900, n).astype(np.float32)
        block, _ = pipe.process_signal_auto(sig)
        jax.block_until_ready(block)
        want, _ = pipe.process_signal(sig, pad_tail=False)
        np.testing.assert_array_equal(
            np.asarray(block.vad), np.asarray(want.vad)
        )
        # different compiled programs (masked scan vs exact-length) may
        # reassociate reductions: parity, not bit-equality, for energy
        np.testing.assert_allclose(
            np.asarray(block.energy), np.asarray(want.energy), rtol=1e-6
        )
        # pitch path quantizes identically and returns len(vad) outputs
        f0, conf = pipe.pitch_signal_auto(sig, np.asarray(block.vad))
        assert f0.shape == np.asarray(block.vad).shape


def test_fused_pitch_auto_matches_two_call_path():
    """process_signal_pitch_auto (one fused dispatch: features + VAD +
    VAD-gated pitch) must equal process_signal_auto followed by
    pitch_signal_auto bit-for-bit — the serving layer and analyze CLI ride
    the fused program; parity with the two-call path is its contract.
    Covers int16/float32 input, a bucket-exact length, a sub-frame input
    (fallback path), and a non-default band with a strict threshold."""
    import jax
    import numpy as np

    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline

    rng = np.random.default_rng(5)
    sr = 16000
    pipe = FeaturePipeline(FeatureConfig())
    cases = [
        (3.7, np.int16, dict()),
        (8.0, np.float32, dict()),  # exactly the 8 s bucket boundary
        (0.015, np.int16, dict()),  # sub-frame: falls back to two calls
        (2.2, np.int16, dict(fmin=80.0, fmax=300.0, min_confidence=0.6)),
    ]
    for secs, dtype, kw in cases:
        t = np.arange(int(secs * sr)) / sr
        sig = (
            4000 * np.sin(2 * np.pi * 140 * t)
            * (((t * 2).astype(int) % 2) == 0)
            + rng.normal(0, 300, t.size)
        ).astype(dtype)
        b2, s2 = pipe.process_signal_auto(sig)
        f2, c2 = pipe.pitch_signal_auto(sig, np.asarray(b2.vad), **kw)
        b1, s1, f1, c1 = pipe.process_signal_pitch_auto(sig, **kw)
        for k in ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive"):
            np.testing.assert_array_equal(
                np.asarray(getattr(b1, k)), np.asarray(getattr(b2, k))
            )
        np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        # the carried VadState must match too: resumable offline callers
        # chain fused and plain calls interchangeably
        for leaf1, leaf2 in zip(jax.tree.leaves(s1), jax.tree.leaves(s2)):
            np.testing.assert_array_equal(
                np.asarray(leaf1), np.asarray(leaf2)
            )


def test_fused_pitch_auto_oversized_quantized_matches_two_call():
    """Signals beyond the largest bucket take the quantized-program route;
    the fused dispatch must follow the exact same quantization and stay
    bit-identical to the two-call path there too (the batch CLI feeds huge
    files through this branch). Buckets shrunk so the case runs on CPU."""
    import numpy as np

    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline

    pipe = FeaturePipeline(FeatureConfig())
    pipe.SIGNAL_BUCKET_SECONDS = (2, 4)  # 11 s input -> oversized -> 12 s
    sr = 16000
    t = np.arange(11 * sr) / sr
    sig = (
        5000 * np.sin(2 * np.pi * 125 * t) * (((t).astype(int) % 2) == 0)
    ).astype(np.int16)

    b2, _ = pipe.process_signal_auto(sig)
    f2, c2 = pipe.pitch_signal_auto(sig, np.asarray(b2.vad))
    b1, _, f1, c1 = pipe.process_signal_pitch_auto(sig)
    for k in ("energy", "zcr", "entropy", "mfcc", "vad", "vad_adaptive"):
        np.testing.assert_array_equal(
            np.asarray(getattr(b1, k)), np.asarray(getattr(b2, k)), err_msg=k
        )
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    n = 1 + (len(sig) - 320) // 160
    assert np.asarray(f1).shape == (n,)
