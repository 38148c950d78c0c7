#!/usr/bin/env python3
"""Host-formed rows-view input: bit-identity with the 1-D signal path.

The offline signal programs accept the signal either as raw 1-D samples or
as the host-formed ``(n+1, hop)`` rows view (``host_rows_view`` — a free
numpy reshape). The 2-D form exists purely to skip the on-device 1-D→2-D
relayout copy; the downstream arithmetic reads only row contents, so every
output must be BIT-identical between the two forms. These tests pin that
contract on the XLA view path, for features and pitch, through both the raw
jits and the public bucketed dispatchers.

Reference parity context: the signal programs implement the per-frame loop
of rtvp ``runtime/engine.py:240-311``; the rows view is the device-side
layout of the same frames.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline
from sspv_tpu.ops.pitch import pitch_track_signal


def _sig(seconds=2.3, seed=0, extra=77):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000) + extra  # extra: trailing partial-frame samples
    t = np.arange(n) / 16000.0
    x = rng.normal(0, 300, n).astype(np.float32)
    voiced = (t * 2).astype(int) % 2 == 1
    return np.where(voiced, 5000 * np.sin(2 * np.pi * 130 * t), x).astype(
        np.float32
    )


def _assert_blocks_equal(b1, b2):
    for k in b1._fields:
        a, b = np.asarray(getattr(b1, k)), np.asarray(getattr(b2, k))
        assert a.shape == b.shape, k
        assert np.array_equal(a, b), k


def test_host_rows_view_is_a_view_and_geometry_gated():
    pipe = FeaturePipeline(FeatureConfig())
    sig = _sig()
    rows = pipe.host_rows_view(sig)
    assert rows is not None
    assert rows.base is not None  # numpy view, not a copy
    n = 1 + (len(sig) - pipe.cfg.frame_size) // pipe.cfg.hop_size
    assert rows.shape == (n + 1, pipe.cfg.hop_size)
    # non-view geometry -> None (dispatchers fall back to the 1-D form)
    pipe2 = FeaturePipeline(FeatureConfig(frame_size=300, hop_size=160))
    assert pipe2.host_rows_view(sig) is None
    # sub-frame input -> None
    assert pipe.host_rows_view(sig[:100]) is None


def test_rows_input_bitidentical_features_raw_jit():
    pipe = FeaturePipeline(FeatureConfig())
    sig = _sig()
    state = pipe.initial_state()
    b1, s1 = pipe._signal_jit(jnp.asarray(sig), state)
    b2, s2 = pipe._signal_jit(jnp.asarray(pipe.host_rows_view(sig)), state)
    _assert_blocks_equal(b1, b2)
    for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(s2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_rows_input_bitidentical_long_scan_path():
    # force the long-signal branch (n > SCAN_BLOCK_FRAMES) with a tiny block
    pipe = FeaturePipeline(FeatureConfig())
    orig = FeaturePipeline.SCAN_BLOCK_FRAMES
    FeaturePipeline.SCAN_BLOCK_FRAMES = 256
    try:
        sig = _sig(seconds=6.0)
        state = pipe.initial_state()
        b1, _ = pipe._signal_jit(jnp.asarray(sig), state)
        b2, _ = pipe._signal_jit(
            jnp.asarray(pipe.host_rows_view(sig)), state
        )
        _assert_blocks_equal(b1, b2)
    finally:
        FeaturePipeline.SCAN_BLOCK_FRAMES = orig


def test_rows_input_public_dispatchers_bitidentical():
    pipe = FeaturePipeline(FeatureConfig())
    sig = _sig()
    state = pipe.initial_state()
    want, _ = pipe._signal_jit(jnp.asarray(sig), state)
    got_dev, _ = pipe.process_signal_device(sig)  # routes rows internally
    _assert_blocks_equal(want, got_dev)
    # bucketed masked program: 1-D padded input vs the rows it now sends
    got_auto, _ = pipe.process_signal_auto(sig)
    n = want.vad.shape[0]
    target = next(
        s * 16000
        for s in pipe.SIGNAL_BUCKET_SECONDS
        if len(sig) <= s * 16000
    )
    padded = np.pad(sig, (0, target - len(sig)))
    ref_b, _ = pipe._signal_masked_jit(
        jnp.asarray(padded), pipe.initial_state(), jnp.int32(n)
    )
    for k in want._fields:
        assert np.array_equal(
            np.asarray(getattr(got_auto, k)),
            np.asarray(getattr(ref_b, k))[:n],
        ), k


def test_rows_input_int16_auto():
    pipe = FeaturePipeline(FeatureConfig())
    sig16 = (_sig() / 4).astype(np.int16)
    b_rows, _ = pipe.process_signal_auto(sig16)
    # same int16 samples through the 1-D masked program
    n = b_rows.vad.shape[0]
    target = next(
        s * 16000
        for s in pipe.SIGNAL_BUCKET_SECONDS
        if len(sig16) <= s * 16000
    )
    padded = np.pad(sig16, (0, target - len(sig16)))
    b_1d, _ = pipe._signal_masked_jit(
        jnp.asarray(padded), pipe.initial_state(), jnp.int32(n)
    )
    for k in b_rows._fields:
        assert np.array_equal(
            np.asarray(getattr(b_rows, k)), np.asarray(getattr(b_1d, k))[:n]
        ), k


def test_rows_input_bitidentical_pitch():
    pipe = FeaturePipeline(FeatureConfig())
    sig = _sig()
    block, _ = pipe.process_signal_device(sig)
    vad = np.asarray(block.vad)
    f0a, ca = pitch_track_signal(sig, vad)
    f0b, cb = pitch_track_signal(pipe.host_rows_view(sig), vad)
    assert np.array_equal(np.asarray(f0a), np.asarray(f0b))
    assert np.array_equal(np.asarray(ca), np.asarray(cb))


def test_rows_input_fused_pitch_equals_two_call():
    # the CLAUDE.md bit-identity invariant, now with both sides on rows
    pipe = FeaturePipeline(FeatureConfig())
    sig = _sig()
    blk, _st, f0, conf = pipe.process_signal_pitch_auto(sig)
    b2, _ = pipe.process_signal_auto(sig)
    f2, c2 = pipe.pitch_signal_auto(sig, np.asarray(b2.vad))
    _assert_blocks_equal(blk, b2)
    assert np.array_equal(f0, f2)
    assert np.array_equal(conf, c2)
