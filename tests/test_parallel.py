#!/usr/bin/env python3
"""Multi-device sharding: data-parallel batch and sequence-sharded long-signal
paths must agree with the single-device pipeline exactly."""

import pytest
import numpy as np
import jax
from jax.sharding import Mesh

from sspv_tpu.ops.pipeline import FeaturePipeline, FeatureConfig
from sspv_tpu.parallel import make_mesh, BatchPipeline


def test_mesh_shape():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("data", "seq")


def test_batch_matches_single_device():
    rng = np.random.default_rng(0)
    signals = rng.normal(0, 3000, (8, 16000)).astype(np.float32)
    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    block, states = bp.process_batch(signals)

    pipe = FeaturePipeline(FeatureConfig())
    for i in range(8):
        want, _ = pipe.process_signal_device(signals[i])
        np.testing.assert_allclose(
            np.asarray(block.energy[i]), np.asarray(want.energy), rtol=2e-6
        )
        np.testing.assert_array_equal(
            np.asarray(block.vad[i]), np.asarray(want.vad)
        )
        np.testing.assert_allclose(
            np.asarray(block.mfcc[i]), np.asarray(want.mfcc), atol=2e-4
        )


def test_long_signal_sequence_sharding():
    rng = np.random.default_rng(1)
    sig = rng.normal(0, 3000, (16000 * 4,)).astype(np.float32)
    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    block, state = bp.process_long(sig)

    pipe = FeaturePipeline(FeatureConfig())
    want, want_state = pipe.process_signal_device(sig)
    np.testing.assert_allclose(
        np.asarray(block.energy), np.asarray(want.energy), rtol=2e-6
    )
    np.testing.assert_array_equal(np.asarray(block.vad), np.asarray(want.vad))
    assert int(state.count) == int(want_state.count)


def test_long_signal_scan_blocks_under_mesh():
    """The sequence-parallel long path through the lax.scan-over-blocks
    machinery (signal long enough to exceed SCAN_BLOCK_FRAMES, shrunk here so
    the CPU mesh test stays cheap): carried VadState + masked padded tail
    must agree exactly with the single-device result."""
    rng = np.random.default_rng(7)
    sig = np.zeros(16000 * 2, dtype=np.float32)
    sig[4000:12000] = np.sin(2 * np.pi * 200 * np.arange(8000) / 16000) * 9000
    sig[12000:20000] = rng.normal(0, 2500, 8000)

    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    bp.pipe.SCAN_BLOCK_FRAMES = 64  # 199 frames -> 4 scan blocks, padded tail
    block, state = bp.process_long(sig)
    assert np.asarray(block.energy).shape == (199,)

    pipe = FeaturePipeline(FeatureConfig())
    want, want_state = pipe.process_signal_device(sig)
    np.testing.assert_allclose(
        np.asarray(block.energy), np.asarray(want.energy), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(block.mfcc), np.asarray(want.mfcc), atol=2e-4
    )
    np.testing.assert_array_equal(np.asarray(block.vad), np.asarray(want.vad))
    np.testing.assert_array_equal(
        np.asarray(block.vad_adaptive), np.asarray(want.vad_adaptive)
    )
    assert int(state.count) == int(want_state.count)
    assert int(state.last_voiced) == int(want_state.last_voiced)


def test_streaming_padded_tail_under_mesh():
    """Bucketed streaming block with a masked padded tail, frames sharded
    over the flattened ("data","seq") mesh: the masked streaming_vad
    (state-correction pass) must be exact under sharding too."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(8)
    pipe = FeaturePipeline(FeatureConfig())
    sig = rng.normal(0, 4000, (16000,)).astype(np.float32)
    frames = pipe.stream_frames(sig)  # (99, 320)
    n = frames.shape[0]
    bucket = 128
    padded = np.pad(frames, ((0, bucket - n), (0, 0)))
    valid = np.arange(bucket) < n

    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P(("data", "seq"), None))
    vh = NamedSharding(mesh, P(("data", "seq")))
    jitted = jax.jit(pipe._process_block_impl, in_shardings=(sh, None, vh))
    block, state = jitted(
        jax.device_put(padded, sh), pipe.initial_state(), jax.device_put(valid, vh)
    )

    want, want_state = pipe.process_block(frames, pipe.initial_state())
    np.testing.assert_allclose(
        np.asarray(block.energy)[:n], np.asarray(want.energy), rtol=2e-6
    )
    np.testing.assert_array_equal(
        np.asarray(block.vad)[:n], np.asarray(want.vad)
    )
    # padded frames must not have leaked into the carried state
    assert int(state.count) == int(want_state.count) == n
    assert int(state.last_voiced) == int(want_state.last_voiced)


def test_blocked_trailing_scan_blocks_under_mesh():
    """The production-default 'blocked' trailing-sum VAD (two-level block
    cumsums, ops/vad.py:_blocked_trailing_sums) under the ("data","seq")
    mesh through the lax.scan-over-blocks machinery: SCAN_BLOCK_FRAMES=256
    == history_len, so every scan step takes the blocked branch (NOT the
    conv fallback — asserted via the trace counter). Results must bit-match
    the single-device pipeline, whose one 1024-frame block also runs blocked
    (1024 % 256 == 0) with identically-aligned 256-lane cumsums."""
    from sspv_tpu.ops import vad as vad_ops

    rng = np.random.default_rng(11)
    # 1024 frames exactly: length = (1024-1)*160 + 320
    n_frames = 1024
    length = (n_frames - 1) * 160 + 320
    t = np.arange(length) / 16000.0
    seg = (t * 2).astype(int) % 4
    sig = rng.normal(0, 40, length)
    sig = np.where(seg == 1, 8000 * np.sin(2 * np.pi * 170 * t), sig)
    sig = np.where(seg == 2, rng.normal(0, 2200, length), sig)
    sig = sig.astype(np.float32)

    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    assert bp.pipe.cfg.vad_trailing_impl == "blocked"
    bp.pipe.SCAN_BLOCK_FRAMES = 256  # == history_len: every step blocked
    before = vad_ops.BLOCKED_TRACE_COUNT
    block, state = bp.process_long(sig)
    assert vad_ops.BLOCKED_TRACE_COUNT > before, (
        "sharded scan compiled the conv fallback, not the blocked impl"
    )
    assert np.asarray(block.energy).shape == (n_frames,)

    pipe = FeaturePipeline(FeatureConfig())
    before = vad_ops.BLOCKED_TRACE_COUNT
    want, want_state = pipe.process_signal_device(sig)
    assert vad_ops.BLOCKED_TRACE_COUNT > before

    np.testing.assert_allclose(
        np.asarray(block.energy), np.asarray(want.energy), rtol=2e-6
    )
    np.testing.assert_array_equal(np.asarray(block.vad), np.asarray(want.vad))
    np.testing.assert_array_equal(
        np.asarray(block.vad_adaptive), np.asarray(want.vad_adaptive)
    )
    assert int(state.count) == int(want_state.count)
    assert int(state.last_voiced) == int(want_state.last_voiced)
    np.testing.assert_array_equal(
        np.asarray(state.energy_buf), np.asarray(want_state.energy_buf)
    )


def test_blocked_trailing_bucket256_streaming_under_mesh():
    """A production streaming bucket (256 — a TPU_STREAM_BUCKETS member and a
    history_len multiple, so the engine's default dispatch runs the blocked
    impl) sharded over all 8 devices, with a masked padded tail: bit-equal to
    the identical bucketed computation on a single device, and the padded
    frames must not leak into the carried state."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sspv_tpu.ops import vad as vad_ops

    rng = np.random.default_rng(13)
    pipe = FeaturePipeline(FeatureConfig())
    sig = rng.normal(0, 4000, (16000 * 2,)).astype(np.float32)
    frames = pipe.stream_frames(sig)  # (199, 320)
    n = frames.shape[0]
    bucket = 256
    padded = np.pad(frames, ((0, bucket - n), (0, 0)))
    valid = np.arange(bucket) < n

    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P(("data", "seq"), None))
    vh = NamedSharding(mesh, P(("data", "seq")))
    before = vad_ops.BLOCKED_TRACE_COUNT
    jitted = jax.jit(pipe._process_block_impl, in_shardings=(sh, None, vh))
    block, state = jitted(
        jax.device_put(padded, sh), pipe.initial_state(), jax.device_put(valid, vh)
    )
    jax.block_until_ready(block)
    assert vad_ops.BLOCKED_TRACE_COUNT > before, "mesh program used conv fallback"

    # single-device comparator: the SAME bucketed shape (also blocked)
    want, want_state = pipe.process_block(
        padded, pipe.initial_state(), valid=jax.numpy.asarray(valid)
    )
    np.testing.assert_array_equal(
        np.asarray(block.energy), np.asarray(want.energy)
    )
    np.testing.assert_array_equal(np.asarray(block.vad), np.asarray(want.vad))
    np.testing.assert_array_equal(
        np.asarray(block.vad_adaptive), np.asarray(want.vad_adaptive)
    )
    assert int(state.count) == int(want_state.count) == n
    assert int(state.last_voiced) == int(want_state.last_voiced)


def test_long_signal_real_scan_block_size_under_mesh():
    """process_long at the REAL production SCAN_BLOCK_FRAMES (32768): two
    full scan blocks (65536 frames, ~10.9 min of audio), every step on the
    blocked trailing-sum branch, sharded over the whole mesh — bit-equal VAD
    vs the identical single-device scan. This is the exact program shape the
    flagship offline path compiles in production."""
    from sspv_tpu.ops import vad as vad_ops

    rng = np.random.default_rng(17)
    pipe_probe = FeaturePipeline(FeatureConfig())
    b = pipe_probe.SCAN_BLOCK_FRAMES
    assert b == 32768  # production value; test intentionally NOT shrunk
    n_frames = 2 * b
    length = (n_frames - 1) * 160 + 320
    # piecewise segments keep synth cost low but still exercise voiced /
    # unvoiced / silence transitions across scan-block boundaries
    sig = rng.normal(0, 50, length).astype(np.float32)
    sig[length // 3 : length // 2] = (
        7000 * np.sin(2 * np.pi * 150 * np.arange(length // 2 - length // 3) / 16000)
    ).astype(np.float32)
    sig[length // 2 : 2 * length // 3] = rng.normal(
        0, 2400, 2 * length // 3 - length // 2
    ).astype(np.float32)

    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    before = vad_ops.BLOCKED_TRACE_COUNT
    block, state = bp.process_long(sig)
    assert vad_ops.BLOCKED_TRACE_COUNT > before
    assert np.asarray(block.energy).shape == (n_frames,)

    want, want_state = pipe_probe.process_signal_device(sig)
    np.testing.assert_allclose(
        np.asarray(block.energy), np.asarray(want.energy), rtol=2e-6
    )
    np.testing.assert_array_equal(np.asarray(block.vad), np.asarray(want.vad))
    np.testing.assert_array_equal(
        np.asarray(block.vad_adaptive), np.asarray(want.vad_adaptive)
    )
    assert int(state.count) == int(want_state.count)
    assert int(state.last_voiced) == int(want_state.last_voiced)


def test_batch_blocked_trailing_under_mesh():
    """dp-batch (vmapped per-signal pipeline) with 256-frame rows: the
    blocked trailing-sum branch must compile under vmap + mesh sharding too,
    and every row must match its single-device result exactly."""
    from sspv_tpu.ops import vad as vad_ops

    rng = np.random.default_rng(19)
    n_frames = 256
    length = (n_frames - 1) * 160 + 320
    signals = rng.normal(0, 3000, (8, length)).astype(np.float32)

    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    before = vad_ops.BLOCKED_TRACE_COUNT
    block, states = bp.process_batch(signals)
    assert vad_ops.BLOCKED_TRACE_COUNT > before, "dp batch used conv fallback"
    assert np.asarray(block.vad).shape == (8, n_frames)

    pipe = FeaturePipeline(FeatureConfig())
    for i in range(8):
        want, want_state = pipe.process_signal_device(signals[i])
        np.testing.assert_allclose(
            np.asarray(block.energy[i]), np.asarray(want.energy), rtol=2e-6
        )
        np.testing.assert_array_equal(
            np.asarray(block.vad[i]), np.asarray(want.vad)
        )
        assert int(states.count[i]) == int(want_state.count)


def test_pitch_track_under_mesh():
    """VAD-gated pitch over one long signal with the frame axis sharded over
    the flattened mesh: per-frame banded-ACF peak picking is embarrassingly
    parallel, so the sharded result must match the single-device jitted path
    exactly (same program, same reassociation)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sspv_tpu.ops.pitch import pitch_track_signal

    rng = np.random.default_rng(21)
    n_frames = 256
    length = (n_frames - 1) * 160 + 320
    t = np.arange(length) / 16000.0
    sig = np.where(
        (t * 2).astype(int) % 2 == 0,
        8000 * np.sin(2 * np.pi * 140 * t),
        rng.normal(0, 2000, length),
    ).astype(np.float32)

    pipe = FeaturePipeline(FeatureConfig())
    block, _ = pipe.process_signal_device(sig)
    vad = np.asarray(block.vad)

    f0_single, conf_single = pitch_track_signal(sig, vad)

    mesh = make_mesh(8)
    sig_sh = NamedSharding(mesh, P(("data", "seq")))
    vad_sh = NamedSharding(mesh, P(("data", "seq")))
    f0_mesh, conf_mesh = pitch_track_signal(
        jax.device_put(sig, sig_sh), jax.device_put(vad, vad_sh)
    )
    np.testing.assert_array_equal(np.asarray(f0_single), np.asarray(f0_mesh))
    # SPMD partitioning reassociates the matmul reductions at the ulp level
    # (~1e-6 relative on confidence); the banded argmax (f0) is unchanged
    np.testing.assert_allclose(
        np.asarray(conf_single), np.asarray(conf_mesh), rtol=1e-5
    )
    assert np.asarray(f0_mesh).shape == (n_frames,)
    assert (np.asarray(f0_mesh) > 0).any()


def test_batch_masked_pitch_fused_matches_two_call_path():
    """process_batch_masked_pitch (ONE sharded dispatch: features + VAD +
    VAD-gated pitch per (B, L) batch — the batch CLI's path) must bit-match
    the two-call construction it replaced: process_batch_masked, then a
    host-gated vmapped pitch_track_signal on the masked VAD. Mixed-length
    int16 rows including a sub-frame row and an all-zero (fully masked)
    padding row, plus a non-default band with a strict threshold."""
    import jax

    from sspv_tpu.ops.pitch import pitch_track_signal

    rng = np.random.default_rng(23)
    sr = 16000
    c = FeatureConfig()
    lengths = [sr, sr // 2, 300, sr * 2, 0, sr + 11 * 160, sr * 2, sr // 4]
    L = max(lengths)
    signals = np.zeros((8, L), dtype=np.int16)
    t = np.arange(L) / sr
    for i, n in enumerate(lengths):
        tone = 6000 * np.sin(2 * np.pi * (120 + 15 * i) * t[:n])
        signals[i, :n] = (tone * ((t[:n] * 4).astype(int) % 2 == 0)
                          + rng.normal(0, 500, n)).astype(np.int16)

    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    for kw in (dict(), dict(fmin=80.0, fmax=300.0, min_confidence=0.6)):
        block_f, states_f, f0_f, conf_f = bp.process_batch_masked_pitch(
            signals, lengths, **kw
        )

        # comparator: the exact two-call construction the fused path replaced
        block_2, states_2 = bp.process_batch_masked(signals, lengths)
        n_max = np.asarray(block_2.vad).shape[1]
        row_n = np.where(
            np.asarray(lengths) >= c.frame_size,
            1 + (np.asarray(lengths) - c.frame_size) // c.hop_size,
            0,
        )
        valid = np.arange(n_max)[None, :] < row_n[:, None]
        vads_masked = (np.asarray(block_2.vad).astype(np.int32) * valid)
        f0_2, conf_2 = jax.jit(jax.vmap(
            lambda s, v: pitch_track_signal(
                s, v, c.frame_size, c.hop_size, c.sample_rate, **kw
            )
        ))(signals, vads_masked.astype(np.int32))

        for name, a, b in (
            ("energy", block_f.energy, block_2.energy),
            ("vad", block_f.vad, block_2.vad),
            ("vad_adaptive", block_f.vad_adaptive, block_2.vad_adaptive),
            ("mfcc", block_f.mfcc, block_2.mfcc),
            ("f0", f0_f, f0_2),
            ("conf", conf_f, conf_2),
        ):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=name
            )
        np.testing.assert_array_equal(
            np.asarray(states_f.count), np.asarray(states_2.count)
        )
        # a fused program actually compiled per band (not the two-call pair)
        assert ("batch_masked_pitch", signals.shape,
                kw.get("fmin", 50.0), kw.get("fmax", 400.0)) in bp._batch_jit
        # sanity: some voiced frames found in the default band
        if not kw:
            assert (np.asarray(f0_f) > 0).any()


def test_batch_masked_unequal_lengths():
    """dp batch of unequal-length signals via zero-padding + per-signal
    masked frame counts: each row must match processing its true-length
    prefix alone on a single device."""
    rng = np.random.default_rng(9)
    sr = 16000
    lengths = [sr // 2, sr, sr + 7 * 160, sr * 2, sr // 4, sr, 319, sr * 2]
    L = max(lengths)
    signals = np.zeros((8, L), dtype=np.float32)
    for i, n in enumerate(lengths):
        signals[i, :n] = rng.normal(0, 3000, n)

    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    block, states = bp.process_batch_masked(signals, lengths)

    pipe = FeaturePipeline(FeatureConfig())
    for i, n in enumerate(lengths):
        if n < 320:
            assert int(states.count[i]) == 0
            continue
        want, want_state = pipe.process_signal(signals[i, :n])
        true_n = np.asarray(want.energy).shape[0]
        np.testing.assert_allclose(
            np.asarray(block.energy[i])[:true_n], np.asarray(want.energy),
            rtol=2e-6,
        )
        np.testing.assert_array_equal(
            np.asarray(block.vad[i])[:true_n], np.asarray(want.vad)
        )
        assert int(states.count[i]) == int(want_state.count) == true_n


def test_process_long_pitch_both_routes():
    """process_long_pitch: one mesh program for features+VAD+gated pitch.
    It must be bit-identical to its two-call construction (the CLAUDE.md
    same-path invariant): process_long, then the shared gated pitch track
    on the same VAD."""
    import jax.numpy as jnp

    from sspv_tpu.ops.pitch import pitch_track_signal_gated

    rng = np.random.default_rng(23)
    sig = np.zeros(16000 * 3, dtype=np.float32)
    sig[8000:24000] = np.sin(
        2 * np.pi * 180 * np.arange(16000) / 16000
    ) * 8000
    sig[30000:40000] = rng.normal(0, 2500, 10000)

    mesh = make_mesh(8)
    bp_x = BatchPipeline(mesh)
    block_f, state_f, f0_f, conf_f = bp_x.process_long_pitch(sig)

    # two-call same-path construction: process_long + the shared gate
    block_2, _ = bp_x.process_long(sig)
    np.testing.assert_array_equal(
        np.asarray(block_f.vad), np.asarray(block_2.vad)
    )
    f0_2, conf_2 = jax.jit(
        lambda s, v, mc: pitch_track_signal_gated(s, v, mc)
    )(sig, block_2.vad, jnp.float32(0.3))
    np.testing.assert_array_equal(np.asarray(f0_f), np.asarray(f0_2))
    np.testing.assert_array_equal(np.asarray(conf_f), np.asarray(conf_2))
    # voiced frames exist and carry F0 in the band
    voiced = np.asarray(f0_f)[np.asarray(f0_f) > 0]
    assert voiced.size > 20
    assert np.all((voiced >= 50.0) & (voiced <= 400.0))


@pytest.mark.parametrize("n_frames", [17, 99, 1024])
def test_long_edge_sizes(n_frames):
    """Seam/pad correctness of process_long at awkward frame counts: n
    smaller than one shard's minimum block, n not divisible by the shard
    count, n exactly divisible. Decisions must match the single-device
    pipeline bit-exactly at every size — the regression test for the GSPMD
    conv trailing-sum mis-partitioning (odd small n flipped nearly every
    decision on the mesh route until it was switched to the padded
    blocked-VAD tail; pipeline._process_signal_view_impl
    ``force_full_vad``)."""
    rng = np.random.default_rng(31 + n_frames)
    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    sig = rng.normal(0, 3000, ((n_frames - 1) * 160 + 320,)).astype(np.float32)
    ref, _ = bp.pipe.process_signal(sig)
    blk, _ = bp.process_long(sig)
    assert np.asarray(blk.energy).shape == (n_frames,)
    np.testing.assert_array_equal(
        np.asarray(blk.vad), np.asarray(ref.vad)[:n_frames]
    )
    np.testing.assert_array_equal(
        np.asarray(blk.vad_adaptive), np.asarray(ref.vad_adaptive)[:n_frames]
    )
    a = np.asarray(ref.mfcc, np.float64)
    b = np.asarray(blk.mfcc, np.float64)
    assert np.mean((a - b) ** 2) / max(np.mean(a**2), 1e-12) < 1e-10


def test_long_nonview_edge_sizes():
    """The non-view mesh fallback (frame != 2*hop) at odd, non-shard
    -divisible frame counts: decisions must match the single-chip frames
    path. Regression for the same GSPMD conv-fallback hazard as
    test_long_edge_sizes, on the _process_block_impl-style route
    (mesh now runs the padded blocked VAD tail there too)."""
    rng = np.random.default_rng(5)
    c = FeatureConfig(frame_size=400, hop_size=160)
    mesh = make_mesh(8)
    bp = BatchPipeline(mesh, c)
    pipe = FeaturePipeline(c)
    for n_frames in (17, 99):
        sig = rng.normal(
            0, 3000, ((n_frames - 1) * 160 + 400,)
        ).astype(np.float32)
        ref, _ = pipe.process_signal(sig)
        blk, _ = bp.process_long(sig)
        np.testing.assert_array_equal(
            np.asarray(blk.vad), np.asarray(ref.vad)[:n_frames],
            err_msg=str(n_frames),
        )
        np.testing.assert_array_equal(
            np.asarray(blk.vad_adaptive),
            np.asarray(ref.vad_adaptive)[:n_frames],
            err_msg=f"adaptive {n_frames}",
        )


def test_batch_seq8_edge_sizes():
    """process_batch on a (1, 8) mesh — the frame axis fully 8-way sharded,
    the geometry that exposed the GSPMD conv mis-partitioning on the long
    route. The batched (B, F) conv partitions correctly (different
    partitioner path than the rank-1 case); pin that so a regression in
    either XLA or our layout shows up here and not in production."""
    rng = np.random.default_rng(7)
    mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(1, 8), ("data", "seq")
    )
    bp = BatchPipeline(mesh)
    pipe = bp.pipe
    for n_frames in (17, 99):
        sigs = rng.normal(
            0, 3000, (2, (n_frames - 1) * 160 + 320)
        ).astype(np.float32)
        out = bp.process_batch(sigs)
        blk = out[0] if isinstance(out, tuple) else out
        for i in range(2):
            ref, _ = pipe.process_signal(sigs[i])
            np.testing.assert_array_equal(
                np.asarray(blk.vad[i]), np.asarray(ref.vad),
                err_msg=f"signal {i} n={n_frames}",
            )


def test_long_pitch_edge_sizes():
    """process_long_pitch at an odd, non-shard-divisible frame count: VAD
    decisions (and therefore the pitch gate) must match single-device —
    same GSPMD conv regression class as test_long_edge_sizes."""
    rng = np.random.default_rng(17)
    mesh = make_mesh(8)
    bp = BatchPipeline(mesh)
    pipe = bp.pipe
    n_frames = 99
    t = np.arange((n_frames - 1) * 160 + 320, dtype=np.float32) / 16000.0
    sig = (
        9000.0 * np.sin(2 * np.pi * 120.0 * t)
        + rng.normal(0, 300, t.shape)
    ).astype(np.float32)
    ref, _ = pipe.process_signal(sig)
    blk, _, f0, conf = bp.process_long_pitch(sig)
    np.testing.assert_array_equal(
        np.asarray(blk.vad), np.asarray(ref.vad)[:n_frames]
    )
    voiced = np.asarray(f0)[np.asarray(f0) > 0]
    assert voiced.size > 20
    assert np.all(np.abs(voiced - 120.0) < 12.0)
