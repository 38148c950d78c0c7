#!/usr/bin/env python3
"""Checks that only mean something on the GPU: the shipped matmul precision
against the float64 oracle, where float32 matmuls may run as TF32.

Marked ``gpu``; the ``gpu_device`` fixture skips them elsewhere.
``chip_smoke.py`` runs them on the card (``pytest -m gpu``).
"""

import numpy as np
import pytest

import oracle
from sspv_tpu.config import Config
from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline

pytestmark = pytest.mark.gpu


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean((got - want) ** 2) / max(np.mean(want**2), 1e-12)


def _speechlike(seconds, seed=0):
    sr = 16000
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    voiced = ((t * 2).astype(int) % 4) == 1
    sig = np.where(voiced, 6000 * np.sin(2 * np.pi * 130 * t)
                   + 2000 * np.sin(2 * np.pi * 260 * t), rng.normal(0, 40, t.size))
    return sig.astype(np.float32)


def test_view_path_parity_at_shipped_precision(gpu_device):
    pipe = FeaturePipeline(FeatureConfig.from_config(Config))
    sig = _speechlike(120.0)
    block, _ = pipe.process_signal_device(sig)
    frames = oracle.framing(sig, 320, 160, oracle.hamming(320))
    n = int(np.asarray(block.vad).shape[0])
    frames = frames[:n]
    want = {
        "energy": oracle.short_time_energy(frames),
        "mfcc": oracle.mfcc(frames, 16000, lifter=22),
        "entropy": oracle.spectral_entropy(frames, 512),
    }
    for k, w in want.items():
        assert _nmse(getattr(block, k), w) <= 1e-5, k


def test_signal_pitch_matches_direct_acf(gpu_device):
    from sspv_tpu.ops.pitch import pitch_from_frames, pitch_track_signal

    cfg = FeatureConfig.from_config(Config)
    pipe = FeaturePipeline(cfg)
    sig = _speechlike(60.0, seed=1)
    frames = pipe.stream_frames(sig)
    ones = np.ones((frames.shape[0],), np.int32)
    f0_sig, _ = pitch_track_signal(
        pipe.host_rows_view(sig), ones, min_confidence=float("-inf"),
        precision=cfg.precision,
    )
    f0_direct, _ = pitch_from_frames(frames, 16000, acf_impl="direct")
    assert np.mean(np.asarray(f0_sig) == np.asarray(f0_direct)) >= 0.999


def test_frames_and_view_paths_agree_on_vad(gpu_device):
    pipe = FeaturePipeline(FeatureConfig.from_config(Config))
    sig = _speechlike(120.0, seed=2)
    view, _ = pipe.process_signal_device(sig)
    frames, _ = pipe.process_signal(sig)
    agree = np.mean(np.asarray(view.vad) == np.asarray(frames.vad))
    assert agree >= 0.999
