#!/usr/bin/env python3
"""Standalone warmup CLI (sspv_tpu.warmup): pre-compiles program families
into the shared persistent cache so deployments don't stall on first
traffic while each cold program compiles."""

import os
import subprocess
import sys

import numpy as np

from sspv_tpu.warmup import warmup


def test_warmup_compiles_selected_families():
    n = warmup(offline="first", stream="first", pitch=True, engine=True,
               batch=4)
    assert n == 4  # offline + stream + engine + batch

    # warmed programs actually exist where the production paths look
    from sspv_tpu.config import Config
    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline

    pipe = FeaturePipeline(FeatureConfig.from_config(Config))
    # the fused offline program for the default band compiles lazily; after
    # a pitch warmup an equivalent pipeline hits it without building anew
    sig = np.zeros((2 * Config.SAMPLE_RATE,), np.int16)
    block, _, f0, _c = pipe.process_signal_pitch_auto(sig)
    assert np.asarray(f0).shape == np.asarray(block.vad).shape


def test_warmup_none_none_is_empty():
    assert warmup(offline="none", stream="none") == 0


def test_warmup_cli_smoke():
    env = dict(os.environ, PYTHONPATH="/root/repo", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "sspv_tpu.warmup", "--offline", "first",
         "--stream", "none"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert "compile cache:" in r.stdout
    assert "warmed offline bucket 2s" in r.stdout
    assert "warmed 1 families" in r.stdout
