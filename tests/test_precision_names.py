#!/usr/bin/env python3
"""Matmul-precision knob names resolve identically everywhere, and the
shipped default is one value across the config surfaces that carry it."""

import inspect

import jax
import pytest

from sspv_tpu.config import Config
from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline
from sspv_tpu.ops.precision import resolve

P = jax.lax.Precision


@pytest.mark.parametrize("name,want", [
    ("highest", P.HIGHEST),
    ("high", P.HIGH),
    ("default", P.DEFAULT),
    ("HIGHEST", P.HIGHEST),
    (" High ", P.HIGH),
    ("bogus", P.HIGHEST),
    ("", P.HIGHEST),
])
def test_resolve(name, want):
    assert resolve(name) == want


def test_shipped_default_is_one_value():
    from sspv_tpu.ops import pitch

    default = Config.TPU_MATMUL_PRECISION
    assert default in ("high", "highest")
    assert FeatureConfig().precision == default
    assert FeatureConfig.from_config(Config).precision == default
    for fn in (pitch.pitch_track_signal_jit, pitch.pitch_track_signal_gated):
        assert inspect.signature(fn).parameters["precision"].default == default
    # pitch_track_signal is jitted; its wrapped function carries the default
    sig = inspect.signature(pitch.pitch_track_signal.__wrapped__)
    assert sig.parameters["precision"].default == default


def test_pipeline_resolves_its_precision():
    for name in ("high", "highest"):
        pipe = FeaturePipeline(FeatureConfig(precision=name))
        assert pipe._precision == resolve(name)
