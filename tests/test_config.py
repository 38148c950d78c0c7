#!/usr/bin/env python3
"""Config override layers: env-var casting and YAML loading (untested in the
reference; the behavior is part of the compatibility contract)."""

import numpy as np

from sspv_tpu.config import Config


def _restore(attr, value):
    setattr(Config, attr, value)


def test_env_override_casting(monkeypatch):
    orig = {
        "SAMPLE_RATE": Config.SAMPLE_RATE,
        "PREEMPHASIS_ALPHA": Config.PREEMPHASIS_ALPHA,
        "USE_ADAPTIVE_VAD": Config.USE_ADAPTIVE_VAD,
        "WINDOW_TYPE": Config.WINDOW_TYPE,
        "ENERGY_THRESHOLD": Config.ENERGY_THRESHOLD,
    }
    try:
        monkeypatch.setenv("RTP_SAMPLE_RATE", "8000")
        monkeypatch.setenv("RTP_PREEMPHASIS_ALPHA", "0.9")
        monkeypatch.setenv("RTP_USE_ADAPTIVE_VAD", "false")
        monkeypatch.setenv("RTP_WINDOW_TYPE", "hanning")
        monkeypatch.setenv("RTP_ENERGY_THRESHOLD", "bogus")  # cast fails
        monkeypatch.setenv("RTP_NO_SUCH_ATTR", "1")  # unknown: ignored
        Config.load_from_env("RTP_")
        assert Config.SAMPLE_RATE == 8000 and isinstance(Config.SAMPLE_RATE, int)
        assert Config.PREEMPHASIS_ALPHA == 0.9
        assert Config.USE_ADAPTIVE_VAD is False
        assert Config.WINDOW_TYPE == "hanning"
        # failed cast keeps the default (reference config.py:215-216)
        assert Config.ENERGY_THRESHOLD == orig["ENERGY_THRESHOLD"]
        assert not hasattr(Config, "NO_SUCH_ATTR")
    finally:
        for k, v in orig.items():
            _restore(k, v)


def test_yaml_override(tmp_path):
    orig = (Config.ZCR_THRESHOLD, Config.MEL_FILTERS)
    p = tmp_path / "cfg.yaml"
    p.write_text("ZCR_THRESHOLD: 0.25\nMEL_FILTERS: 40\nUNKNOWN_KEY: 1\n")
    try:
        assert Config.load_from_yaml(str(p)) is True
        assert Config.ZCR_THRESHOLD == 0.25
        assert Config.MEL_FILTERS == 40
        assert not hasattr(Config, "UNKNOWN_KEY")
    finally:
        Config.ZCR_THRESHOLD, Config.MEL_FILTERS = orig


def test_yaml_rejects_non_mapping(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("- just\n- a\n- list\n")
    assert Config.load_from_yaml(str(p)) is False
    assert Config.load_from_yaml(str(tmp_path / "missing.yaml")) is False


def test_derived_frame_geometry():
    assert Config.FRAME_SIZE == int(Config.SAMPLE_RATE * Config.FRAME_DURATION / 1000)
    assert Config.HOP_SIZE == Config.FRAME_SIZE // 2


def test_setup_logging_and_print_config(caplog):
    import logging

    Config.setup_logging()
    with caplog.at_level(logging.INFO):
        Config.print_config()
    assert any("16000" in r.message or "8000" in r.message for r in caplog.records)


def test_print_config_covers_all_sections(caplog):
    """The dump must include every field the reference's print_config prints
    (rtvp/config.py:151-186) AND the extended sections (composite-VAD gating,
    visualization, buffering, threading, persistence, logging) this rebuild
    adds as a strict superset."""
    import logging

    Config.setup_logging()
    with caplog.at_level(logging.INFO):
        Config.print_config()
    dump = "\n".join(r.getMessage() for r in caplog.records)

    # reference-printed fields, as (label fragment, formatted value) pairs
    expected = [
        ("audio format", str(Config.AUDIO_FORMAT)),
        ("channels", str(Config.CHANNELS)),
        ("sample rate", f"{Config.SAMPLE_RATE} Hz"),
        ("chunk size", str(Config.CHUNK_SIZE)),
        ("frame:", f"{Config.FRAME_SIZE} samples"),
        ("hop:", f"{Config.HOP_SIZE} samples"),
        ("window", Config.WINDOW_TYPE),
        ("pre-emphasis", f"{Config.PREEMPHASIS_ALPHA:.2f}"),
        ("MFCC", f"num={Config.NUM_MFCC}"),
        ("MFCC", f"n_fft={Config.MFCC_N_FFT}"),
        ("MFCC", f"mel_filters={Config.MEL_FILTERS}"),
        ("MFCC", f"lifter={Config.MFCC_LIFTER}"),
        ("spectral entropy n_fft", str(Config.SPECTRAL_ENTROPY_N_FFT)),
        ("energy threshold", f"{Config.ENERGY_THRESHOLD:.2f}"),
        ("zcr threshold", f"{Config.ZCR_THRESHOLD:.3f}"),
        ("adaptive VAD", f"history_min={Config.ADAPTIVE_VAD_HISTORY_MIN}"),
        ("adaptive VAD", f"energy_k={Config.ADAPTIVE_VAD_ENERGY_K:.2f}"),
        ("adaptive VAD", f"zcr_k={Config.ADAPTIVE_VAD_ZCR_K:.2f}"),
        # extended sections (superset of the reference dump)
        ("composite VAD", f"use_adaptive={Config.USE_ADAPTIVE_VAD}"),
        ("composite VAD", f"entropy_voice_max={Config.SPECTRAL_ENTROPY_VOICE_MAX:.2f}"),
        ("composite VAD", f"hangover_on={Config.VAD_HANGOVER_ON}"),
        ("composite VAD", f"release_off={Config.VAD_RELEASE_OFF}"),
        ("visualization", f"update={Config.PLOT_UPDATE_INTERVAL}ms"),
        ("visualization", f"max_display_frames={Config.MAX_DISPLAY_FRAMES}"),
        ("visualization", f"waveform_len={Config.WAVEFORM_DISPLAY_LENGTH}"),
        ("buffering", f"audio_buffer={Config.AUDIO_BUFFER_SIZE} chunks"),
        ("buffering", f"processed_buffer={Config.PROCESSED_DATA_BUFFER_SIZE} frames"),
        ("thread sleep", f"{Config.THREAD_SLEEP_TIME:.4f}s"),
        ("save directory", str(Config.SAVE_DIRECTORY)),
        ("log level", str(Config.LOG_LEVEL)),
    ]
    for label, value in expected:
        line = next((ln for ln in dump.splitlines() if label in ln), None)
        assert line is not None, f"print_config missing section: {label}"
        assert value in line, f"{label!r} line missing value {value!r}: {line!r}"


def test_env_cannot_clobber_methods(monkeypatch):
    """The env loader iterates ALL-CAPS data attributes, so an env var aimed
    at a method name must be ignored (the reference's environ-driven loop
    would setattr over the method)."""
    monkeypatch.setenv("RTP_print_config", "payload")
    monkeypatch.setenv("RTP_load_from_yaml", "payload")
    Config.load_from_env("RTP_")
    assert callable(Config.print_config)
    assert callable(Config.load_from_yaml)
    Config.print_config()  # still invocable


def test_matmul_precision_knob():
    """TPU_MATMUL_PRECISION maps through FeatureConfig to a lax.Precision."""
    import jax

    from sspv_tpu.config import Config
    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline

    assert FeatureConfig.from_config(Config).precision == "highest"
    for name, want in [
        ("highest", jax.lax.Precision.HIGHEST),
        ("high", jax.lax.Precision.HIGH),
        ("default", jax.lax.Precision.DEFAULT),
        ("garbage", jax.lax.Precision.HIGHEST),  # unknown -> safe default
    ]:
        assert FeaturePipeline(FeatureConfig(precision=name))._precision == want


def test_view_layout_knob_reaches_pipeline(monkeypatch):
    """RTP_TPU_VIEW_LAYOUT must flow env -> Config -> FeatureConfig (r3
    regression: the attr was missing from Config so the documented knob was
    silently inert)."""
    from sspv_tpu.config import Config
    from sspv_tpu.ops.pipeline import FeatureConfig

    orig = Config.TPU_VIEW_LAYOUT
    try:
        assert FeatureConfig.from_config(Config).view_layout == "hop_phase"
        monkeypatch.setenv("RTP_TPU_VIEW_LAYOUT", "frame_parity")
        Config.load_from_env("RTP_")
        assert Config.TPU_VIEW_LAYOUT == "frame_parity"
        assert FeatureConfig.from_config(Config).view_layout == "frame_parity"
    finally:
        Config.TPU_VIEW_LAYOUT = orig


def test_env_tuple_override(monkeypatch):
    """Tuple-typed attributes (TPU_STREAM_BUCKETS) must parse from env as a
    tuple of the element type — the raw-string assignment used to crash
    FeaturePipeline.stream()."""
    orig = Config.TPU_STREAM_BUCKETS
    try:
        monkeypatch.setenv("RTP_TPU_STREAM_BUCKETS", "64, 512")
        Config.load_from_env("RTP_")
        assert Config.TPU_STREAM_BUCKETS == (64, 512)
        assert all(isinstance(b, int) for b in Config.TPU_STREAM_BUCKETS)
        # garbage keeps the default
        Config.TPU_STREAM_BUCKETS = orig
        monkeypatch.setenv("RTP_TPU_STREAM_BUCKETS", "64,twelve")
        Config.load_from_env("RTP_")
        assert Config.TPU_STREAM_BUCKETS == orig
    finally:
        Config.TPU_STREAM_BUCKETS = orig


def test_env_bool_typo_keeps_default(monkeypatch):
    """An unrecognized bool string ('treu') must warn and keep the default,
    not silently coerce to False."""
    orig = Config.USE_ADAPTIVE_VAD
    try:
        Config.USE_ADAPTIVE_VAD = True
        monkeypatch.setenv("RTP_USE_ADAPTIVE_VAD", "treu")
        Config.load_from_env("RTP_")
        assert Config.USE_ADAPTIVE_VAD is True
        monkeypatch.setenv("RTP_USE_ADAPTIVE_VAD", "off")
        Config.load_from_env("RTP_")
        assert Config.USE_ADAPTIVE_VAD is False
    finally:
        Config.USE_ADAPTIVE_VAD = orig


def test_setup_logging_reapplies_level():
    """A LOG_LEVEL override loaded after the first setup_logging must take
    effect on the second call (basicConfig alone is a no-op then)."""
    import logging

    orig = Config.LOG_LEVEL
    try:
        Config.LOG_LEVEL = "INFO"
        Config.setup_logging()
        Config.LOG_LEVEL = "DEBUG"
        Config.setup_logging()
        assert logging.getLogger().level == logging.DEBUG
    finally:
        Config.LOG_LEVEL = orig
        Config.setup_logging()


def test_yaml_values_are_coerced(tmp_path):
    """YAML overrides must coerce against the attribute's current type like
    load_from_env: a raw string for a float knob warns and keeps the
    default instead of reaching a consumer thread uncoerced."""
    orig = (Config.TPU_MIN_DISPATCH_INTERVAL, Config.TPU_STREAM_BUCKETS,
            Config.USE_ADAPTIVE_VAD, Config.SAMPLE_RATE)
    p = tmp_path / "cfg.yaml"
    p.write_text(
        "TPU_MIN_DISPATCH_INTERVAL: 50ms\n"   # bad -> keep default
        "TPU_STREAM_BUCKETS: '64,512'\n"      # string -> tuple of ints
        "USE_ADAPTIVE_VAD: 'false'\n"         # string bool -> bool
        "SAMPLE_RATE: 8000\n"                 # plain int
    )
    try:
        assert Config.load_from_yaml(str(p)) is True
        assert Config.TPU_MIN_DISPATCH_INTERVAL == orig[0]
        assert Config.TPU_STREAM_BUCKETS == (64, 512)
        assert Config.USE_ADAPTIVE_VAD is False
        assert Config.SAMPLE_RATE == 8000
    finally:
        (Config.TPU_MIN_DISPATCH_INTERVAL, Config.TPU_STREAM_BUCKETS,
         Config.USE_ADAPTIVE_VAD, Config.SAMPLE_RATE) = orig


def test_parse_buckets_shared():
    from sspv_tpu.config import parse_buckets

    assert parse_buckets("64, 512") == (64, 512)
    assert parse_buckets([512, 64]) == (64, 512)
    assert parse_buckets("garbage") == (32, 256, 2048)
    assert parse_buckets(()) == (32, 256, 2048)
