#!/usr/bin/env python3
"""Batched, jit-friendly signal-processing ops (the device compute layer).

Submodules mirror the reference's ``signal_processing`` package function
-for-function, but operate on JAX arrays, are batched by construction, and
feed the fused pipeline in ``pipeline.py``.
"""

from .windows import hamming_window, hanning_window, rectangular_window, get_window
from .preprocessing import preemphasis, framing, frame_signal, num_frames_for
from .time_features import (
    calculate_short_time_energy,
    calculate_zero_crossing_rate,
    calculate_short_time_autocorrelation,
    calculate_average_magnitude_difference,
)
from .frequency_features import (
    mel_filterbank,
    power_spectrum,
    compute_mfcc,
    calculate_spectral_entropy,
)
from .vad import (
    voice_activity_detection,
    adaptive_voice_activity_detection,
    streaming_vad,
    hangover_smooth,
    hangover_smooth_scan,
    VadState,
    initial_vad_state,
)
from .pipeline import FeatureConfig, FeatureBlock, FeaturePipeline
from .resample import (
    resample_output_len,
    resample_poly_device,
    resample_batch_device,
    resample_to_rate_device,
)
from .pitch import (
    pitch_from_frames,
    pitch_from_frames_amdf,
    pitch_track_amdf,
    pitch_track,
    pitch_track_gated,
    pitch_track_signal,
    pitch_track_signal_gated,
    pitch_track_signal_jit,
)

__all__ = [
    "hamming_window",
    "hanning_window",
    "rectangular_window",
    "get_window",
    "preemphasis",
    "framing",
    "frame_signal",
    "num_frames_for",
    "calculate_short_time_energy",
    "calculate_zero_crossing_rate",
    "calculate_short_time_autocorrelation",
    "calculate_average_magnitude_difference",
    "mel_filterbank",
    "power_spectrum",
    "compute_mfcc",
    "calculate_spectral_entropy",
    "voice_activity_detection",
    "adaptive_voice_activity_detection",
    "streaming_vad",
    "hangover_smooth",
    "hangover_smooth_scan",
    "VadState",
    "initial_vad_state",
    "FeatureConfig",
    "FeatureBlock",
    "FeaturePipeline",
    "pitch_from_frames",
    "pitch_from_frames_amdf",
    "pitch_track",
    "pitch_track_amdf",
    "pitch_track_gated",
    "pitch_track_signal",
    "pitch_track_signal_gated",
    "pitch_track_signal_jit",
    "resample_output_len",
    "resample_poly_device",
    "resample_batch_device",
    "resample_to_rate_device",
]
