#!/usr/bin/env python3
"""Composable frontend transform models.

The reference exposes features only as free functions; production pipelines
want configured, composable, jit-friendly transform objects (in the spirit of
torchaudio's transforms, built for batched device execution). Each model is a callable that maps
``(num_frames, frame_size)`` float32 frames (or a raw 1-D signal for the
``from_signal`` variants) to feature arrays, with all constants precomputed
at construction.
"""

from .frontend import (
    FrameTransform,
    Spectrogram,
    MelSpectrogram,
    MFCC,
    SpectralEntropy,
    VADModel,
    SpeechFrontend,
    Pitch,
)

__all__ = [
    "FrameTransform",
    "Spectrogram",
    "MelSpectrogram",
    "MFCC",
    "SpectralEntropy",
    "VADModel",
    "SpeechFrontend",
    "Pitch",
]
