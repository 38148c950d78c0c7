#!/usr/bin/env python3
"""sspv_tpu — speech signal processing and visualization on JAX/XLA.

A from-scratch JAX/XLA rebuild of the capabilities of
``qingxuandaoming/Speech-Signal-Processing-and-Visualization``: real-time
16 kHz speech capture, per-frame time/frequency features (short-time energy,
ZCR, autocorrelation, AMDF, Mel/MFCC, spectral entropy), fixed + adaptive
voice-activity detection with hangover smoothing, live visualization, and
``.npz`` export — with the compute path redesigned as batched, XLA-fused
device programs (run on an NVIDIA GPU) instead of a per-frame Python loop.

Public top-level surface matches the reference package
(``real_time_voice_processing/__init__.py``): ``Config`` and
``SignalProcessing``.
"""

from .config import Config
from .signal_processing import SignalProcessing

__version__ = "0.1.0"

__all__ = ["Config", "SignalProcessing"]
