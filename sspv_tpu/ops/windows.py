#!/usr/bin/env python3
"""Window functions.

Symmetric (denominator ``N-1``) Hamming / Hann / rectangular windows, float32,
peak ~= 1, empty array for non-positive lengths — matching the reference
semantics (``signal_processing/windows.py:16-74``).

Windows are pure host-side constants: they are generated once in NumPy and
closed over by jitted device functions, exactly like the reference
precomputes its window once at engine construction (engine.py:83). There is
nothing to gain from computing a 320-float cosine on the device.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "hamming_window",
    "hanning_window",
    "rectangular_window",
    "get_window",
]


@functools.lru_cache(maxsize=64)
def _hamming_cached(length: int) -> np.ndarray:
    n = np.arange(length)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / (length - 1))).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _hanning_cached(length: int) -> np.ndarray:
    n = np.arange(length)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / (length - 1)))).astype(np.float32)


def hamming_window(length: int) -> np.ndarray:
    """Symmetric Hamming window: ``0.54 - 0.46*cos(2*pi*n/(N-1))``."""
    if length <= 0:
        return np.array([], dtype=np.float32)
    if length == 1:
        return np.ones(1, dtype=np.float32)
    return _hamming_cached(int(length)).copy()


def hanning_window(length: int) -> np.ndarray:
    """Symmetric Hann window: ``0.5*(1 - cos(2*pi*n/(N-1)))``."""
    if length <= 0:
        return np.array([], dtype=np.float32)
    if length == 1:
        return np.ones(1, dtype=np.float32)
    return _hanning_cached(int(length)).copy()


def rectangular_window(length: int) -> np.ndarray:
    """All-ones window."""
    if length <= 0:
        return np.array([], dtype=np.float32)
    return np.ones(length, dtype=np.float32)


def get_window(window_type: str, length: int) -> np.ndarray:
    """Window by name; unknown names fall back to rectangular, matching the
    reference's framing dispatch (preprocessing.py:85-90)."""
    if window_type == "hamming":
        return hamming_window(length)
    if window_type == "hanning":
        return hanning_window(length)
    return rectangular_window(length)
