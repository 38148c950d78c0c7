#!/usr/bin/env python3
"""Pre-emphasis and framing/windowing as batched JAX ops.

Behavioral contract (matching the reference, ``signal_processing/
preprocessing.py:14-92``):

- ``preemphasis(x, alpha)`` = ``concat([x[0], x[1:] - alpha*x[:-1]])``, float32.
- ``framing(x, frame_size, hop_size, window_type)`` produces
  ``(num_frames, frame_size)`` float32 windowed frames where
  ``num_frames = 1 + ceil((len - frame_size)/hop_size)`` with zero padding of
  the tail, and an empty ``(0, frame_size)`` result for degenerate input.

Implementation notes: all shape arithmetic is static (resolved at trace time). Framing
avoids a general gather when ``frame_size % hop_size == 0`` by slicing
``frame_size//hop_size`` shifted views of a ``(num_hops, hop)`` reshape and
concatenating — XLA turns that into cheap strided copies instead of a gather.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from .windows import get_window

__all__ = [
    "preemphasis",
    "num_frames_for",
    "frame_signal",
    "stream_frames",
    "framing",
]


def preemphasis(signal: jnp.ndarray, alpha: float = 0.97) -> jnp.ndarray:
    """First-order high-pass pre-emphasis filter."""
    x = jnp.asarray(signal, dtype=jnp.float32)
    if x.shape[-1] == 0:
        return x
    first = x[..., :1]
    rest = x[..., 1:] - jnp.float32(alpha) * x[..., :-1]
    return jnp.concatenate([first, rest], axis=-1).astype(jnp.float32)


def num_frames_for(signal_length: int, frame_size: int, hop_size: int) -> int:
    """The reference frame-count formula ``1 + ceil((L - N)/H)`` (clamped at 0),
    preprocessing.py:74."""
    if frame_size <= 0 or hop_size <= 0 or signal_length == 0:
        return 0
    return max(0, 1 + math.ceil((signal_length - frame_size) / hop_size))


def frame_signal(signal: jnp.ndarray, frame_size: int, hop_size: int) -> jnp.ndarray:
    """Slice a 1-D signal into overlapping zero-padded frames (no window).

    Returns ``(num_frames, frame_size)`` float32.
    """
    x = jnp.asarray(signal, dtype=jnp.float32)
    length = int(x.shape[0])
    n = num_frames_for(length, frame_size, hop_size)
    if n <= 0:
        return jnp.zeros((0, max(frame_size, 0)), dtype=jnp.float32)

    pad_length = (n - 1) * hop_size + frame_size
    if pad_length > length:
        x = jnp.pad(x, (0, pad_length - length))

    if frame_size % hop_size == 0:
        # Strided fast path: view the signal as (num_hops, hop) rows; frame i
        # is rows i..i+k-1 concatenated, so k shifted slices cover everything.
        k = frame_size // hop_size
        total_hops = n - 1 + k
        # rows_needed == (n-1)*hop + frame_size == pad_length identically
        # when frame_size % hop_size == 0 (same identity stream_frames
        # documents), so x already has exactly this many samples
        rows_needed = total_hops * hop_size
        rows = x[: rows_needed].reshape(total_hops, hop_size)
        parts = [rows[i : i + n] for i in range(k)]
        return jnp.concatenate(parts, axis=1)

    # General path: one gather with a static index matrix.
    idx = (
        np.tile(np.arange(frame_size), (n, 1))
        + np.arange(0, n * hop_size, hop_size)[:, None]
    ).astype(np.int32)
    return x[jnp.asarray(idx)]


def stream_frames(
    signal: jnp.ndarray, frame_size: int, hop_size: int
) -> jnp.ndarray:
    """Streaming-style framing: only FULL frames, no tail zero-padding
    (the live engine's rule, reference engine.py:240-242 — distinct from
    ``frame_signal``'s padded batch contract, preprocessing.py:75-76).

    Uses the strided-reshape fast path when ``frame_size % hop_size == 0``
    (XLA emits copies, not a gather); shared by the pipeline's on-device
    streaming path and the signal-level pitch tracker.

    Returns ``(num_full_frames, frame_size)`` float32.
    """
    x = jnp.asarray(signal, dtype=jnp.float32)
    length = int(x.shape[0])
    if length < frame_size or frame_size <= 0 or hop_size <= 0:
        return jnp.zeros((0, max(frame_size, 0)), dtype=jnp.float32)
    n = 1 + (length - frame_size) // hop_size
    if frame_size % hop_size == 0:
        # frame i = rows i..i+k-1 of the (hops, hop) view; by construction
        # of n, (n-1+k)*hop = (n-1)*hop + frame_size <= length.
        k = frame_size // hop_size
        rows = x[: (n - 1 + k) * hop_size].reshape(n - 1 + k, hop_size)
        return jnp.concatenate([rows[i : i + n] for i in range(k)], axis=1)
    idx = (
        np.arange(frame_size)[None, :]
        + np.arange(n)[:, None] * hop_size
    ).astype(np.int32)
    return x[jnp.asarray(idx)]


def framing(
    signal: jnp.ndarray,
    frame_size: int,
    hop_size: int,
    window_type: str = "hamming",
) -> jnp.ndarray:
    """Frame and window a 1-D signal; see module docstring for the contract."""
    frames = frame_signal(signal, frame_size, hop_size)
    if frames.shape[0] == 0:
        return frames
    window = jnp.asarray(get_window(window_type, frame_size))
    return (frames * window).astype(jnp.float32)
