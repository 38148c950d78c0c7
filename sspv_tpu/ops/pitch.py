#!/usr/bin/env python3
"""Pitch-period detection from short-time autocorrelation.

The reference exposes the building blocks (autocorrelation + AMDF,
time_features.py:52-104) and its docs describe ACF peak-picking for pitch;
BASELINE.json's config list names "autocorrelation pitch-period detection on
VAD-gated voiced segments" as a benchmark config. This module provides the
batched implementation:

- ``pitch_from_frames``: per-frame F0 via the ACF peak in a plausible lag
  band (default 50..400 Hz), vectorized over all frames at once;
- VAD gating: frames marked unvoiced get F0 = 0;
- an optional normalized-ACF voicing confidence.

All lag arithmetic is static (resolved at trace time).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .precision import resolve as _resolve_precision
from .preprocessing import stream_frames
from .time_features import (
    _acf_dft_bases_merged,
    autocorrelation_via_dft,
    calculate_average_magnitude_difference,
    calculate_short_time_autocorrelation,
)

__all__ = [
    "pitch_from_frames",
    "pitch_from_frames_amdf",
    "pitch_track",
    "pitch_track_amdf",
    "pitch_track_gated",
    "pitch_track_signal",
    "pitch_track_signal_gated",
    "pitch_track_signal_jit",
]


def _lag_band(sample_rate: int, fmin: float, fmax: float,
              frame_size: int) -> tuple[int, int]:
    """Validated ACF lag band for an F0 search in [fmin, fmax].

    Raises ``ValueError`` on an empty band (``fmax`` too low for the frame
    length: e.g. fmax=50 Hz at 16 kHz needs lag 320, but a 320-sample frame
    only has lags up to 319) — without this guard the argmax over a
    zero-width band slice fails at trace time with an opaque error.
    """
    lag_min = max(1, int(sample_rate / fmax))
    lag_max = min(frame_size - 1, int(sample_rate / fmin))
    if lag_min > lag_max:
        raise ValueError(
            f"empty pitch lag band: fmin={fmin}, fmax={fmax} with "
            f"frame_size={frame_size} at {sample_rate} Hz gives lags "
            f"[{lag_min}, {lag_max}]; need fmax > "
            f"{sample_rate / (frame_size - 1):.1f} Hz"
        )
    return lag_min, lag_max


def _band_peak_pick(
    acf: jnp.ndarray, lag_min: int, lag_max: int, sample_rate: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """F0 + confidence from a banded normalized-ACF peak (shared by the
    frames and signal-view paths)."""
    r0 = jnp.maximum(acf[:, 0], jnp.float32(1e-10))
    band = acf[:, lag_min : lag_max + 1] / r0[:, None]
    best = jnp.argmax(band, axis=1)
    confidence = jnp.take_along_axis(band, best[:, None], axis=1)[:, 0]
    lags = (best + lag_min).astype(jnp.float32)
    f0 = jnp.float32(sample_rate) / lags
    return f0.astype(jnp.float32), confidence.astype(jnp.float32)


@functools.partial(
    jax.jit, static_argnames=("sample_rate", "fmin", "fmax", "acf_impl")
)
def pitch_from_frames(
    frames: jnp.ndarray,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
    acf_impl: str = "direct",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame pitch estimate from the autocorrelation peak.

    Parameters
    ----------
    frames : (num_frames, frame_size) float32 (windowed or raw)
    sample_rate : audio sample rate in Hz
    fmin, fmax : F0 search band in Hz
    acf_impl : "direct" (unrolled sliding sums — reference semantics,
        time_features.py:52-76) or "dft" (Wiener-Khinchin matmul form —
        same values to ~1e-6 relative, ~max_lag-fold less memory traffic;
        the large-scale ``pitch_track_signal`` path defaults to it)

    Returns
    -------
    (f0, confidence): both (num_frames,) float32. ``f0`` is the frequency of
    the strongest normalized-ACF peak within [fmin, fmax]; ``confidence`` is
    that peak's normalized ACF value in [0, 1]-ish (can dip below 0 for
    aperiodic frames).
    """
    x = jnp.asarray(frames, dtype=jnp.float32)
    frame_size = x.shape[-1]
    lag_min, lag_max = _lag_band(sample_rate, fmin, fmax, frame_size)
    acf_fn = (
        autocorrelation_via_dft
        if acf_impl == "dft"
        else calculate_short_time_autocorrelation
    )
    acf = acf_fn(x, lag_max)  # (F, lag_max+1)
    return _band_peak_pick(acf, lag_min, lag_max, sample_rate)


@functools.partial(
    jax.jit, static_argnames=("sample_rate", "fmin", "fmax")
)
def pitch_from_frames_amdf(
    frames: jnp.ndarray,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame pitch from the AMDF valley (the ACF peak's dual).

    The reference ships the AMDF op (time_features.py:79-104) and its
    algorithm doc names the AMDF valley at the pitch period as the cue, but
    never wires the valley-pick; this provides it as a second, independent
    estimator (useful as a cross-check on the ACF track — AMDF is less
    fooled by strong formants, ACF less by amplitude modulation).

    Returns ``(f0, confidence)``, both ``(num_frames,)`` float32.
    ``confidence`` is the normalized valley depth
    ``1 - amdf[lag*] / mean(amdf over the band)`` clipped to [0, 1]: ~0 for
    flat AMDF (aperiodic/silence — an all-zero frame yields exactly 0), →1
    for a deep periodic valley. Scale-invariant like the normalized-ACF
    confidence, but the two are NOT numerically comparable gates.
    """
    x = jnp.asarray(frames, dtype=jnp.float32)
    frame_size = x.shape[-1]
    lag_min, lag_max = _lag_band(sample_rate, fmin, fmax, frame_size)
    # Trace only the search band (columns = lags lag_min..lag_max): the
    # below-band lags are never consumed, and each would cost one unrolled
    # slice+abs+mean subgraph (~12 % of the op at the 16 kHz defaults).
    band = calculate_average_magnitude_difference(
        x, lag_max, lag_start=lag_min
    )
    # Earliest valley, not the global argmin: a periodic signal has equally
    # deep valleys at every period MULTIPLE, and for a non-integer period a
    # higher multiple can land nearer an integer lag and measure
    # microscopically deeper — the global argmin then reports a subharmonic
    # (e.g. 220 Hz -> 55 Hz: lag 291 = 4.001 periods beats lag 73 = 1.004).
    # Two steps, both vectorized: (1) the earliest lag within 15 % of the
    # valley-depth range marks the FIRST valley's shoulder; (2) the true
    # bottom is the argmin within one minimal-period window after it (the
    # next valley sits a full fundamental lag >= lag_min further out, so
    # the window cannot reach it).
    vmin = jnp.min(band, axis=1, keepdims=True)
    mean_k = jnp.mean(band, axis=1, keepdims=True)
    thresh = vmin + 0.15 * jnp.maximum(mean_k - vmin, 0.0)
    shoulder = jnp.argmax(band <= thresh, axis=1)
    cols = jnp.arange(band.shape[1])[None, :]
    in_window = (cols >= shoulder[:, None]) & (
        cols < shoulder[:, None] + lag_min
    )
    best = jnp.argmin(jnp.where(in_window, band, jnp.inf), axis=1)
    valley = jnp.take_along_axis(band, best[:, None], axis=1)[:, 0]
    mean_band = mean_k[:, 0]
    # (mean - valley)/mean rather than 1 - valley/mean: algebraically equal
    # for mean > 0, but an all-zero frame (mean = valley = 0) must yield 0,
    # not the 1.0 that 1 - 0/eps would fake.
    conf = (mean_band - valley) / jnp.maximum(mean_band, jnp.float32(1e-10))
    conf = jnp.clip(conf, 0.0, 1.0)
    lags = (best + lag_min).astype(jnp.float32)
    f0 = jnp.float32(sample_rate) / lags
    return f0.astype(jnp.float32), conf.astype(jnp.float32)


def pitch_track_amdf(
    frames,
    vad,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
    min_confidence: float = 0.25,
):
    """VAD-gated AMDF pitch track (F0=0 where unvoiced or the valley is
    shallower than ``min_confidence``); AMDF twin of :func:`pitch_track`."""
    f0, conf = pitch_from_frames_amdf(frames, sample_rate, fmin, fmax)
    gate = (jnp.asarray(vad) > 0) & (
        conf >= jnp.asarray(min_confidence, jnp.float32)
    )
    return jnp.where(gate, f0, 0.0).astype(jnp.float32), conf


def pitch_track_gated(
    frames,
    vad,
    min_confidence,
    *,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
    acf_impl: str = "direct",
):
    """Frames-path :func:`pitch_track` with a TRACED confidence threshold —
    the frames-side twin of :func:`pitch_track_signal_gated` and the single
    gate definition the fused streaming program composes (thresholds never
    multiply the compile count)."""
    f0, conf = pitch_from_frames(frames, sample_rate, fmin, fmax, acf_impl)
    gate = (jnp.asarray(vad) > 0) & (
        conf >= jnp.asarray(min_confidence, jnp.float32)
    )
    return jnp.where(gate, f0, 0.0).astype(jnp.float32), conf


def pitch_track(
    frames,
    vad,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
    min_confidence: float = 0.3,
    acf_impl: str = "direct",
):
    """VAD-gated pitch track: F0 per frame, 0 where unvoiced or where the ACF
    peak is weaker than ``min_confidence``."""
    return pitch_track_gated(
        frames, vad, jnp.float32(min_confidence),
        sample_rate=sample_rate, fmin=fmin, fmax=fmax, acf_impl=acf_impl,
    )


# Frames per lax.scan step on the long-signal pitch path (mirrors
# FeaturePipeline.SCAN_BLOCK_FRAMES). Pitch carries NO cross-frame state,
# so the scan exists purely for memory: unscanned, the DFT/power/banded-ACF
# intermediates materialize (F, 512)+(F, 256)+(F, lag_max+1) f32 in device
# memory — ~5-6 GB for 4 h of audio — while a 32k-frame
# block holds ~150 MB regardless of signal length. Per-frame numerics are
# unchanged (the matmul contraction axis is untouched; blocking only splits
# the row axis).
SCAN_BLOCK_FRAMES = 32768


@functools.partial(
    jax.jit,
    static_argnames=(
        "frame_size", "hop_size", "sample_rate", "fmin", "fmax",
        "min_confidence", "acf_impl", "precision", "scan_block",
    ),
)
def pitch_track_signal(
    signal: jnp.ndarray,
    vad: jnp.ndarray,
    frame_size: int = 320,
    hop_size: int = 160,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
    min_confidence: float = 0.3,
    acf_impl: str = "dft",
    precision: str = "highest",
    scan_block: int = -1,
):
    """VAD-gated pitch track over a whole signal, entirely on device:
    streaming-style framing (full frames only, engine.py:240-242 semantics)
    + banded-ACF peak picking in one compiled program. ``vad`` is the
    per-frame gate from the main pipeline (``FeatureBlock.vad``).

    ``signal`` is either the raw 1-D samples or the host-formed ``(n+1,
    hop)`` signal-view rows (``FeaturePipeline.host_rows_view``) — the
    latter skips the on-device 1-D→2-D relayout on the hop-phase path and
    is bit-identical (the downstream arithmetic reads only row contents).

    This is the scale path (BASELINE.json configs[2]: "autocorrelation
    pitch-period detection on VAD-gated voiced segments"), so the ACF
    defaults to the matmul form.

    ``precision`` (ops/precision.py names) governs the hop-phase
    DFT/inverse matmuls only. The frames-path ``pitch_from_frames`` keeps
    HIGHEST sums.

    ``scan_block``: frames per ``lax.scan`` step on the hop-phase path.
    ``-1`` (default) uses ``SCAN_BLOCK_FRAMES``; ``0`` disables blocking
    (one unscanned program — the pre-scan behavior). Signals at or under
    one block compile the direct form either way, so short/streaming
    callers never pay scan overhead.
    """
    x = jnp.asarray(signal, dtype=jnp.float32)
    rows_in = None
    if x.ndim == 2:
        # (n+1, hop) signal-view rows formed on the HOST (a free reshape of
        # the contiguous 1-D signal). Uploading this layout directly lets the
        # device program start from the 2-D layout — the 1-D signal
        # otherwise pays an on-device relayout copy. Only the hop-phase DFT
        # path consumes rows; any other configuration flattens
        # back (a device-side reshape — the rare path).
        if (
            acf_impl == "dft"
            and frame_size == 2 * hop_size
            and int(x.shape[1]) == hop_size
        ):
            rows_in = x
        else:
            x = x.reshape(-1)
    if rows_in is not None:
        n = int(rows_in.shape[0]) - 1
        if n < 1:
            z = jnp.zeros((0,), jnp.float32)
            return z, z
    else:
        length = int(x.shape[0])
        if length < frame_size:
            z = jnp.zeros((0,), jnp.float32)
            return z, z
        n = 1 + (length - frame_size) // hop_size
    if acf_impl == "dft" and frame_size == 2 * hop_size:
        # Hop-phase fast path (50%-overlap geometry, same trick as the main
        # pipeline's signal-view spectrum): frame i = concat(rows[i],
        # rows[i+1]) of the (n+1, hop) signal view, so the frame-side DFT
        # matmuls split into top/bottom-half matmuls against the basis —
        # the (F, frame_size) frame matrix (2x-duplicated samples; ~0.5 GB
        # for an hour of audio) is never materialized.
        hop = hop_size
        lag_min, lag_max = _lag_band(sample_rate, fmin, fmax, frame_size)
        merged, nyq_b, inv_live, inv_nyq = _acf_dft_bases_merged(
            frame_size, lag_max
        )
        hp = _resolve_precision(precision)

        def from_rows(rows_blk):
            """(f+1, hop) signal-view rows -> ungated (f0, conf), (f,)."""
            half = merged.shape[1] // 2
            top, bot = rows_blk[:-1], rows_blk[1:]
            m = jnp.matmul(top, jnp.asarray(merged[:hop]), precision=hp,
                           preferred_element_type=jnp.float32) + jnp.matmul(
                bot, jnp.asarray(merged[hop:]), precision=hp,
                preferred_element_type=jnp.float32)
            nyq = jnp.matmul(top, jnp.asarray(nyq_b[:hop]), precision=hp,
                             preferred_element_type=jnp.float32) + jnp.matmul(
                bot, jnp.asarray(nyq_b[hop:]), precision=hp,
                preferred_element_type=jnp.float32)
            power = m[:, :half] * m[:, :half] + m[:, half:] * m[:, half:]
            acf = jnp.matmul(power, jnp.asarray(inv_live), precision=hp,
                             preferred_element_type=jnp.float32) + (
                nyq * nyq
            )[:, None] * jnp.asarray(inv_nyq)[None, :]
            return _band_peak_pick(acf, lag_min, lag_max, sample_rate)

        rows = (
            rows_in
            if rows_in is not None
            else x[: (n + 1) * hop].reshape(n + 1, hop)
        )
        b = SCAN_BLOCK_FRAMES if scan_block < 0 else int(scan_block)
        # The scan exists purely to bound the materialized (F, n_fft) /
        # (F, lags) intermediates (see SCAN_BLOCK_FRAMES).
        if b and n > b:
            # Block the row axis with one-row overlap (frame i spans rows
            # i and i+1), exactly like _process_signal_view_impl; frames
            # past n land in the padded tail and are sliced off below.
            nb = -(-n // b)
            pad_rows = nb * b + 1 - (n + 1)
            if pad_rows:
                rows = jnp.pad(rows, ((0, pad_rows), (0, 0)))
            starts = jnp.arange(nb, dtype=jnp.int32) * b

            def step(carry, start):
                rb = jax.lax.dynamic_slice(rows, (start, 0), (b + 1, hop))
                return carry, from_rows(rb)

            _, (f0b, confb) = jax.lax.scan(step, 0, starts)
            f0 = f0b.reshape(nb * b)[:n]
            conf = confb.reshape(nb * b)[:n]
        else:
            f0, conf = from_rows(rows)
        gate = (jnp.asarray(vad) > 0) & (conf >= jnp.float32(min_confidence))
        return jnp.where(gate, f0, 0.0).astype(jnp.float32), conf
    frames = stream_frames(x, frame_size, hop_size)
    return pitch_track(
        frames, vad, sample_rate, fmin, fmax, min_confidence, acf_impl
    )


def pitch_track_signal_jit(
    frame_size: int = 320,
    hop_size: int = 160,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
    acf_impl: str = "dft",
    precision: str = "highest",
):
    """Jitted ``(signal, vad, min_confidence) -> (f0, confidence)`` for these
    static parameters, cached so repeated callers (the HTTP serving layer,
    the batch CLI) share one callable — jit then caches executables per
    input *shape*, so bucket-padded signals compile a bounded set of
    programs.

    ``min_confidence`` is a TRACED argument (it only gates the output
    comparison, not the lag-band geometry), so confidence thresholds never
    multiply the compile count — important for the serving layer, where the
    threshold is client-controlled and each extra static value would cost a
    compile.
    """
    # normalize the key here so call-spelling differences (kwargs vs
    # defaults omitted) cannot create duplicate jitted callables.
    return _pitch_jit_cached(
        int(frame_size), int(hop_size), int(sample_rate),
        float(fmin), float(fmax), str(acf_impl), str(precision),
    )


def pitch_track_signal_gated(
    signal,
    vad,
    min_confidence,
    *,
    frame_size: int = 320,
    hop_size: int = 160,
    sample_rate: int = 16000,
    fmin: float = 50.0,
    fmax: float = 400.0,
    acf_impl: str = "dft",
    precision: str = "highest",
):
    """Traceable ``pitch_track_signal`` with a TRACED confidence threshold.

    The inner track runs at ``min_confidence=-inf`` ("vad gate only"); the
    OUTER traced comparison is then the sole confidence gate, preserving
    exact semantics for ANY traced threshold (including negative ones that
    keep aperiodic frames whose normalized ACF dips below 0 — an inner 0.0
    would have zeroed those irrecoverably). Because the threshold is traced,
    it never multiplies the compile count — important wherever it is
    client-controlled (serving) and a static value would cost a compile.
    This is THE shared gate definition: every fused program
    (`FeaturePipeline.process_signal_pitch_auto`,
    `BatchPipeline.process_batch_masked_pitch`) and the jitted two-call
    wrapper below compose it, so the bit-identity contract between them
    (CLAUDE.md) has a single point of truth.
    """
    f0, conf = pitch_track_signal(
        signal, vad,
        frame_size=frame_size, hop_size=hop_size,
        sample_rate=sample_rate, fmin=fmin, fmax=fmax,
        min_confidence=float("-inf"), acf_impl=acf_impl,
        precision=precision,
    )
    gate = (jnp.asarray(vad) > 0) & (
        conf >= jnp.asarray(min_confidence, jnp.float32)
    )
    return jnp.where(gate, f0, 0.0).astype(jnp.float32), conf


@functools.lru_cache(maxsize=256)  # serve's band grid alone permits 153
# pairs — sized so a full sweep cannot thrash
def _pitch_jit_cached(
    frame_size: int, hop_size: int, sample_rate: int,
    fmin: float, fmax: float, acf_impl: str, precision: str,
):
    def impl(signal, vad, min_confidence):
        return pitch_track_signal_gated(
            signal, vad, min_confidence,
            frame_size=frame_size, hop_size=hop_size,
            sample_rate=sample_rate, fmin=fmin, fmax=fmax,
            acf_impl=acf_impl, precision=precision,
        )

    return jax.jit(impl)
