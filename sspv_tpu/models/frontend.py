#!/usr/bin/env python3
"""Configured, composable speech-frontend transforms (jit-friendly).

Design: every transform captures its configuration and host-precomputed
constants at construction and exposes

- ``__call__(frames)``: batched frames -> features (pure, traceable), and
- ``from_signal(signal)``: 1-D audio -> features (framing included).

Numerics are identical to the functional ops layer (``sspv_tpu.ops``), so
transform outputs inherit the parity guarantees; the transforms are sugar,
not a parallel implementation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bases
from ..ops.frequency_features import entropy_from_power
from ..ops.pitch import _lag_band, pitch_from_frames, pitch_from_frames_amdf
from ..ops.preprocessing import frame_signal
from ..ops.windows import get_window

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

_HIGHEST = jax.lax.Precision.HIGHEST


def _energy_zcr(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Short-time energy and zero-crossing rate of windowed frames — the one
    definition shared by VADModel and SpeechFrontend (reference semantics:
    no /2 on the sign-diff count, divide by frame length)."""
    energy = jnp.sum(x * x, axis=-1)
    signs = jnp.sign(x)
    zcr = (
        jnp.sum(jnp.abs(jnp.diff(signs, axis=-1)) > 0, axis=-1)
        / jnp.float32(x.shape[-1])
    )
    return energy, zcr


class FrameTransform:
    """Base: framing geometry + window shared by all transforms."""

    def __init__(
        self,
        sample_rate: int = 16000,
        frame_size: int = 320,
        hop_size: int = 160,
        window_type: str = "hamming",
    ):
        self.sample_rate = int(sample_rate)
        self.frame_size = int(frame_size)
        self.hop_size = int(hop_size)
        self.window_type = str(window_type)
        self.window = get_window(window_type, frame_size)

    def frames_of(self, signal) -> jnp.ndarray:
        """Window-applied frames of a 1-D signal (zero-padded tail)."""
        raw = frame_signal(
            jnp.asarray(signal, jnp.float32), self.frame_size, self.hop_size
        )
        return raw * jnp.asarray(self.window)

    def from_signal(self, signal):
        return self(self.frames_of(signal))

    def __call__(self, frames):  # pragma: no cover - abstract
        raise NotImplementedError


class Spectrogram(FrameTransform):
    """Windowed power spectrogram via the DFT-matmul pair."""

    def __init__(self, n_fft: int = 512, **kw):
        super().__init__(**kw)
        self.n_fft = int(n_fft)
        # window NOT folded in: __call__ receives already-windowed frames
        self._cos, self._sin = bases.dft_bases(self.frame_size, self.n_fft)

    def __call__(self, frames) -> jnp.ndarray:
        x = jnp.asarray(frames, jnp.float32)
        re = jnp.matmul(x, jnp.asarray(self._cos), precision=_HIGHEST,
                        preferred_element_type=jnp.float32)
        im = jnp.matmul(x, jnp.asarray(self._sin), precision=_HIGHEST,
                        preferred_element_type=jnp.float32)
        return re * re + im * im


class MelSpectrogram(Spectrogram):
    """Log-mel energies: power spectrogram -> mel filterbank -> log."""

    def __init__(self, num_filters: int = 26, fmin: float = 0.0,
                 fmax: float | None = None, log: bool = True, **kw):
        super().__init__(**kw)
        self.num_filters = int(num_filters)
        self.log = bool(log)
        self._fb_t = bases.mel_filterbank_np(
            num_filters, self.n_fft, self.sample_rate, fmin, fmax
        ).T.copy()

    def _mel_of(self, power) -> jnp.ndarray:
        """Clamped mel energies of a power spectrogram (pre-log)."""
        return jnp.maximum(
            jnp.matmul(power, jnp.asarray(self._fb_t), precision=_HIGHEST,
                       preferred_element_type=jnp.float32),
            jnp.float32(1e-10),
        )

    def __call__(self, frames) -> jnp.ndarray:
        mel = self._mel_of(Spectrogram.__call__(self, frames))
        return jnp.log(mel) if self.log else mel


class MFCC(MelSpectrogram):
    """MFCCs: log-mel -> orthonormal DCT-II -> optional lifter."""

    def __init__(self, num_ceps: int = 13, lifter: int | None = 22, **kw):
        super().__init__(log=True, **kw)
        self.num_ceps = int(num_ceps)
        self._dct = bases.dct_ortho_matrix(self.num_filters, num_ceps)
        self._lifter = bases.lifter_vector(num_ceps, lifter)

    def _mfcc_of(self, log_mel) -> jnp.ndarray:
        """Liftered DCT of log-mel energies."""
        mfcc = jnp.matmul(log_mel, jnp.asarray(self._dct), precision=_HIGHEST,
                          preferred_element_type=jnp.float32)
        return mfcc * jnp.asarray(self._lifter)

    def __call__(self, frames) -> jnp.ndarray:
        return self._mfcc_of(super().__call__(frames))


class SpectralEntropy(Spectrogram):
    """Normalized Shannon entropy of the power spectrum, in [0, 1]."""

    def __call__(self, frames) -> jnp.ndarray:
        return entropy_from_power(super().__call__(frames))


class VADModel(FrameTransform):
    """Fixed dual-threshold VAD over energy/ZCR of windowed frames."""

    def __init__(self, energy_threshold: float = 1000.0,
                 zcr_threshold: float = 0.3, **kw):
        super().__init__(**kw)
        self.energy_threshold = float(energy_threshold)
        self.zcr_threshold = float(zcr_threshold)

    def __call__(self, frames) -> jnp.ndarray:
        energy, zcr = _energy_zcr(jnp.asarray(frames, jnp.float32))
        return (energy > self.energy_threshold) & (zcr < self.zcr_threshold)


class SpeechFrontend(FrameTransform):
    """The full bundle: one call returning a feature dict, sharing a single
    spectrum across MFCC and entropy (what the fused pipeline computes)."""

    def __init__(self, n_fft: int = 512, num_filters: int = 26,
                 num_ceps: int = 13, lifter: int | None = 22, **kw):
        super().__init__(**kw)
        self._mfcc = MFCC(
            n_fft=n_fft, num_filters=num_filters, num_ceps=num_ceps,
            lifter=lifter, sample_rate=self.sample_rate,
            frame_size=self.frame_size, hop_size=self.hop_size,
            window_type=self.window_type,
        )
        self._spec = self._mfcc  # shares bases via MRO chain

    def __call__(self, frames) -> dict:
        x = jnp.asarray(frames, jnp.float32)
        energy, zcr = _energy_zcr(x)
        # one spectrum shared by MFCC and entropy (the fused-pipeline trick),
        # with the mel/DCT/lifter math delegated to the MFCC transform so the
        # numerics have exactly one definition.
        power = Spectrogram.__call__(self._mfcc, x)
        mfcc = self._mfcc._mfcc_of(jnp.log(self._mfcc._mel_of(power)))
        return {
            "energy": energy,
            "zcr": zcr,
            "mfcc": mfcc,
            "entropy": entropy_from_power(power),
        }


class Pitch(FrameTransform):
    """Configured F0 estimator over frames: ``method="acf"`` (normalized-ACF
    peak — the pipeline's scale path semantics) or ``"amdf"``
    (earliest-valley AMDF dual; independent cross-check estimator).

    Pitch operates on RAW frames (the pipeline's pitch path frames the
    signal without a window — ops/pitch.py), so ``frames_of`` here does NOT
    apply the analysis window, unlike the spectral transforms.
    """

    def __init__(self, fmin: float = 50.0, fmax: float = 400.0,
                 method: str = "acf", **kw):
        super().__init__(**kw)
        if method not in ("acf", "amdf"):
            raise ValueError(f"unknown pitch method {method!r}")
        self.fmin = float(fmin)
        self.fmax = float(fmax)
        self.method = method
        # validate the lag band at construction, not first call
        _lag_band(self.sample_rate, self.fmin, self.fmax, self.frame_size)

    def frames_of(self, signal) -> jnp.ndarray:
        return frame_signal(
            jnp.asarray(signal, jnp.float32), self.frame_size, self.hop_size
        )

    def __call__(self, frames) -> tuple[jnp.ndarray, jnp.ndarray]:
        if self.method == "amdf":
            return pitch_from_frames_amdf(
                frames, self.sample_rate, self.fmin, self.fmax
            )
        return pitch_from_frames(
            frames, self.sample_rate, self.fmin, self.fmax
        )
