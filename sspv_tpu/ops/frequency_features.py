#!/usr/bin/env python3
"""Frequency-domain features (Mel filterbank, MFCC, spectral entropy) in JAX.

Contracts match the reference (``signal_processing/frequency_features.py``):

- ``mel_filterbank`` — integer-bin triangles with the collision fix (:47-105);
- ``compute_mfcc`` — power spectrum ``|rfft(frames, n_fft)|**2``, filterbank
  matmul clamped at 1e-10, natural log, orthonormal DCT-II truncated to
  ``num_ceps`` (:108-158);
- ``calculate_spectral_entropy`` — normalized PSD clamped at 1e-12, Shannon
  entropy (natural log) normalized by ``log(num_bins)`` into [0, 1] (:161-196).

Implementation notes: the filterbank and DCT are host-precomputed constants
(see ``bases.py``) applied as matmuls with ``Precision.HIGHEST`` so they run
in full float32 (required for the <=1e-5 parity gate; an accelerator's
default float32 matmul may round operands, e.g. TF32 on the GPU). The power
spectrum uses XLA's native rFFT here; the fused pipeline
(``pipeline.py``) uses a windowed DFT matmul pair instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import bases

__all__ = [
    "mel_filterbank",
    "power_spectrum",
    "compute_mfcc",
    "calculate_spectral_entropy",
]

_HIGHEST = jax.lax.Precision.HIGHEST


def mel_filterbank(
    num_filters: int,
    n_fft: int,
    sample_rate: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> jnp.ndarray:
    """Mel filterbank matrix, ``(num_filters, n_fft//2 + 1)`` float32."""
    return jnp.asarray(bases.mel_filterbank_np(num_filters, n_fft, sample_rate, fmin, fmax))


def power_spectrum(frames: jnp.ndarray, n_fft: int) -> jnp.ndarray:
    """``|rfft(frames, n_fft)|**2`` as float32, shape ``(.., n_fft//2+1)``."""
    x = jnp.asarray(frames, dtype=jnp.float32)
    spec = jnp.fft.rfft(x, n=n_fft)
    return (jnp.real(spec) ** 2 + jnp.imag(spec) ** 2).astype(jnp.float32)


def compute_mfcc(
    frames: jnp.ndarray,
    sample_rate: int,
    n_fft: int = 512,
    num_filters: int = 26,
    num_ceps: int = 13,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> jnp.ndarray:
    """MFCC matrix, shape ``(num_frames, num_ceps)`` float32."""
    # A length-N DCT-II has exactly N coefficients: num_ceps > num_filters
    # truncates to num_filters, matching the reference's full-DCT-then-slice
    # (frequency_features.py:157 yields min(num_filters, num_ceps) columns).
    x = jnp.asarray(frames, dtype=jnp.float32)
    if x.size == 0:
        # reference shape parity: the empty early-return keeps the CALLER's
        # num_ceps (the reference clamps only via the DCT slice on the
        # non-empty path, so its empty shape is (0, num_ceps) unclamped)
        return jnp.zeros((0, int(num_ceps)), dtype=jnp.float32)
    num_ceps = min(int(num_ceps), int(num_filters))
    power = power_spectrum(x, n_fft)
    fb = jnp.asarray(
        bases.mel_filterbank_np(num_filters, n_fft, sample_rate, fmin, fmax)
    )
    mel_energy = jnp.maximum(
        jnp.matmul(power, fb.T, precision=_HIGHEST, preferred_element_type=jnp.float32),
        jnp.float32(1e-10),
    )
    log_energy = jnp.log(mel_energy)
    # Orthonormal DCT-II truncated to num_ceps: identical to computing the
    # full DCT and slicing [:, :num_ceps] as the reference does.
    dct_m = jnp.asarray(bases.dct_ortho_matrix(num_filters, num_ceps))
    mfcc = jnp.matmul(
        log_energy, dct_m, precision=_HIGHEST, preferred_element_type=jnp.float32
    )
    return mfcc.astype(jnp.float32)


def calculate_spectral_entropy(frames: jnp.ndarray, n_fft: int = 512) -> jnp.ndarray:
    """Normalized spectral entropy in [0, 1], shape ``(num_frames,)``."""
    x = jnp.asarray(frames, dtype=jnp.float32)
    if x.size == 0:
        return jnp.zeros((0,), dtype=jnp.float32)
    psd = power_spectrum(x, n_fft)
    return entropy_from_power(psd)


def entropy_from_power(psd: jnp.ndarray) -> jnp.ndarray:
    """Shannon entropy of an already-computed power spectrum (shared with the
    fused kernel, which reuses one spectrum for MFCC and entropy)."""
    import numpy as np

    psd_sum = jnp.sum(psd, axis=-1, keepdims=True)
    psd_norm = jnp.where(psd_sum > 0, psd / psd_sum, jnp.float32(0.0))
    psd_norm = jnp.maximum(psd_norm, jnp.float32(1e-12))
    entropy = -jnp.sum(psd_norm * jnp.log(psd_norm), axis=-1)
    max_entropy = jnp.float32(np.log(psd.shape[-1]))
    return (entropy / max_entropy).astype(jnp.float32)
