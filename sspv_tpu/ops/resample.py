#!/usr/bin/env python3
"""On-device polyphase resampling with ``scipy.signal.resample_poly`` parity.

The reference resamples host-side through SciPy when a file's rate differs
from the pipeline rate (``rtvp/runtime/audio_source.py:285-298``:
``resample_poly(x.astype(float32), up, down)`` then an int16 clip). That is
fine for one mic stream, but for batch corpus processing every file pays a
host FIR pass before the signal ever reaches the device. This module moves
the same computation onto the device as K shifted row-view matmuls (no
gather — see ``_core`` for why the gather formulation was abandoned):

- filter design IS ``scipy.signal.firwin(2*10*max(up,down)+1,
  1/max(up,down), window=("kaiser", 5.0))`` (called host-side, once per
  rate pair), cast to float32 and scaled by ``up`` exactly as
  ``resample_poly`` does for float32 inputs;
- alignment replicates ``resample_poly``'s zero-pre-pad / ``n_pre_remove``
  slicing, so output length is ``ceil(n_in * up / down)`` and outputs are
  sample-aligned with SciPy's (zero signal-extension semantics — identical
  to ``padtype="constant", cval=0``);
- the polyphase sum is regrouped so each run of ``up`` consecutive output
  samples shares one ``W``-wide input window; with the padding aligned so
  windows start on ``down``-sample boundaries, ``reshape(-1, down)`` turns
  every window into ``K = ceil(W/down)`` consecutive rows and the banded
  ``(W, up)`` weight matrix splits into K ``(down, up)`` chunks — the whole
  resample becomes K plain matmuls on shifted contiguous views (see
  ``_core`` for why not a gather).

Output groups are processed in ``row_block``-sized chunks under
``lax.scan`` so slice traffic per step stays bounded, keeping HBM use flat
for hour-long signals (the same blocking idea as the pipeline's
``SCAN_BLOCK_FRAMES``).

Parity evidence: ``tests/test_resample.py`` gates the float path against
SciPy per-sample (atol 0.05 on int16-scale data, NMSE <= 1e-10) across rate
pairs including 8 kHz/22.05 kHz/44.1 kHz/48 kHz <-> 16 kHz, and the int16
wrapper against ``runtime.audio_source._resample_to`` (>= 99.9 % bit-equal,
max one LSB — float32 summation-order ties at the truncation boundary).
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = [
    "resample_output_len",
    "resample_poly_device",
    "resample_batch_device",
    "resample_to_rate_device",
]

# Smallest pad-to length for the bucketed int16 wrapper (~1 s at 16 kHz).
_BUCKET_MIN = 1 << 14


def _bucket_len(n: int) -> int:
    """Quantize a signal length up to the {2^k, 1.5*2^k} grid (min 2^14).

    ``jax.jit`` caches one executable per input *shape* — so resampling a
    corpus of arbitrary-length files at exact shapes would pay a fresh
    compile per distinct length. Padding up to this
    grid bounds the program count per (up, down) pair to ~2 per octave
    (<= 32 across 1 s..24 h) at < 50 % wasted samples, and zero padding is
    exactly SciPy's constant-zero signal extension, so the first
    ``resample_output_len(true_n, up, down)`` outputs are bit-identical to
    the unpadded resample (tests pin this).
    """
    if n <= _BUCKET_MIN:
        return _BUCKET_MIN
    k = (n - 1).bit_length()  # 2^(k-1) < n <= 2^k
    half = 3 << (k - 2)  # 1.5 * 2^(k-1); k >= 15 here
    return half if n <= half else (1 << k)


@functools.lru_cache(maxsize=None)
def _polyphase_kernel(up: int, down: int) -> tuple[np.ndarray, int, int]:
    """Banded weight matrix + alignment constants for coprime ``up/down``.

    Returns ``(M, s_lo, n_pre_remove)`` where output sample
    ``m = a*up + r`` (for ``m >= n_pre_remove``) is
    ``sum_t x[a*down + s_lo + t] * M[t, r]`` with zero signal extension.
    ``M`` encodes ``resample_poly``'s pre-padded filter
    ``hp = [zeros(n_pre_pad), h]`` sampled at ``hp[r*down - s*up]``.

    The filter comes from ``scipy.signal.firwin`` itself (the host fallback
    one call up, ``runtime.audio_source._resample_to``, already depends on
    ``scipy.signal``) — exactly the taps ``resample_poly`` designs — so the
    device path cannot drift from the host path it claims parity with.
    Host-side, runs once per (up, down) and is cached.
    """
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(
        2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0)
    ).astype(np.float32)
    h = h * np.float32(up)  # resample_poly: h *= up, after the f32 cast
    n_pre_pad = down - (half_len % down)
    n_pre_remove = (half_len + n_pre_pad) // down
    hp_len = n_pre_pad + h.shape[0]
    s_lo = -((hp_len - 1) // up)
    s_hi = ((up - 1) * down) // up
    width = s_hi - s_lo + 1

    t_idx = np.arange(width)[:, None]  # (W, 1)
    r_idx = np.arange(up)[None, :]  # (1, up)
    hp_idx = r_idx * down - (s_lo + t_idx) * up  # (W, up)
    valid = (hp_idx >= n_pre_pad) & (hp_idx < hp_len)
    weights = np.zeros((width, up), dtype=np.float32)
    weights[valid] = h[hp_idx[valid] - n_pre_pad]
    return weights, s_lo, n_pre_remove


def resample_output_len(n_in: int, up: int, down: int) -> int:
    """``resample_poly`` output length: ``ceil(n_in * up / down)`` (after
    gcd reduction)."""
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    return -(-n_in * up // down)


def _core(signal, weights, *, up, down, s_lo, n_pre_remove, row_block,
          precision):
    """Jit-traced resampler body: pad → K shifted row-view matmuls.

    The naive lowering — gather each output group's ``W``-wide window into
    an ``(A, W)`` matrix — compiles to an XLA dynamic gather that moves W
    copies of every sample. Instead, pad the signal so the window start is a
    multiple of ``down``; then ``reshape(-1, down)`` makes every window
    exactly ``K = ceil(W/down)`` consecutive rows, and the banded matmul
    decomposes into K plain matmuls on SHIFTED CONTIGUOUS VIEWS:

        y[a] = sum_k  X3[a + q + k] @ M[k*down : (k+1)*down]

    No gather, no sample duplication in device memory — each term is a
    strided view feeding a matmul directly. K is small (2 for 44.1 kHz→16 kHz, 22 for
    48 kHz→16 kHz), and XLA fuses the accumulation.

    ``signal`` is 1-D (any real dtype; cast to f32 like ``_resample_to``
    does before calling SciPy). All shape arithmetic is static. Groups of
    ``up`` outputs are scan-blocked (``row_block`` rows per step, 0 = auto
    by bytes) so device memory stays flat on hour-long signals.
    """
    import jax.numpy as jnp
    from jax import lax

    n_in = signal.shape[0]
    n_out = -(-n_in * up // down)
    width = weights.shape[0]
    # Total output groups of `up` samples covering [0, n_pre_remove + n_out).
    groups = -(-(n_pre_remove + n_out) // up)
    if row_block <= 0:
        # Auto: bound each scan step's slice traffic to ~4M f32 (16 MB).
        row_block = max(8192, (1 << 22) // max(down, 1))
    block = max(1, min(row_block, groups))
    groups_pad = -(-groups // block) * block
    n_steps = groups_pad // block

    # Align the first window start to a row boundary: pre-pad so
    # (s_lo + pre) is a non-negative multiple of `down`.
    pre0 = max(0, -s_lo)
    pre = pre0 + ((-(s_lo + pre0)) % down)
    q = (s_lo + pre) // down
    k_terms = -(-width // down)
    rows_total = groups_pad + q + k_terms
    post = rows_total * down - pre - n_in
    padded = jnp.pad(signal.astype(jnp.float32), (pre, post))
    x3 = padded.reshape(rows_total, down)
    # Pad the banded weights to K full (down, up) chunks.
    w_pad = jnp.pad(weights, ((0, k_terms * down - width), (0, 0)))

    def one_block(base_row):
        acc = jnp.zeros((block, up), jnp.float32)
        for k in range(k_terms):
            seg = lax.dynamic_slice(x3, (base_row + q + k, 0), (block, down))
            acc = acc + jnp.matmul(
                seg, w_pad[k * down : (k + 1) * down], precision=precision
            )
        return acc

    if n_steps == 1:
        out = one_block(jnp.int32(0))
    else:
        bases = jnp.arange(n_steps, dtype=jnp.int32) * block
        _, blocks = lax.scan(
            lambda carry, base: (carry, one_block(base)), None, bases
        )
        out = blocks.reshape(groups_pad, up)
    flat = out.reshape(-1)
    return lax.slice(flat, (n_pre_remove,), (n_pre_remove + n_out,))


@functools.lru_cache(maxsize=None)
def _jitted_core(up: int, down: int, row_block: int, precision_name: str):
    import jax

    from .precision import resolve

    weights, s_lo, n_pre_remove = _polyphase_kernel(up, down)
    weights_dev = jax.numpy.asarray(weights)
    fn = functools.partial(
        _core,
        weights=weights_dev,
        up=up,
        down=down,
        s_lo=s_lo,
        n_pre_remove=n_pre_remove,
        row_block=row_block,
        precision=resolve(precision_name),
    )
    return jax.jit(fn)


def _reduce_ratio(up: int, down: int) -> tuple[int, int]:
    up, down = int(up), int(down)
    if up <= 0 or down <= 0:
        raise ValueError(f"up/down must be positive, got {up}/{down}")
    g = math.gcd(up, down)
    return up // g, down // g


def resample_poly_device(signal, up: int, down: int, *,
                         precision: str = "highest",
                         row_block: int = 0):
    """Resample a 1-D signal by ``up/down`` on device; returns float32.

    Matches ``scipy.signal.resample_poly(signal.astype(float32), up, down)``
    sample-for-sample (float32 rounding aside). ``precision`` follows the
    package-wide knob names; resampling is off the hot path so it defaults
    to f32-accurate ``"highest"``. ``row_block`` is rows per scan step;
    0 (default) auto-sizes by gathered bytes.
    """
    import jax.numpy as jnp

    up, down = _reduce_ratio(up, down)
    arr = jnp.asarray(signal)
    if arr.ndim != 1:
        raise ValueError(f"expected 1-D signal, got shape {arr.shape}")
    if arr.shape[0] == 0:
        return jnp.zeros((0,), jnp.float32)
    if up == down:
        return arr.astype(jnp.float32)
    return _jitted_core(up, down, int(row_block), str(precision))(arr)


def resample_batch_device(signals, up: int, down: int, *,
                          precision: str = "highest",
                          row_block: int = 0):
    """Resample a ``(B, L)`` batch by ``up/down`` in one device call.

    Rows are zero-extension resampled independently (vmapped), exactly like
    per-row ``resample_poly_device``. For rows that are zero-padded to a
    common ``L`` from true length ``l``, the first
    ``resample_output_len(l, up, down)`` output samples equal the resample
    of the unpadded row — zero padding and SciPy's constant-zero signal
    extension coincide, so masked batches stay correct to f32 rounding
    (tests pin this).
    """
    import jax
    import jax.numpy as jnp

    up, down = _reduce_ratio(up, down)
    arr = jnp.asarray(signals)
    if arr.ndim != 2:
        raise ValueError(f"expected (B, L) batch, got shape {arr.shape}")
    if arr.shape[1] == 0:
        return jnp.zeros((arr.shape[0], 0), jnp.float32)
    if up == down:
        return arr.astype(jnp.float32)
    core = _jitted_core(up, down, int(row_block), str(precision))
    return jax.vmap(core)(arr)


def resample_to_rate_device(arr, src_sr: int, dst_sr: int, *,
                            bucket: bool = True) -> np.ndarray:
    """Drop-in for ``runtime.audio_source._resample_to`` computed on device:
    int16 in → resample → clip [-32768, 32767] → truncate to int16.

    Input lengths are padded up to the :func:`_bucket_len` grid by default
    (the pad is host-side zeros; the true-length output is sliced back out
    after transfer, costing no extra device dispatch), so a corpus of
    arbitrary-length files compiles a bounded program set instead of one
    compile per distinct length. ``bucket=False``
    runs the exact shape (useful to pin bucketed == unbucketed in tests).

    Bit-parity with the host path is near-total but not guaranteed: both
    compute in float32, and a sample whose exact value sits at an int16
    truncation boundary can round across it under a different summation
    order (measured < 0.1 % of samples, always one LSB —
    tests/test_resample.py).
    """
    arr = np.asarray(arr)
    if int(src_sr) == int(dst_sr):
        return arr.astype(np.int16, copy=False)
    up, down = _reduce_ratio(int(dst_sr), int(src_sr))
    n_in = arr.shape[0]
    n_out = resample_output_len(n_in, up, down)
    if bucket and n_in > 0:
        padded_len = _bucket_len(n_in)
        if padded_len > n_in:
            arr = np.pad(arr, (0, padded_len - n_in))
    y = np.asarray(resample_poly_device(arr, up, down))[:n_out]
    return np.clip(y, -32768.0, 32767.0).astype(np.int16)
