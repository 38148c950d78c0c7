#!/usr/bin/env python3
"""Shared matmul-precision name resolution.

One map from the public precision knob names (``Config.TPU_MATMUL_PRECISION``,
``FeatureConfig.precision``, the pitch/pipeline ``precision=`` arguments) to
``jax.lax.Precision`` values, so every matmul path resolves the knob
identically. What each name means for a float32 matmul on an NVIDIA GPU
(XLA's GPU backend; on the CPU backend all three compute in float32):

- ``"highest"``: float32 arithmetic throughout — no tensor-core rounding;
- ``"high"``: one TF32 pass on the tensor cores (operands rounded to a
  10-bit mantissa, float32 accumulation);
- ``"default"``: the backend's default for float32 operands, which on the
  GPU is also TF32.

Unknown names resolve to HIGHEST (the safe end).
"""

from __future__ import annotations

import jax

__all__ = ["resolve"]

_NAME_TO_PRECISION = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def resolve(name: str) -> jax.lax.Precision:
    """Map a precision knob name to ``jax.lax.Precision`` (unknown → HIGHEST,
    case-insensitive)."""
    return _NAME_TO_PRECISION.get(
        str(name).strip().lower(), jax.lax.Precision.HIGHEST
    )
