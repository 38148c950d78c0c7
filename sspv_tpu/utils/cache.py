#!/usr/bin/env python3
"""Persistent XLA compilation cache placement.

Every entry point calls :func:`enable_persistent_cache` once, so all of them
share one warm cache. The directory is decided here and nowhere else:

- ``JAX_COMPILATION_CACHE_DIR``, when set, is used exactly as given (the
  deployment owns that directory and its layout);
- otherwise the fixed ``<checkout>/.jax_cache``. A fixed path matters because
  the cache directory is part of what makes a later run hit the cache.

Safe to call multiple times.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

__all__ = ["enable_persistent_cache", "host_isa_fingerprint", "default_cache_dir"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))


def host_isa_fingerprint() -> str:
    """Short stable fingerprint of this host's CPU ISA (arch + feature
    flags). XLA:CPU persistent-cache entries embed AOT machine code whose
    required features (AVX512 etc.) are NOT part of the cache key, so an
    entry written on one host type deserializes on another with "could lead
    to execution errors such as SIGILL" warnings. CPU caches under the
    checkout's own directory are scoped per fingerprint to rule that out."""
    import hashlib
    import platform

    feat = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feat = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        feat = platform.processor()
    h = hashlib.sha1(f"{platform.machine()}|{feat}".encode()).hexdigest()
    return f"{platform.machine()}-{h[:10]}"


def default_cache_dir() -> str:
    """The checkout-local cache directory used when the environment names
    none."""
    return os.path.join(_CHECKOUT, ".jax_cache")


def enable_persistent_cache() -> str:
    """Point jax at the persistent compilation cache and lower the store
    threshold to zero; returns the directory in use.

    ``JAX_COMPILATION_CACHE_DIR`` wins and is used verbatim. Without it the
    cache lives at :func:`default_cache_dir`; CPU-backend processes get an
    ISA-scoped subdirectory there (see :func:`host_isa_fingerprint`).
    Reading ``jax.config`` to tell the backend is a pure host check that
    never initializes a device."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = default_cache_dir()
        configured = (jax.config.jax_platforms or "").split(",")[0]
        if configured == "cpu":
            cache_dir = os.path.join(cache_dir, f"cpu-{host_isa_fingerprint()}")
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    logger.debug("persistent compilation cache at %s", cache_dir)
    return cache_dir
