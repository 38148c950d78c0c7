#!/usr/bin/env python3
"""Standalone compile-cache warmup CLI.

    python -m sspv_tpu.warmup [--offline all|first|none] [--stream all|first|none]
                              [--pitch] [--engine] [--batch B] [--long SECONDS]

A cold program compiles at first dispatch; every entry point enables the
shared persistent cache (``utils/cache.py``), but something still has to
compile each program once. The serving layer warms itself
(``RTP_SERVE_WARMUP``); batch jobs, engine deployments, and fresh checkouts
had to eat the stall on first real traffic. This CLI compiles the chosen
program families up front — run it once per checkout/cache dir (CI, image
build, pre-deploy) and every subsequent CLI/server start is warm.

Families:

- ``--offline``: the bucketed masked signal programs behind
  ``process_signal_auto`` (serve ``/v1/features``/``/v1/vad``, analyze,
  batch oversized path), one per ``SIGNAL_BUCKET_SECONDS`` entry; with
  ``--pitch`` also the fused features+VAD+pitch twins (``/v1/pitch``,
  analyze, batch).
- ``--stream``: the bucketed frame-block programs behind
  ``FeaturePipeline.stream`` (serve ``/v1/stream``), one per
  ``TPU_STREAM_BUCKETS`` entry; with ``--pitch`` also the fused streaming
  twins (``/v1/stream?pitch=1``).
- ``--engine``: the packed three-buffer programs the ``AudioRuntime``
  engine dispatches (both layouts it would pick from the current Config);
  with ``--pitch`` also the pitch-enabled packed twins
  (``TPU_ENGINE_PITCH``).
- ``--batch B``: ``BatchPipeline.process_batch_masked`` at ``(B, bucket)``
  for each warmed signal bucket (the batch CLI's per-batch program; B is
  padded to the mesh's data extent exactly like the CLI does); with
  ``--pitch`` also the fused batched twin.
- ``--long S``: one ``process_signal_device`` dispatch of S seconds — the
  scan-blocked flagship offline path (compile cost is length-independent
  past ``SCAN_BLOCK_FRAMES``, so one length warms all long signals).
- ``--resample "SRC[,SRC...]"``: the device resampler programs
  (``RTP_TPU_DEVICE_RESAMPLE=1``) from each listed source rate to the
  pipeline rate, one per bucket of the ``ops.resample._bucket_len`` length
  grid spanning ``--resample-span MIN:MAX`` seconds (default 30:600) — the
  exact programs the bucketed int16 wrapper dispatches for corpus files in
  that length range.
"""

from __future__ import annotations

import argparse
import logging
import math
import time

import numpy as np

from .config import Config, parse_buckets

logger = logging.getLogger(__name__)


def _timed(label: str, fn) -> None:
    t0 = time.perf_counter()
    fn()
    print(f"warmed {label} in {time.perf_counter() - t0:.1f}s", flush=True)


def warmup(
    offline: str = "first",
    stream: str = "first",
    pitch: bool = False,
    engine: bool = False,
    batch: int = 0,
    long_seconds: float = 0.0,
    resample_rates: tuple = (),
    resample_span: tuple = (30.0, 600.0),
) -> int:
    """Compile the selected program families; returns the family count."""
    import jax

    from .ops.pipeline import FeatureConfig, FeaturePipeline

    pipe = FeaturePipeline(FeatureConfig.from_config(Config))
    sr = pipe.cfg.sample_rate
    count = 0

    def pick(mode: str, values):
        if mode == "none":
            return []
        return list(values) if mode == "all" else list(values)[:1]

    sig_buckets = pick(offline, pipe.SIGNAL_BUCKET_SECONDS)
    for sec in sig_buckets:
        sig = np.zeros((sec * sr,), np.int16)

        def one(sig=sig, sec=sec):
            block, _ = pipe.process_signal_auto(sig)
            jax.block_until_ready(block)
            if pitch:
                block, _, f0, _c = pipe.process_signal_pitch_auto(sig)
                jax.block_until_ready(f0)

        _timed(f"offline bucket {sec}s" + (" (+pitch)" if pitch else ""), one)
        count += 1

    stream_buckets = pick(
        stream,
        parse_buckets(getattr(Config, "TPU_STREAM_BUCKETS", (32, 256, 2048))),
    )
    c = pipe.cfg
    for b in stream_buckets:
        n = (b - 1) * c.hop_size + c.frame_size
        chunk = np.zeros((n,), np.int16)

        def one(chunk=chunk):
            for _ in pipe.stream(iter([chunk])):
                pass
            if pitch:
                for _ in pipe.stream_pitch(iter([chunk])):
                    pass

        _timed(f"stream bucket {b}" + (" (+pitch)" if pitch else ""), one)
        count += 1

    if engine:
        for b in stream_buckets or pick(
            "first",
            parse_buckets(getattr(Config, "TPU_STREAM_BUCKETS", (32, 256, 2048))),
        ):
            n = (b - 1) * c.hop_size + c.frame_size

            def one(b=b, n=n):
                frames = np.zeros((b, c.frame_size), np.float32)
                st = pipe.initial_packed_state()
                out, _ = pipe.process_block_packed(frames, st, b)
                jax.block_until_ready(out)
                if pitch:
                    out, _ = pipe.process_block_packed_pitch(frames, st, b, 0.3)
                    jax.block_until_ready(out)
                if pipe.supports_samples_dispatch():
                    samples = np.zeros((n,), np.int16)
                    st = pipe.initial_packed_state()
                    out, _ = pipe.process_signal_packed(samples, st, n)
                    jax.block_until_ready(out)
                    if pitch:
                        out, _ = pipe.process_signal_packed_pitch(
                            samples, st, n, 0.3
                        )
                        jax.block_until_ready(out)

            _timed(
                f"engine bucket {b}" + (" (+pitch)" if pitch else ""), one
            )
            count += 1

    if batch > 0:
        from .parallel import BatchPipeline, make_mesh

        mesh = make_mesh()
        bp = BatchPipeline(mesh, FeatureConfig.from_config(Config))
        dp = mesh.devices.shape[0]
        b_pad = -(-batch // dp) * dp
        for sec in sig_buckets or list(pipe.SIGNAL_BUCKET_SECONDS)[:1]:
            L = sec * sr
            sigs = np.zeros((b_pad, L), np.int16)
            lengths = np.full((b_pad,), L, np.int32)

            def one(sigs=sigs, lengths=lengths):
                block, _ = bp.process_batch_masked(sigs, lengths)
                jax.block_until_ready(block)
                if pitch:
                    block, _, f0, _c = bp.process_batch_masked_pitch(
                        sigs, lengths
                    )
                    jax.block_until_ready(f0)

            _timed(
                f"batch ({b_pad}, {sec}s)" + (" (+pitch)" if pitch else ""),
                one,
            )
            count += 1

    if resample_rates:
        from .ops.resample import _bucket_len, resample_poly_device

        lo, hi = resample_span
        for src in resample_rates:
            src = int(src)
            if src == sr:
                continue
            g = math.gcd(src, sr)
            up, down = sr // g, src // g
            b = _bucket_len(max(1, int(lo * src)))
            last = _bucket_len(max(1, int(hi * src)))
            buckets = []
            while True:
                buckets.append(b)
                if b >= last:
                    break
                b = _bucket_len(b + 1)
            for L in buckets:
                def one(L=L, up=up, down=down):
                    out = resample_poly_device(
                        np.zeros((L,), np.int16), up, down
                    )
                    jax.block_until_ready(out)

                _timed(f"resample {src}->{sr} bucket {L}", one)
            count += 1

    if long_seconds > 0:
        sig = np.zeros((int(long_seconds * sr),), np.float32)

        def one(sig=sig):
            block, _ = pipe.process_signal_device(sig)
            jax.block_until_ready(block)

        _timed(f"long scan path {long_seconds:g}s", one)
        count += 1

    return count


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--offline", default="first",
                        choices=["all", "first", "none"])
    parser.add_argument("--stream", default="first",
                        choices=["all", "first", "none"])
    parser.add_argument("--pitch", action="store_true",
                        help="also warm every fused features+pitch twin")
    parser.add_argument("--engine", action="store_true",
                        help="warm the engine's packed dispatch programs")
    parser.add_argument("--batch", type=int, default=0,
                        help="warm BatchPipeline at this batch size (0=skip)")
    parser.add_argument("--long", type=float, default=0.0, dest="long_seconds",
                        help="warm the scan-blocked long path at this many "
                        "seconds (0=skip)")
    parser.add_argument("--resample", default="",
                        help="comma-separated source rates to warm the "
                        "device resampler for (e.g. '22050,48000'; dst = "
                        "pipeline rate)")
    parser.add_argument("--resample-span", default="30:600",
                        help="MIN:MAX corpus file length in seconds whose "
                        "length buckets to warm (default 30:600)")
    args = parser.parse_args(argv)

    Config.setup_logging()
    from .utils.cache import enable_persistent_cache

    cache_dir = enable_persistent_cache()
    print(f"compile cache: {cache_dir}", flush=True)
    t0 = time.perf_counter()
    rates = tuple(
        int(r) for r in args.resample.split(",") if r.strip()
    )
    lo, _, hi = args.resample_span.partition(":")
    n = warmup(
        offline=args.offline, stream=args.stream, pitch=args.pitch,
        engine=args.engine, batch=args.batch,
        long_seconds=args.long_seconds,
        resample_rates=rates,
        resample_span=(float(lo), float(hi or lo)),
    )
    print(f"warmed {n} families in {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
