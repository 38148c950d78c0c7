#!/usr/bin/env python3
"""Device-time split of the offline features call and the pitch call.

Times the two shipped offline programs at the bench geometry (warm,
pipelined — bench.py methodology), attaches XLA's cost analysis of each
compiled program, then traces a few calls of each with ``jax.profiler`` and
reduces the GPU planes of the trace to kernel time by class:

- ``matmul``: the DFT / mel / DCT / ACF matrix products (cuBLAS, CUTLASS or
  XLA's own GEMM kernels);
- ``other``: every other kernel — the fusions after the products (power,
  mel floor + log, lifter, entropy, ACF band pick), the VAD prefix pass,
  copies.

It also prints the bytes that the spectrum round trip moves through device
memory, computed from the shapes, and the least time those bytes cost at the
card's published bandwidth: what a kernel that keeps the spectrum on chip
could save at most is bounded by the ``other`` time plus that round trip.

    python tools/roofline.py [--seconds 57600] [--precision high]
                             [--out chiprun_out/roofline.jsonl]

Needs a GPU (exits non-zero without one). One JSON line per measurement.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# NVIDIA H100 SXM data sheet (dense rates); keyed by JAX's device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "tf32_tflops": 495.0, "fp32_tflops": 67.0, "hbm_tbps": 3.35,
    },
}

_MATMUL_RE = re.compile(r"gemm|xmma|cutlass|cublas|matmul|\bdot", re.I)


def classify(kernel_name: str) -> str:
    """``"matmul"`` for a matrix-product kernel, ``"other"`` otherwise."""
    return "matmul" if _MATMUL_RE.search(kernel_name) else "other"


def reduce_trace(trace_dir: str) -> dict:
    """Sum kernel time per class over the GPU planes of the ``.xplane.pb``
    files under ``trace_dir``. Returns ``{"matmul_ms", "other_ms",
    "top": [[name, ms, class], ...]}``; all zero when no GPU plane exists."""
    import jax

    agg: dict[str, float] = {}
    lines_seen: set[str] = set()
    for path in glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True):
        pd = jax.profiler.ProfileData.from_file(path)
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                lines_seen.add(line.name)
                # the per-stream lines carry the kernels; "XLA Ops" and
                # "XLA Modules" lines repeat the same time at op level
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    agg[ev.name] = agg.get(ev.name, 0.0) + ev.duration_ns / 1e6
    split = {"matmul_ms": 0.0, "other_ms": 0.0, "lines": sorted(lines_seen)}
    for name, ms in agg.items():
        split[f"{classify(name)}_ms"] += ms
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:30]
    split["top"] = [[k[:120], round(v, 4), classify(k)] for k, v in top]
    return split


def timed(fn, probe, rounds=5, reps=4) -> list[float]:
    """Warm + pipelined per-call seconds, one sample per round: async
    dispatch, per-rep scalars stacked on device, one device_get per round."""
    import jax
    import jax.numpy as jnp

    jax.block_until_ready(fn())
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        probes = [probe(fn()) for _ in range(reps)]
        _ = np.asarray(jax.device_get(jnp.stack(probes).sum()))
        out.append((time.perf_counter() - t0) / reps)
    return out


def cost_of(jitted, *args) -> dict:
    """XLA cost analysis of the compiled program (optimized HLO)."""
    ca = jitted.lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return {
        "xla_gflop": float(ca.get("flops", 0.0)) / 1e9,
        "xla_gbytes": float(ca.get("bytes accessed", 0.0)) / 1e9,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=57600.0)
    ap.add_argument("--precision", default=None,
                    help="override FeatureConfig/pitch precision")
    ap.add_argument("--trace-calls", type=int, default=3)
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args()

    from sspv_tpu.utils.device import nvidia_smi_identity, require_gpu

    smi = nvidia_smi_identity()
    device = require_gpu()

    import jax
    import jax.numpy as jnp

    import bench
    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline
    from sspv_tpu.ops.pitch import _lag_band, pitch_track_signal_jit
    from sspv_tpu.ops.time_features import _acf_dft_bases_merged
    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    out_f = open(args.out, "a") if args.out else None

    def emit(row: dict) -> None:
        row = {**row, "device": device, "nvidia_smi": smi}
        line = json.dumps(row)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()

    cfg = FeatureConfig()
    if args.precision:
        cfg = cfg._replace(precision=args.precision)
    pipe = FeaturePipeline(cfg)
    c = pipe.cfg
    sig_np = bench.synth_signal(args.seconds, c.sample_rate)
    rows = jax.device_put(jnp.asarray(pipe.host_rows_view(sig_np)))
    del sig_np
    n = int(rows.shape[0]) - 1
    state0 = pipe.initial_state()
    vad = jax.device_put(jnp.ones((n,), jnp.int32))
    pitch_fn = pitch_track_signal_jit(precision=c.precision)
    mc = np.float32(0.3)

    programs = {
        "features": (
            lambda: pipe.process_signal_device(rows, state0),
            lambda o: o[0].vad[-1].astype(jnp.float32),
            lambda: cost_of(pipe._signal_jit, rows, state0),
        ),
        "pitch": (
            lambda: pitch_fn(rows, vad, mc),
            lambda o: o[0][-1] + o[1][-1],
            lambda: cost_of(pitch_fn, rows, vad, mc),
        ),
    }

    # spectrum round trip from the shapes: the merged DFT output (F, n_fft)
    # is written once and read once by the power fusion; the power spectrum
    # (F, n_fft/2+1) is written once and read by the mel product and the
    # entropy (features) or by the inverse ACF product (pitch).
    lag_min, lag_max = _lag_band(c.sample_rate, 50.0, 400.0, c.frame_size)
    acf_nfft = int(_acf_dft_bases_merged(c.frame_size, lag_max)[0].shape[1])
    spectrum_bytes = {
        "features": 4 * n * (2 * c.n_fft + 3 * (c.n_fft // 2 + 1)),
        "pitch": 4 * n * (2 * acf_nfft + 2 * (acf_nfft // 2)),
    }
    peak = PEAKS.get(device["kind"])

    for name, (fn, probe, cost) in programs.items():
        times = timed(fn, probe)
        med = float(np.median(times))
        cost_row = cost()
        tdir = tempfile.mkdtemp(prefix=f"sspv_trace_{name}_")
        jax.profiler.start_trace(tdir)
        probes = [probe(fn()) for _ in range(args.trace_calls)]
        _ = np.asarray(jax.device_get(jnp.stack(probes).sum()))
        jax.profiler.stop_trace()
        split = reduce_trace(tdir)
        calls = args.trace_calls
        kern = split["matmul_ms"] + split["other_ms"]
        row = {
            "program": name,
            "seconds_audio": args.seconds,
            "frames": n,
            "precision": c.precision,
            "call_s_median": med,
            "call_s_rounds": times,
            "x_realtime_median": args.seconds / med,
            **cost_row,
            "trace_calls": calls,
            "matmul_ms_per_call": split["matmul_ms"] / calls,
            "other_ms_per_call": split["other_ms"] / calls,
            "other_share_of_kernel_time": (
                split["other_ms"] / kern if kern else None
            ),
            "spectrum_roundtrip_gbytes": spectrum_bytes[name] / 1e9,
            "top_kernels_ms_total": split["top"],
            "trace_lines": split["lines"],
        }
        if peak:
            row["spectrum_roundtrip_ms_at_peak_bw"] = (
                spectrum_bytes[name] / (peak["hbm_tbps"] * 1e12) * 1e3
            )
        emit(row)
    if out_f:
        out_f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
