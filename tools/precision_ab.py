#!/usr/bin/env python3
"""Parity of the matmul precision settings on the card, in one process.

For each precision name (default: "high" then "highest") this sets
``Config.TPU_MATMUL_PRECISION`` and runs two of ``chip_smoke.py``'s phases:

- offline: 3,600 s through the view path, per-feature NMSE against the
  float64 oracle on the first 600 s, the matmul ACF against the direct
  sliding sums, and F0 of the shipped signal path against direct-ACF F0;
- stream: ``AudioRuntime`` with engine pitch over a 32 s WAV, VAD agreement
  with the offline pipeline and with ``EngineVadOracle``.

Each phase prints its JSON line whether or not it is within tolerance.
The shipped default stays "high" only if its worst feature NMSE is at most
1e-6 (a 10x margin under the 1e-5 gate), F0 impl-match is at least 0.999 and
the stream VAD criteria hold; otherwise it is "highest".

    python tools/precision_ab.py [--precisions high,highest]
                                 [--out chiprun_out/precision.jsonl]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--precisions", default="high,highest")
    ap.add_argument("--seconds", type=float, default=3600.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import chip_smoke
    from sspv_tpu.config import Config
    from sspv_tpu.utils.device import nvidia_smi_identity, require_gpu

    print(f"nvidia-smi: {nvidia_smi_identity()}", flush=True)
    print(f"device: {require_gpu()}", flush=True)
    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    saved = Config.TPU_MATMUL_PRECISION
    ok = True
    for prec in args.precisions.split(","):
        Config.TPU_MATMUL_PRECISION = prec
        for fn, kw in ((chip_smoke.phase_offline,
                        {"seconds": args.seconds,
                         "bench_seconds": args.seconds}),
                       (chip_smoke.phase_stream, {})):
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    fn(**kw)
            except chip_smoke.SmokeFailure:
                ok = False
            line = buf.getvalue().strip().splitlines()[-1]
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    Config.TPU_MATMUL_PRECISION = saved
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
