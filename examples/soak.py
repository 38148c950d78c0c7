#!/usr/bin/env python3
"""Stability soak: run the streaming engine continuously and watch for
drift — frame-rate stalls, memory growth, dropped errors.

The reference claims 24 h continuous operation with no crashes or leaks
(BASELINE.md) but ships no tooling to demonstrate it; this harness is that
tooling. A looping synthetic source streams indefinitely; every interval we
sample frames-processed and RSS.

    python examples/soak.py [seconds]   # default 60
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


from _sources import LoopingPacedSource  # noqa: E402


def rss_mb() -> float:
    with open(f"/proc/{os.getpid()}/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def main(argv) -> int:
    seconds = float(argv[0]) if argv else 60.0
    grace = float(os.environ.get("SOAK_GRACE_SECONDS", "600"))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from sspv_tpu.config import Config
    from sspv_tpu.runtime import AudioRuntime
    from sspv_tpu.utils.cache import enable_persistent_cache

    Config.load_from_env()  # honor RTP_* overrides (e.g. the dispatch
    # coalescing knob RTP_TPU_MIN_DISPATCH_INTERVAL)
    enable_persistent_cache()
    rt = AudioRuntime(audio_source=LoopingPacedSource(Config.SAMPLE_RATE))
    rt.start()
    t0 = time.time()
    ok = True
    produced = 0
    try:
        while time.time() - t0 < seconds:
            time.sleep(5.0)
            elapsed = time.time() - t0
            e, _, v = rt.get_recent_processed()
            produced = max(produced, e.size)
            print(
                f"t={elapsed:6.1f}s rss={rss_mb():7.1f}MB "
                f"calls={rt.dispatch_count} "
                f"recent_frames={e.size} voiced={int(v.sum()) if v.size else 0} "
                f"err={rt.last_error}",
                flush=True,
            )
            if rt.last_error is not None:
                ok = False
                break
            # Empty output is only a failure after a warm-up grace that
            # covers the first compiles of a cold process.
            if elapsed > grace and produced == 0:
                ok = False
                break
    finally:
        rt.stop()
    ok = ok and rt.last_error is None and produced > 0
    print("soak:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
