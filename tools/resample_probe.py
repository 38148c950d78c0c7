#!/usr/bin/env python3
"""Measure host-SciPy vs on-device polyphase resampling throughput.

The batch corpus path decodes files host-side; any non-16 kHz file then pays
a SciPy FIR pass (``runtime/audio_source.py::_resample_to``) before its
samples reach the device. ``ops/resample.py`` moves that FIR onto the
device (K shifted row-view matmuls); this probe quantifies when that is worth
switching on (``RTP_TPU_DEVICE_RESAMPLE=1``):

    python tools/resample_probe.py [seconds ...]     # default: 60 600

For each signal length and rate pair it prints one JSON line with host and
device audio-seconds/sec (device timed with the pipelined methodology:
untimed warmup dispatch, then several overlapped calls with one final
fetch, matching bench.py) and the max int16 LSB disagreement.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

RATE_PAIRS = [(44100, 16000), (22050, 16000), (8000, 16000), (48000, 16000)]


def main(argv):
    lengths = [float(a) for a in argv] or [60.0, 600.0]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    from sspv_tpu.ops.resample import resample_poly_device
    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    rng = np.random.default_rng(0)

    for seconds in lengths:
        for src, dst in RATE_PAIRS:
            n = int(seconds * src)
            x = rng.normal(0, 5000, n).clip(-32768, 32767).astype(np.int16)
            g = math.gcd(src, dst)
            up, down = dst // g, src // g

            import scipy.signal as sps

            t0 = time.perf_counter()
            y_host = sps.resample_poly(x.astype(np.float32), up, down)
            host_s = time.perf_counter() - t0

            xd = jax.device_put(x)
            t0 = time.perf_counter()
            y_dev = resample_poly_device(xd, up, down)
            jax.block_until_ready(y_dev)
            compile_s = time.perf_counter() - t0

            reps = 8
            tails = []
            t0 = time.perf_counter()
            for _ in range(reps):
                tails.append(resample_poly_device(xd, up, down)[-1])
            _ = float(jax.device_get(sum(tails)))
            dev_s = (time.perf_counter() - t0) / reps

            yh = np.clip(y_host, -32768, 32767).astype(np.int16)
            yd = np.clip(np.asarray(y_dev), -32768, 32767).astype(np.int16)
            lsb = int(np.abs(yd.astype(np.int32) - yh.astype(np.int32)).max())
            print(
                json.dumps(
                    {
                        "seconds": seconds,
                        "src_sr": src,
                        "dst_sr": dst,
                        "host_s": round(host_s, 5),
                        "device_s": round(dev_s, 5),
                        "device_compile_s": round(compile_s, 2),
                        "host_audio_s_per_s": round(seconds / host_s, 1),
                        "device_audio_s_per_s": round(seconds / dev_s, 1),
                        "speedup": round(host_s / dev_s, 2),
                        "max_int16_lsb_diff": lsb,
                    }
                ),
                flush=True,
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
