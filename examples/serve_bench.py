#!/usr/bin/env python3
"""Serving-layer benchmark: N concurrent HTTP clients against sspv_tpu.serve.

Measures end-to-end request latency and aggregate audio-throughput of the
HTTP surface (decode + bucket pad + shared-pipeline device call + JSON/npz
encode). Complements examples/multistream_bench.py, which measures the
engine/dispatch layer without HTTP: the delta between the two is the
serving overhead.

Usage:
    python examples/serve_bench.py [--clients 1,4,8] [--seconds 30]
        [--requests 8] [--endpoint /v1/features] [--fmt npz]
        [--url http://host:port]   # benchmark an external server instead

Prints one JSON line per client count:
    {"clients": N, "requests": R, "audio_s_per_s": ..., "p50_ms": ...,
     "p90_ms": ..., "aggregate_x_realtime": ...}
"""

from __future__ import annotations

import argparse
import io
import os
import json
import sys
import threading
import time
import urllib.request
import wave

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _wav_bytes(seconds: float, sr: int, freq: float = 150.0) -> bytes:
    t = np.arange(int(seconds * sr)) / sr
    sig = np.zeros_like(t)
    third = len(t) // 3
    sig[third : 2 * third] = np.sin(2 * np.pi * freq * t[third : 2 * third])
    samples = (sig * 8000).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(samples.tobytes())
    return buf.getvalue()


def _post(url: str, body: bytes, timeout: float = 600.0) -> bytes:
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "audio/wav"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}")
        return resp.read()


def run_level(url: str, wav: bytes, clients: int, requests_each: int,
              audio_seconds: float) -> dict:
    latencies: list[list[float]] = [[] for _ in range(clients)]
    errors: list = []

    def worker(i: int) -> None:
        try:
            for _ in range(requests_each):
                t0 = time.perf_counter()
                _post(url, wav)
                latencies[i].append(time.perf_counter() - t0)
        except Exception as e:  # pragma: no cover - network failure path
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat = np.array(sorted(x for l in latencies for x in l))
    total_requests = int(lat.size)
    total_audio = total_requests * audio_seconds
    return {
        "clients": clients,
        "requests": total_requests,
        "errors": errors,
        "wall_s": round(wall, 3),
        "requests_per_s": round(total_requests / wall, 2),
        "audio_s_per_s": round(total_audio / wall, 1),
        "aggregate_x_realtime": round(total_audio / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1000, 1) if lat.size else None,
        "p90_ms": round(float(np.percentile(lat, 90)) * 1000, 1) if lat.size else None,
        "max_ms": round(float(lat.max()) * 1000, 1) if lat.size else None,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", default="1,4,8")
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="audio seconds per request")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client per level")
    ap.add_argument("--endpoint", default="/v1/features")
    ap.add_argument("--fmt", default="npz", choices=["json", "npz"])
    ap.add_argument("--url", default=None,
                    help="external server base URL; default: in-process")
    args = ap.parse_args()

    from sspv_tpu.config import Config

    wav = _wav_bytes(args.seconds, Config.SAMPLE_RATE)
    path = f"{args.endpoint}?fmt={args.fmt}"

    server = None
    if args.url:
        base = args.url.rstrip("/")
    else:
        from sspv_tpu.serve import make_server
        from sspv_tpu.utils.cache import enable_persistent_cache

        enable_persistent_cache()
        server = make_server("127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"

    url = base + path
    # warm-up: compile the bucket programs before timing
    t0 = time.perf_counter()
    _post(url, wav)
    print(json.dumps({"warmup_s": round(time.perf_counter() - t0, 2)}),
          file=sys.stderr)

    for clients in (int(c) for c in args.clients.split(",")):
        print(json.dumps(run_level(
            url, wav, clients, args.requests, args.seconds
        )), flush=True)

    if server is not None:
        server.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
