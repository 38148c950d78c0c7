#!/usr/bin/env python3
"""The concurrent-serving example must run end-to-end on the CPU backend in
both modes: flood (throughput ceiling) and paced (live-cadence capacity).
These are the serving harnesses — keep them executable, not just
committed."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "multistream_bench.py")


def _run(args):
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, SCRIPT, *args],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
    return json.loads(line)

def test_flood_mode_cpu():
    r = _run(["2", "4"])
    assert r["n_streams"] == 2
    assert r["aggregate_audio_x_realtime"] > 2  # faster than real time
    assert len(r["per_stream_finish_s"]) == 2


def test_paced_mode_cpu():
    r = _run(["2", "6", "--paced"])
    assert r["mode"] == "paced"
    assert r["all_frames_after_drain"] is True
    # live-cadence: the paced source sleeps at real-time cadence, so the wall
    # cannot undershoot the audio duration — a deterministic pacing check.
    # Upper bounds (realtime_ok, wall < 12 s) are load-sensitive on a busy CI
    # host and belong to measured runs on the card, not the default suite;
    # here we only require the field to be reported.
    assert r["wall_s"] >= 5.0
    assert isinstance(r["realtime_ok"], bool)
