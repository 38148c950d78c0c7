#!/usr/bin/env python3
"""Measurement-harness unit tests: soak-log parsing and slope fitting."""

import json
import subprocess
import sys


def test_soak_report_parses_and_fits(tmp_path):
    # synthetic soak log: 0.5 MB per call, 2 calls per 5 s sample, with a
    # warm-up period (no frames) the steady-state fit must exclude
    lines = []
    rss = 200.0
    calls = 0
    for i in range(60):
        t = 5.0 * (i + 1)
        frames = 0 if t < 60 else 100
        if frames:
            calls += 2
            rss += 1.0  # 0.5 MB/call
        lines.append(
            f"t={t:6.1f}s rss={rss:7.1f}MB calls={calls} "
            f"recent_frames={frames} voiced=3 err=None"
        )
    lines.append("soak: PASS")
    log = tmp_path / "soak.log"
    log.write_text("\n".join(lines) + "\n")

    out = subprocess.run(
        [sys.executable, "tools/soak_report.py", str(log), "--settle", "30"],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["verdict"] == "PASS"
    assert rep["errors"] == 0
    assert rep["first_frames_at_s"] == 60.0
    # 1 MB per 5 s sample -> 0.2 MB/s; 0.5 MB/call
    assert abs(rep["rss_slope_mb_per_s"] - 0.2) < 0.01
    assert abs(rep["rss_mb_per_call"] - 0.5) < 0.01
    assert rep["steady_samples_with_frames"] == rep["steady_samples"]


def test_soak_report_mixed_format_log(tmp_path):
    """A log appended across restarts (early rows predate the calls= field)
    must fit MB/call only over the rows that carry calls, pairwise-aligned
    (r3 regression: rss[-len(calls):] paired calls with wrong timestamps)."""
    lines = []
    # old-format prefix: RSS climbing with NO calls field
    rss = 100.0
    for i in range(10):
        t = 5.0 * (i + 1)
        rss += 3.0  # steep old-run slope that must NOT pollute the fit
        lines.append(f"t={t:6.1f}s rss={rss:7.1f}MB recent_frames=50 err=None")
    # new-format tail: 0.5 MB/call, 2 calls per sample
    calls = 0
    for i in range(20):
        t = 5.0 * (11 + i)
        calls += 2
        rss += 1.0
        lines.append(
            f"t={t:6.1f}s rss={rss:7.1f}MB calls={calls} "
            f"recent_frames=50 err=None"
        )
    log = tmp_path / "soak.log"
    log.write_text("\n".join(lines) + "\n")
    out = subprocess.run(
        [sys.executable, "tools/soak_report.py", str(log), "--settle", "0"],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["device_calls"] == 40
    assert abs(rep["rss_mb_per_call"] - 0.5) < 0.01
    # 2 calls / 5 s sample
    assert abs(rep["calls_per_s"] - 0.4) < 0.01


def test_soak_report_no_frames(tmp_path):
    log = tmp_path / "soak.log"
    log.write_text(
        "t=   5.0s rss=  100.0MB calls=0 recent_frames=0 voiced=0 err=None\n"
    )
    out = subprocess.run(
        [sys.executable, "tools/soak_report.py", str(log)],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert out.returncode == 1
    assert "no frames" in json.loads(out.stdout)["error"]


def test_vad_eval_confusion_breakdown():
    """The r5 frame-level confusion attribution in examples/vad_eval.py:
    per-class recall, gate attribution of misses, and hangover-attributed
    false positives on a hand-built scenario."""
    import importlib.util
    import os

    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "vad_eval", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "examples", "vad_eval.py",
        ),
    )
    ve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ve)

    # 10 frames: truth 0-1 silence, 2-3 fricative, 4-6 voiced, 7-9 silence
    truth = np.array([0, 0, 1, 1, 1, 1, 1, 0, 0, 0], bool)
    fclass = np.array([0, 0, 1, 1, 2, 2, 2, 0, 0, 0], np.int8)
    frac = np.array([0, 0, 0.6, 1, 1, 1, 1, 0, 0, 0], float)
    # pred misses the fricatives, holds 2 frames past the end (hangover)
    pred = np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 0], bool)
    e = np.full(10, 5000.0)  # energy gate always on
    z = np.where(fclass == 1, 0.45, 0.1)  # fricatives: high zcr
    h = np.where(fclass == 1, 0.9, 0.3)  # fricatives: high entropy

    class Cfg:
        energy_threshold = 1000.0
        zcr_threshold = 0.3
        entropy_voice_max = 0.65
        hangover_on = 3
        release_off = 2

    out = ve.confusion_breakdown(pred, truth, frac, fclass, e, z, h, Cfg)
    assert out["fn_frames"] == 2 and out["fp_frames"] == 2
    assert out["fn_fricative_pct"] == 100.0
    assert out["fn_energy_gate_off_pct"] == 0.0
    assert out["fn_spectral_gate_off_pct"] == 100.0
    assert out["recall_steady_voiced"] == 100.0
    assert out["recall_steady_fricative"] == 0.0
    assert out["fp_hangover_pct"] == 100.0
    assert out["fp_mid_noise_pct"] == 0.0

    # frame_class_info majority rule + boundary fractions
    labels = np.zeros(320 + 9 * 160, bool)
    classes = np.zeros(labels.size, np.int8)
    labels[:480] = True
    classes[:480] = 2
    frac2, fcl2 = ve.frame_class_info(labels, classes, 320, 160)
    assert frac2[0] == 1.0 and fcl2[0] == 2
    # frame 2 spans samples 320..640 -> half speech: straddles the offset
    assert 0.0 < frac2[2] < 1.0 and fcl2[2] == 2
    assert frac2[3] == 0.0 and fcl2[3] == 0


def test_soak_stitch_segments(tmp_path):
    """Restart-resilient soak stitching: per-segment state
    rows, orphan adoption after a simulated recycle, accumulated steady
    time, and the pooled combined report."""

    def write_seg(path, n, rss0, calls0=0, verdict=None, mb_per_call=0.5):
        lines = []
        rss, calls = rss0, calls0
        for i in range(n):
            t = 5.0 * (i + 1)
            calls += 2
            rss += 2 * mb_per_call
            lines.append(
                f"t={t:6.1f}s rss={rss:7.1f}MB calls={calls} "
                f"recent_frames=100 voiced=3 err=None"
            )
        if verdict:
            lines.append(f"soak: {verdict}")
        path.write_text("\n".join(lines) + "\n")

    state = tmp_path / "state.jsonl"
    seg1 = tmp_path / "seg1.log"
    seg2 = tmp_path / "seg2.log"
    write_seg(seg1, 100, 200.0, verdict="PASS")  # clean segment
    write_seg(seg2, 60, 210.0)  # killed mid-run: no verdict line (orphan)

    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "tools/soak_stitch.py", *a],
        capture_output=True, text=True, cwd="/root/repo",
    )
    out = run("--append-state", str(state), "--log", str(seg1), "--rc", "0")
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout)
    assert row["rc"] == 0 and row["frames_s"] == 495.0
    assert row["calls"] == 200

    # recycle: seg2 never got its state row; reconcile adopts it
    out = run("--reconcile", str(state), str(tmp_path))
    assert out.returncode == 0 and out.stdout.strip() == "1"
    out = run("--reconcile", str(state), str(tmp_path))  # idempotent
    assert out.stdout.strip() == "0"

    out = run("--accumulated", str(state))
    assert int(out.stdout.strip()) == 495 + 295

    out = run("--settle", "120", str(state))
    rep = json.loads(out.stdout)
    assert rep["segments"] == 2
    assert rep["total_steady_s"] == 790.0
    assert rep["total_calls"] == 320
    # both segments leak 0.5 MB/call -> pooled fit must agree
    assert abs(rep["pooled_rss_mb_per_call"] - 0.5) < 0.01
    assert rep["per_segment"][1].get("rc") is None


def _roofline():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "roofline", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "roofline.py",
        ),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_kernel_classes():
    """Kernel names from an H100 trace of the offline programs land in the
    right class (the names the GPU trace actually carries)."""
    rl = _roofline()
    for name in (
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>",
        "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32",
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_stage3",
    ):
        assert rl.classify(name) == "matmul", name
    for name in ("loop_add_fusion", "input_reduce_slice_fusion",
                 "loop_pad_fusion", "Memset 0", "loop_log_fusion"):
        assert rl.classify(name) == "other", name


def test_roofline_reduction_ignores_host_planes(tmp_path):
    """A CPU-backend trace has no GPU plane: the reduction reports zero
    kernel time instead of counting host events."""
    import jax
    import jax.numpy as jnp

    rl = _roofline()
    jax.profiler.start_trace(str(tmp_path))
    jax.block_until_ready(jnp.ones((64, 64)) @ jnp.ones((64, 64)))
    jax.profiler.stop_trace()
    split = rl.reduce_trace(str(tmp_path))
    assert split["matmul_ms"] == 0.0 and split["other_ms"] == 0.0
    assert split["top"] == [] and split["lines"] == []
