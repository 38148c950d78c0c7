#!/usr/bin/env python3
"""chip_smoke.py at tiny sizes on the CPU: every phase's control flow and
comparisons, its refusal to run without a GPU, and the four-card phase on
virtual CPU devices. The full-size run happens on the card."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from sspv_tpu.utils.device import nvidia_smi_identity, require_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("SSPV_TEST_PLATFORM", None)
    return env


def _no_result(stdout: str) -> bool:
    return not any(line.startswith('{"ok"') for line in stdout.splitlines())


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        require_gpu()


def test_nvidia_smi_identity_never_raises():
    assert isinstance(nvidia_smi_identity(), str)


def test_script_refuses_cpu_backend():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU found" in out.stderr
    assert _no_result(out.stdout)
    # the card's identity line comes before any JAX work
    assert out.stdout.splitlines()[0] == nvidia_smi_identity()


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert _no_result(out.stdout)


def test_corpus_lengths_are_read_speech_like():
    lens = chip_smoke.corpus_lengths()
    assert len(lens) == 16
    assert min(lens) == 2.0 and max(lens) == 35.0
    assert all(2.0 <= s <= 35.0 for s in lens)
    assert lens == chip_smoke.corpus_lengths()  # seeded


def test_phase_offline_tiny():
    out = chip_smoke.phase_offline(
        seconds=6.0, check_seconds=3.0, bench_seconds=12.0, acf_frames=200
    )
    assert out["feature_nmse_worst"] <= 1e-5
    assert out["f0_match_signal_vs_direct"] >= 0.999
    assert out["bench_call_vad_prefix_agreement"] >= 0.999


def test_phase_stream_tiny():
    out = chip_smoke.phase_stream(seconds=3.0)
    assert out["vad_flips_vs_engine_oracle"] == 0
    assert out["frames"] == 1 + (3 * 16000 - 320) // 160


def test_phase_http_tiny():
    out = chip_smoke.phase_http(
        clip_seconds=(1, 2), stream_seconds=1.5, expect_backend="cpu"
    )
    assert out["healthz"]["backend"] == "cpu"
    assert out["stream_blocks"] >= 1


def test_phase_batch_tiny():
    out = chip_smoke.phase_batch(lengths=[0.5, 1.0, 2.5, 3.0])
    assert out["files"] == 4
    assert out["vad_agreement"] == 1.0


def test_phase_mesh_tiny_on_virtual_devices():
    out = chip_smoke.phase_mesh(
        n_cards=4, long_seconds=4.0, lengths=[0.5, 1.0, 2.0, 3.0]
    )
    assert out["vad_flips"] == 0
    assert out["mesh"] == {"data": 2, "seq": 2}
    assert out["placement"]["batch_input"]["devices"] == 4
    assert not out["placement"]["batch_input"]["replicated"]


def test_check_raises_smoke_failure():
    with pytest.raises(chip_smoke.SmokeFailure, match="boom"):
        chip_smoke._check(False, "boom")
    assert chip_smoke._nmse(np.ones(4), np.ones(4)) == 0.0
