#!/usr/bin/env python3
"""End-to-end check of the speech front-end on one GPU, at deployment sizes.

Runs the system's main paths once, through the entry points a user calls,
and compares each with the repository's plain references:

1. offline long-form: 3,600 s through ``FeaturePipeline.process_signal_device``
   (rows view) and ``pitch_track_signal_jit``, checked against the float64
   NumPy oracle on the first 600 s; one call at the bench length (57,600 s)
   with its peak device memory;
2. live stream: ``AudioRuntime`` over a 32 s WAV with engine pitch on,
   against the offline pipeline and ``tests/oracle.py:EngineVadOracle``;
3. HTTP: ``serve.py``'s server on a thread, clients on threads (urllib):
   ``/v1/features`` and ``/v1/pitch`` for 2/10/30/60 s clips, one chunked
   ``/v1/stream``, ``/healthz``;
4. corpus batch: ``python -m sspv_tpu.batch --pitch`` over 16 WAVs of 2-35 s;
5. on-card tests: the ``gpu``-marked pytest tests, in this process.

``--cards 4`` runs only the four-card mesh phase: ``BatchPipeline`` on
``make_mesh(4)`` against ``make_mesh(1)`` on device 0.

Everything runs in ONE process (the server and its clients are threads), so
one process holds the card. Each phase prints one line with what it
compared, the worst error and the tolerance; a failed phase makes the exit
code non-zero. The last line is ``{"ok": true, "device": {...}}``. Exits
non-zero before any phase when JAX finds no GPU.

    python chip_smoke.py [--cards 4]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import threading
import time
import traceback
import wave

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SR = 16000


class SmokeFailure(AssertionError):
    """A comparison fell outside its tolerance."""


def _check(ok: bool, what: str) -> None:
    """A precondition of the rest of the phase: fail at once."""
    if not ok:
        raise SmokeFailure(what)


class _Phase:
    """Collects a phase's tolerance checks, so its line reports every
    number even when one of them is out of tolerance."""

    def __init__(self, name: str):
        self.name = name
        self.failures: list[str] = []

    def expect(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)

    def finish(self, out: dict) -> dict:
        _report(self.name, ok=not self.failures, failures=self.failures,
                **out)
        if self.failures:
            raise SmokeFailure("; ".join(self.failures))
        return out


def _nmse(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / max(np.mean(want ** 2), 1e-12))


def _report(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _imports():
    """Repo modules (the oracle lives with the tests)."""
    for p in (REPO, os.path.join(REPO, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import bench
    import oracle

    return bench, oracle


def _pipeline():
    from sspv_tpu.config import Config
    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline

    return FeaturePipeline(FeatureConfig.from_config(Config))


def _wav_bytes(samples: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.asarray(samples, "<i2").tobytes())
    return buf.getvalue()


def _clip_i16(seconds: float, seed: int) -> np.ndarray:
    bench, _ = _imports()
    sig = bench.synth_signal(seconds, SR, seed=seed)
    return np.clip(np.round(sig), -32768, 32767).astype(np.int16)


def _vad_agreement(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    n = min(a.shape[0], b.shape[0])
    return float(np.mean(a[:n] == b[:n])) if n else 1.0


def _vad_tolerance(precision: str) -> float:
    """Exact decisions at float32 ("highest"); otherwise a frame within
    rounding of a threshold may flip between two programs that accumulate
    in different orders, so 99.9 % agreement."""
    from sspv_tpu.ops.precision import resolve

    import jax

    return 1.0 if resolve(precision) == jax.lax.Precision.HIGHEST else 0.999


# ---------------------------------------------------------------------------
# phase 1: offline long-form
# ---------------------------------------------------------------------------


def phase_offline(seconds=3600.0, check_seconds=600.0, bench_seconds=57600.0,
                  acf_frames=4000) -> dict:
    import jax

    bench, _ = _imports()
    from sspv_tpu.ops.pitch import (
        pitch_from_frames, pitch_track_signal_jit,
    )
    from sspv_tpu.ops.time_features import autocorrelation_via_dft

    ph = _Phase("offline")
    check_seconds = min(check_seconds, seconds)
    pipe = _pipeline()
    c = pipe.cfg
    sig = bench.synth_signal(seconds, SR)
    t0 = time.perf_counter()
    block, _ = pipe.process_signal_device(sig)
    jax.block_until_ready(block)
    feat_s = time.perf_counter() - t0
    n = int(block.vad.shape[0])
    _check(n == 1 + (len(sig) - c.frame_size) // c.hop_size, "frame count")
    for k in ("energy", "zcr", "entropy", "mfcc"):
        _check(bool(np.all(np.isfinite(np.asarray(getattr(block, k))))),
               f"non-finite {k}")

    # features vs the float64 oracle on the first check_seconds
    vf = 1 + (int(check_seconds * SR) - c.frame_size) // c.hop_size
    want = bench._oracle_features(sig[: int(check_seconds * SR)])
    nmse = {k: _nmse(np.asarray(getattr(block, k))[:vf], want[k])
            for k in ("energy", "zcr", "entropy", "mfcc")}
    worst = max(nmse.values())
    ph.expect(worst <= 1e-5, f"feature NMSE {nmse} > 1e-5")

    # pitch on the same signal (rows view), gated on the pipeline's VAD
    pitch_fn = pitch_track_signal_jit(precision=c.precision)
    rows = pipe.host_rows_view(sig)
    f0, conf = pitch_fn(rows, block.vad, np.float32(0.3))
    f0 = np.asarray(f0)
    _check(f0.shape == (n,) and bool(np.all(np.isfinite(f0))), "f0 shape")

    # ACF: matmul (Wiener-Khinchin) form vs the direct sliding-sum oracle
    frames = bench._frame_raw(sig[: int(check_seconds * SR)])
    pf = frames[:acf_frames]
    lag_max = c.frame_size - 1
    acf_nmse = _nmse(autocorrelation_via_dft(pf, lag_max),
                     bench._oracle_acf(pf, lag_max))
    ph.expect(acf_nmse <= 1e-5, f"ACF NMSE {acf_nmse} > 1e-5")

    # F0: the shipped signal path (view, matmul ACF, pipeline precision)
    # ungated, vs the frames path with the direct sliding-sum ACF. A tie
    # between two ACF lags within rounding may pick a different lag.
    ones = np.ones((vf,), np.int32)
    f0_sig, _ = pitch_fn(pipe.host_rows_view(sig[: int(check_seconds * SR)]),
                         ones, np.float32(-np.inf))
    f0_direct, _ = pitch_from_frames(frames, SR, acf_impl="direct")
    f0_dft, _ = pitch_from_frames(frames, SR, acf_impl="dft")
    match_sig = float(np.mean(np.asarray(f0_sig) == np.asarray(f0_direct)))
    match_frames = float(np.mean(np.asarray(f0_dft) == np.asarray(f0_direct)))
    ph.expect(min(match_sig, match_frames) >= 0.999,
              f"F0 impl-match signal={match_sig} frames={match_frames}")

    # one call at the bench length: tiled copies of the signal (contents
    # only need to be real audio-like data; the buffer size is the point)
    long_sig = np.tile(sig, int(np.ceil(bench_seconds / seconds)))
    long_sig = long_sig[: int(bench_seconds * SR)]
    t0 = time.perf_counter()
    block_l, _ = pipe.process_signal_device(long_sig)
    jax.block_until_ready(block_l)
    long_s = time.perf_counter() - t0
    nl = int(block_l.vad.shape[0])
    _check(nl == 1 + (len(long_sig) - c.frame_size) // c.hop_size,
           "long frame count")
    long_agree = _vad_agreement(block_l.vad, block.vad)
    ph.expect(bool(np.all(np.isfinite(np.asarray(block_l.mfcc)))),
              "non-finite long mfcc")
    ph.expect(long_agree >= 0.999, f"long-call VAD prefix agreement {long_agree}")
    stats = jax.devices()[0].memory_stats() or {}
    out = {
        "compared": "view-path features vs float64 oracle (first "
                    f"{check_seconds:g} s of {seconds:g} s); matmul ACF vs "
                    "direct ACF; signal-path F0 vs direct-ACF F0",
        "precision": c.precision,
        "feature_nmse": nmse, "feature_nmse_worst": worst,
        "feature_nmse_tol": 1e-5,
        "acf_nmse": acf_nmse, "acf_nmse_tol": 1e-5,
        "f0_match_signal_vs_direct": match_sig,
        "f0_match_frames_dft_vs_direct": match_frames, "f0_match_tol": 0.999,
        "f0_slack": "two ACF lags within rounding of each other may pick "
                    "different F0 (TF32 at 'high')",
        "voiced_frames": int(np.sum(f0 > 0)),
        "first_call_s": feat_s,
        "bench_length_s": bench_seconds, "bench_call_first_s": long_s,
        "bench_call_vad_prefix_agreement": long_agree,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }
    return ph.finish(out)


# ---------------------------------------------------------------------------
# phase 2: live stream through AudioRuntime
# ---------------------------------------------------------------------------


def phase_stream(seconds=32.0) -> dict:
    from sspv_tpu.config import Config
    from sspv_tpu.ops.pitch import pitch_track
    from sspv_tpu.runtime import AudioRuntime
    from sspv_tpu.runtime.audio_source import FileAudioSource

    _, oracle = _imports()
    ph = _Phase("stream")
    samples = _clip_i16(seconds, seed=1)
    saved = {k: getattr(Config, k) for k in
             ("TPU_ENGINE_PITCH", "PROCESSED_DATA_BUFFER_SIZE")}
    with tempfile.TemporaryDirectory(prefix="sspv_smoke_stream_") as tmp:
        path = os.path.join(tmp, "stream.wav")
        with open(path, "wb") as f:
            f.write(_wav_bytes(samples))
        try:
            Config.TPU_ENGINE_PITCH = True
            Config.PROCESSED_DATA_BUFFER_SIZE = 10 ** 7
            rt = AudioRuntime(
                audio_source=FileAudioSource(path, sample_rate=SR))
            rt.auto_stop_on_eof = True
            rt.start()
            deadline = time.time() + 300
            while rt.is_running and time.time() < deadline:
                time.sleep(0.05)
            rt.stop()
            _check(rt.last_error is None, f"engine error {rt.last_error!r}")
            with rt.lock:
                rows = list(rt.processed_data)
            f0_eng, _ = rt.get_recent_pitch(max_display=10 ** 7)
        finally:
            for k, v in saved.items():
                setattr(Config, k, v)

    pipe = _pipeline()
    c = pipe.cfg
    n_want = 1 + (len(samples) - c.frame_size) // c.hop_size
    n = len(rows)
    _check(n == n_want, f"engine frames {n} != {n_want}")
    e = np.array([r["energy"] for r in rows], np.float64)
    z = np.array([r["zcr"] for r in rows], np.float64)
    h = np.array([r["spec_entropy"] for r in rows], np.float64)
    vad = np.array([r["vad"] for r in rows], np.int32)

    block, _ = pipe.process_signal(samples)
    agree = _vad_agreement(vad, block.vad)
    tol = _vad_tolerance(c.precision)
    ph.expect(agree >= tol, f"engine vs offline VAD agreement {agree} < {tol}")

    ref = oracle.EngineVadOracle(
        energy_threshold=Config.ENERGY_THRESHOLD,
        zcr_threshold=Config.ZCR_THRESHOLD,
        entropy_voice_max=Config.SPECTRAL_ENTROPY_VOICE_MAX,
        use_adaptive=Config.USE_ADAPTIVE_VAD,
        alpha_raw=Config.ADAPTIVE_VAD_ENERGY_K,
        hangover_on=Config.VAD_HANGOVER_ON,
        release_off=Config.VAD_RELEASE_OFF,
    )
    want_vad, _ = ref.run_all(e, z, h)
    oracle_flips = int(np.sum(want_vad != vad))
    ph.expect(oracle_flips == 0,
              f"engine VAD differs from EngineVadOracle in {oracle_flips} frames")

    frames = pipe.stream_frames(samples)[:n]
    want_f0, _ = pitch_track(frames, vad, acf_impl="dft",
                             min_confidence=Config.TPU_ENGINE_PITCH_MIN_CONF)
    f0_match = float(np.mean(np.asarray(f0_eng) == np.asarray(want_f0)))
    ph.expect(f0_match >= 0.999, f"engine F0 match {f0_match} < 0.999")
    # the engine's samples dispatch computes energy on the view path, where
    # it is a matmul at the pipeline precision: the repo's parity gate
    energy_nmse = _nmse(e, block.energy)
    ph.expect(energy_nmse <= 1e-5, f"engine energy NMSE {energy_nmse}")
    out = {
        "compared": f"AudioRuntime over a {seconds:g} s WAV (engine pitch "
                    "on) vs offline process_signal and EngineVadOracle fed "
                    "the engine's own features",
        "precision": c.precision, "frames": n,
        "vad_agreement_vs_offline": agree, "vad_agreement_tol": tol,
        "vad_slack": "below 'highest', a frame within rounding of a "
                     "threshold may flip between the view and frames paths",
        "vad_flips_vs_engine_oracle": oracle_flips, "oracle_flips_tol": 0,
        "energy_nmse_vs_offline": energy_nmse, "energy_nmse_tol": 1e-5,
        "f0_match_vs_frames_track": f0_match, "f0_match_tol": 0.999,
    }
    return ph.finish(out)


# ---------------------------------------------------------------------------
# phase 3: HTTP
# ---------------------------------------------------------------------------


def _post(url: str, body, content_type: str) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def phase_http(clip_seconds=(2, 10, 30, 60), stream_seconds=10.0,
               expect_backend="gpu") -> dict:
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from sspv_tpu.serve import FeatureService, make_server

    ph = _Phase("http")
    svc = FeatureService(_pipeline())
    pipe = svc.pipe
    server = make_server("127.0.0.1", 0, service=svc)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = "http://%s:%d" % server.server_address[:2]
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=300) as r:
            health = json.loads(r.read())
        _check(health.get("status") == "ok"
               and health.get("backend") == expect_backend,
               f"/healthz {health}")

        clips = {s: _clip_i16(s, seed=10 + i)
                 for i, s in enumerate(clip_seconds)}

        def request(s):
            wav = _wav_bytes(clips[s])
            return (s, _post(base + "/v1/features", wav, "audio/wav"),
                    _post(base + "/v1/pitch", wav, "audio/wav"))

        with ThreadPoolExecutor(max_workers=len(clips)) as pool:
            answers = list(pool.map(request, clips))

        worst_feat, worst_nmse, worst_f0, vad_flips = 0.0, 0.0, 1.0, 0
        n_frames = 0
        for s, feat, pitch in answers:
            sig = clips[s]
            block, _ = pipe.process_signal_auto(sig)
            pblock, _, f0, _ = pipe.process_signal_pitch_auto(sig)
            _check(feat["num_frames"] == int(block.vad.shape[0]),
                   f"{s} s frame count")
            vad_flips += int(np.sum(np.asarray(feat["vad"])
                                    != np.asarray(block.vad)))
            vad_flips += int(np.sum(np.asarray(pitch["vad"])
                                    != np.asarray(pblock.vad)))
            n_frames += 2 * int(block.vad.shape[0])
            for k in ("energy", "zcr", "entropy", "mfcc"):
                got = np.asarray(feat[k], np.float32)
                want = np.asarray(getattr(block, k))
                worst_feat = max(worst_feat, float(np.max(np.abs(got - want))))
                worst_nmse = max(worst_nmse, _nmse(got, want))
            worst_f0 = min(worst_f0, float(np.mean(
                np.asarray(pitch["f0"], np.float32) == np.asarray(f0))))
        # the same compiled programs on the same samples; the GPU backend
        # does not promise bitwise-equal reductions from run to run, so the
        # check allows last-bit differences and a decision flip at a tie
        http_agree = 1.0 - vad_flips / max(n_frames, 1)
        ph.expect(worst_nmse <= 1e-10 and http_agree >= 0.999
                  and worst_f0 >= 0.999,
                  f"HTTP vs library: nmse={worst_nmse} vad agreement="
               f"{http_agree} f0_match={worst_f0}")

        # chunked /v1/stream, 10 ms client chunks
        stream = _clip_i16(stream_seconds, seed=20)
        raw = stream.astype("<i2").tobytes()
        chunk = 2 * SR // 100

        def body():
            for lo in range(0, len(raw), chunk):
                yield raw[lo: lo + chunk]

        req = urllib.request.Request(
            base + "/v1/stream", data=body(), method="POST",
            headers={"Content-Type": "application/octet-stream",
                     "Transfer-Encoding": "chunked"})
        with urllib.request.urlopen(req, timeout=300) as r:
            lines = [json.loads(x) for x in r.read().decode().splitlines()
                     if x.strip()]
        _check(lines and lines[-1].get("done") is True, "stream not done")
        rows = lines[:-1]
        s_vad = np.array([v for r in rows for v in r["vad"]], np.int32)
        s_e = np.array([v for r in rows for v in r["energy"]], np.float64)
        sblock, _ = pipe.process_signal(stream)
        n = int(sblock.vad.shape[0])
        _check(s_vad.shape[0] == n, f"stream frames {s_vad.shape[0]} != {n}")
        s_agree = _vad_agreement(s_vad, sblock.vad)
        tol = _vad_tolerance(pipe.cfg.precision)
        s_nmse = _nmse(s_e, sblock.energy)
        ph.expect(s_agree >= tol and s_nmse <= 1e-5,
                  f"stream vs offline: vad agreement {s_agree}, energy nmse "
                  f"{s_nmse}")
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    out = {
        "compared": "/v1/features and /v1/pitch for "
                    f"{list(clip_seconds)} s WAV clips (concurrent client "
                    "threads) vs the same library calls; chunked /v1/stream "
                    "vs offline process_signal; /healthz backend",
        "healthz": health,
        "features_max_abs_diff": worst_feat,
        "features_nmse_worst": worst_nmse, "features_nmse_tol": 1e-10,
        "vad_flips": vad_flips, "vad_agreement": http_agree,
        "vad_agreement_tol": 0.999,
        "pitch_f0_match": worst_f0, "pitch_f0_match_tol": 0.999,
        "stream_blocks": len(rows), "stream_vad_agreement": s_agree,
        "stream_vad_tol": tol, "stream_energy_nmse": s_nmse,
        "stream_energy_nmse_tol": 1e-5,
    }
    return ph.finish(out)


# ---------------------------------------------------------------------------
# phase 4: corpus batch CLI
# ---------------------------------------------------------------------------


def corpus_lengths(n_files=16, lo=2.0, hi=35.0, seed=7) -> list[float]:
    """Read-speech-like utterance lengths in [lo, hi] seconds (LibriSpeech
    segments run up to ~35 s), drawn from a seed, with both ends present."""
    rng = np.random.default_rng(seed)
    mid = rng.uniform(lo, hi, max(n_files - 2, 0))
    return [lo] + [round(float(x), 2) for x in mid] + [hi][: n_files - 1]


def phase_batch(lengths=None) -> dict:
    from sspv_tpu import batch

    ph = _Phase("batch")
    lengths = corpus_lengths() if lengths is None else lengths
    sigs = {f"utt{i:02d}": _clip_i16(s, seed=100 + i)
            for i, s in enumerate(lengths)}
    npz = {}
    with tempfile.TemporaryDirectory(prefix="sspv_smoke_corpus_") as tmp:
        src, out_dir = os.path.join(tmp, "wav"), os.path.join(tmp, "npz")
        os.makedirs(src)
        for name, sig in sigs.items():
            with open(os.path.join(src, name + ".wav"), "wb") as f:
                f.write(_wav_bytes(sig))
        rc = batch.main([src, "--out-dir", out_dir, "--pitch", "--batch",
                         "8", "--jsonl", os.path.join(tmp, "summary.jsonl")])
        _check(rc == 0, f"batch.main rc={rc}")
        for name in sigs:
            with np.load(os.path.join(out_dir, name + ".npz")) as d:
                npz[name] = {k: d[k] for k in d.files}

    pipe = _pipeline()
    flips, total, worst_nmse, f0_eq, f0_n = 0, 0, 0.0, 0, 0
    for name, sig in sigs.items():
        got = npz[name]
        block, _ = pipe.process_signal(sig)
        n = int(block.vad.shape[0])
        _check(got["vads"].shape == (n,), f"{name} frames")
        flips += int(np.sum(got["vads"] != np.asarray(block.vad)))
        total += n
        for gk, bk in (("energies", "energy"), ("zcrs", "zcr"),
                       ("spec_entropy", "entropy"), ("mfcc", "mfcc")):
            worst_nmse = max(worst_nmse,
                             _nmse(got[gk], getattr(block, bk)))
        f0, _ = pipe.pitch_signal_auto(sig, got["vads"])
        f0_eq += int(np.sum(got["f0"] == np.asarray(f0)))
        f0_n += n
    agree = 1.0 - flips / max(total, 1)
    f0_match = f0_eq / max(f0_n, 1)
    tol = _vad_tolerance(pipe.cfg.precision)
    ph.expect(agree >= tol and worst_nmse <= 1e-6 and f0_match >= 0.999,
              f"batch vs per-file: vad agreement {agree}, worst nmse "
              f"{worst_nmse}, f0 match {f0_match}")
    out = {
        "compared": f"sspv_tpu.batch --pitch over {len(lengths)} WAVs of "
                    f"{min(lengths):g}-{max(lengths):g} s vs process_signal "
                    "(+ pitch_signal_auto) on each file alone",
        "files": len(lengths), "frames": total,
        "vad_agreement": agree, "vad_tol": tol,
        "feature_nmse_worst": worst_nmse, "feature_nmse_tol": 1e-6,
        "f0_match": f0_match, "f0_match_tol": 0.999,
    }
    return ph.finish(out)


# ---------------------------------------------------------------------------
# phase 5: gpu-marked tests
# ---------------------------------------------------------------------------


def phase_card_tests() -> dict:
    import pytest

    os.environ["SSPV_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_on_card.py")])
    ph = _Phase("card_tests")
    ph.expect(rc == 0, f"gpu-marked tests rc={int(rc)}")
    return ph.finish({"compared": "pytest -m gpu (tests that need the card)",
                      "rc": int(rc)})


# ---------------------------------------------------------------------------
# --cards 4: the mesh against one device
# ---------------------------------------------------------------------------


def phase_mesh(n_cards=4, long_seconds=3600.0, lengths=None) -> dict:
    import jax
    from jax.sharding import Mesh

    bench, _ = _imports()
    from sspv_tpu.config import Config
    from sspv_tpu.ops.pipeline import FeatureConfig
    from sspv_tpu.parallel import BatchPipeline, make_mesh

    ph = _Phase("mesh")
    devices = jax.devices()
    _check(len(devices) >= n_cards, f"{len(devices)} devices < {n_cards}")
    cfg = FeatureConfig.from_config(Config)
    bp_n = BatchPipeline(make_mesh(n_cards), cfg)
    bp_1 = BatchPipeline(Mesh(np.array(devices[:1]).reshape(1, 1),
                              ("data", "seq")), cfg)

    lengths = corpus_lengths() if lengths is None else lengths
    sigs = [_clip_i16(s, seed=100 + i) for i, s in enumerate(lengths)]
    L = max(len(s) for s in sigs)
    batch = np.zeros((len(sigs), L), np.int16)
    lens = np.array([len(s) for s in sigs], np.int32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    long_sig = bench.synth_signal(long_seconds, SR)

    def spans(x) -> int:
        return len(x.sharding.device_set)

    worst_nmse, worst_f0, vad_flips, placement = 0.0, 1.0, 0, {}
    runs = {
        "batch_masked_pitch": lambda bp: bp.process_batch_masked_pitch(
            batch, lens),
        "long": lambda bp: bp.process_long(long_sig),
        "long_pitch": lambda bp: bp.process_long_pitch(long_sig),
    }
    for name, run in runs.items():
        out_n = run(bp_n)
        jax.block_until_ready(out_n)
        out_1 = run(bp_1)
        jax.block_until_ready(out_1)
        blk_n, blk_1 = out_n[0], out_1[0]
        placement[name] = {
            "output_devices": spans(blk_n.energy),
            "output_replicated": bool(blk_n.energy.sharding.is_fully_replicated),
        }
        ph.expect(spans(blk_n.energy) == n_cards, f"{name}: output on "
                  f"{spans(blk_n.energy)} devices, not {n_cards}")
        vad_flips += int(np.sum(np.asarray(blk_n.vad) != np.asarray(blk_1.vad)))
        vad_flips += int(np.sum(np.asarray(blk_n.vad_adaptive)
                                != np.asarray(blk_1.vad_adaptive)))
        for k in ("energy", "zcr", "entropy", "mfcc"):
            worst_nmse = max(worst_nmse, _nmse(getattr(blk_n, k),
                                               getattr(blk_1, k)))
        if len(out_n) == 4:
            worst_f0 = min(worst_f0, float(np.mean(
                np.asarray(out_n[2]) == np.asarray(out_1[2]))))
    # where the inputs live: the compiled programs' input shardings
    key_b = ("batch_masked_pitch", batch.shape, 50.0, 400.0)
    comp_b = bp_n._batch_jit[key_b].lower(
        batch, lens, bp_n.initial_states(len(sigs)), np.float32(0.3)
    ).compile()
    comp_l = bp_n._batch_jit[("long", long_sig.shape)].lower(
        long_sig, bp_n.pipe.initial_state()).compile()
    in_b, in_l = comp_b.input_shardings[0][0], comp_l.input_shardings[0][0]
    placement["batch_input"] = {
        "devices": len(in_b.device_set),
        "replicated": bool(in_b.is_fully_replicated)}
    placement["long_input"] = {
        "devices": len(in_l.device_set),
        "replicated": bool(in_l.is_fully_replicated)}
    ph.expect(len(in_b.device_set) == n_cards
              and not in_b.is_fully_replicated, f"batch input sharding {in_b}")
    ph.expect(len(in_l.device_set) == n_cards, f"long input sharding {in_l}")
    ph.expect(vad_flips == 0 and worst_nmse <= 1e-6 and worst_f0 >= 0.999,
              f"mesh vs one device: vad flips {vad_flips}, nmse {worst_nmse}, "
           f"f0 match {worst_f0}")
    out = {
        "compared": f"BatchPipeline on make_mesh({n_cards}) vs a 1-device "
                    "mesh: process_batch_masked_pitch over "
                    f"{len(lengths)} files, process_long and "
                    f"process_long_pitch over {long_seconds:g} s",
        "mesh": dict(bp_n.mesh.shape),
        "vad_flips": vad_flips, "vad_flips_tol": 0,
        "feature_nmse_worst": worst_nmse, "feature_nmse_tol": 1e-6,
        "f0_match_worst": worst_f0, "f0_match_tol": 0.999,
        "placement": placement,
    }
    return ph.finish(out)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card mesh phase")
    args = ap.parse_args(argv)

    from sspv_tpu.utils.device import nvidia_smi_identity, require_gpu

    # the card's name and power limit exactly as nvidia-smi prints them
    print(nvidia_smi_identity(), flush=True)
    device = require_gpu()
    print(f"device: {device['kind']} x{device['count']} "
          f"({device['platform']})", flush=True)

    import jax

    from sspv_tpu.config import Config
    from sspv_tpu.utils.cache import enable_persistent_cache

    print(f"compile cache: {enable_persistent_cache()}", flush=True)
    print(f"precision: {Config.TPU_MATMUL_PRECISION}", flush=True)

    if args.cards == 4:
        phases = [("mesh", phase_mesh)]
    else:
        phases = [("offline", phase_offline), ("stream", phase_stream),
                  ("http", phase_http), ("batch", phase_batch),
                  ("card_tests", phase_card_tests)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report every phase, then exit non-zero
            failed.append(name)
            _report(name, ok=False, error=f"{type(e).__name__}: {e}")
            traceback.print_exc()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": 4 if args.cards == 4 else len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
