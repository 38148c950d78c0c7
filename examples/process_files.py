#!/usr/bin/env python3
"""Batch-process a directory of audio files into per-file feature exports.

Production-style offline pipeline: decode all files host-side, then run the
fused frame→MFCC→VAD pipeline. With more than one device (and >1 file) the
files are zero-padded to a common length and processed **data-parallel over
the device mesh** via ``sspv_tpu.parallel.BatchPipeline``; per-file outputs
are truncated back to each file's own frame count (padding follows the real
audio, so it cannot affect preceding frames' adaptive state). Single device
falls back to sequential per-file processing.

    python examples/process_files.py INPUT_DIR [OUTPUT_DIR]

Writes ``<name>.features.npz`` per input file with keys
``energies, zcrs, vads, spec_entropy, vads_adaptive, mfcc, f0, sample_rate,
frame_size, hop_size`` (the engine's export schema plus MFCC and pitch).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def _decode(path, sample_rate):
    from sspv_tpu.runtime.audio_source import FileAudioSource

    src = FileAudioSource(path, sample_rate=sample_rate)
    src.open()
    pcm = src.read(1 << 62)
    src.close()
    return pcm


# The sharded path materializes a dense (batch, max_len) float32 matrix; keep
# it bounded so one long outlier file can't OOM the host.
_SHARDED_MATRIX_LIMIT_BYTES = 2 << 30


def _blocks_sequential(pipe, files, sample_rate):
    """Bounded-memory path: decode and process one file at a time."""
    import jax

    for path in files:
        pcm = _decode(path, sample_rate)
        block, _ = pipe.process_signal_auto(pcm)
        jax.block_until_ready(block)
        yield pcm, block


def _blocks_sharded(pipe, files, sample_rate, hop, frame):
    """Mesh-sharded batch path: decode all, pad to a common length and a
    mesh-divisible batch, then slice each file's rows back out. Falls back to
    the sequential generator when the padded matrix would be too large."""
    import jax

    from sspv_tpu.parallel import BatchPipeline, make_mesh

    pcms = [_decode(p, sample_rate) for p in files]
    mesh = make_mesh()
    dp = mesh.devices.shape[0]
    max_len = max(len(p) for p in pcms)
    b = -(-len(pcms) // dp) * dp
    if b * max_len * 4 > _SHARDED_MATRIX_LIMIT_BYTES:
        print("padded batch too large for the sharded path; going sequential")
        for path, pcm in zip(files, pcms):
            # bucketed-compile path (one program per bucket, not per file
            # length); ships int16
            block, _ = pipe.process_signal_auto(pcm)
            jax.block_until_ready(block)
            yield pcm, block
        return
    bp = BatchPipeline(mesh, pipe.cfg)
    # masked batch API: padded frames are masked out of each signal's VAD
    # state on device, so there is no hand-rolled truncation arithmetic to
    # keep in sync with the framing formula (the per-file frame counts below
    # are only used to slice the outputs back out)
    signals = np.zeros((b, max_len), dtype=np.int16)
    for i, pcm in enumerate(pcms):
        signals[i, : len(pcm)] = np.asarray(pcm, np.int16)
    lengths = np.array([len(p) for p in pcms] + [0] * (b - len(pcms)), np.int32)
    batch_block, _ = bp.process_batch_masked(signals, lengths)
    batch_block = jax.device_get(batch_block)
    for i, pcm in enumerate(pcms):
        nf = max(0, 1 + (len(pcm) - frame) // hop) if len(pcm) >= frame else 0
        yield pcm, type(batch_block)(*(x[i][:nf] for x in batch_block))


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    in_dir = argv[0]
    out_dir = argv[1] if len(argv) > 1 else in_dir

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    from sspv_tpu.config import Config
    from sspv_tpu.ops.pipeline import FeatureConfig, FeaturePipeline
    from sspv_tpu.ui.files import collect_audio_files
    from sspv_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    files = collect_audio_files(in_dir)
    if not files:
        print(f"no supported audio files in {in_dir}")
        return 1
    os.makedirs(out_dir, exist_ok=True)

    pipe = FeaturePipeline(FeatureConfig.from_config(Config))
    total_audio = 0.0

    t_start = time.perf_counter()
    sharded = len(jax.devices()) > 1 and len(files) > 1
    blocks = (
        _blocks_sharded(pipe, files, Config.SAMPLE_RATE, Config.HOP_SIZE,
                        Config.FRAME_SIZE)
        if sharded
        else _blocks_sequential(pipe, files, Config.SAMPLE_RATE)
    )
    for path, (pcm, block) in zip(files, blocks):
        total_audio += len(pcm) / Config.SAMPLE_RATE
        # the single production pitch path (analyze CLI, batch CLI, serving
        # layer): bucketed jitted signal-view track, int16 shipped to the
        # device, no host frame matrix — exported f0 matches the serving
        # layer's output for the same file
        f0, _conf = pipe.pitch_signal_auto(pcm, np.asarray(block.vad))
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(out_dir, f"{name}.features.npz")
        np.savez(
            out,
            energies=np.asarray(block.energy, np.float64),
            zcrs=np.asarray(block.zcr, np.float64),
            vads=np.asarray(block.vad, np.int32),
            spec_entropy=np.asarray(block.entropy, np.float32),
            vads_adaptive=np.asarray(block.vad_adaptive, np.float32),
            mfcc=np.asarray(block.mfcc, np.float32),
            f0=np.asarray(f0, np.float32),
            sample_rate=np.int32(Config.SAMPLE_RATE),
            frame_size=np.int32(Config.FRAME_SIZE),
            hop_size=np.int32(Config.HOP_SIZE),
        )
        print(f"{path}: {np.asarray(block.energy).shape[0]} frames -> {out}")

    elapsed = time.perf_counter() - t_start
    if elapsed > 0:
        mode = "mesh-sharded" if sharded else "sequential"
        print(
            f"processed {total_audio:.1f}s of audio in {elapsed:.2f}s "
            f"({total_audio/elapsed:.1f}x real-time, {mode}, incl. compile)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
