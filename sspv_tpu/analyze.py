#!/usr/bin/env python3
"""Offline single-file analyzer.

The reference's README documents an ``analyze_file.py`` utility that is
absent from its snapshot (SURVEY.md §2 note); this module provides that
capability on the device pipeline: decode a file, run the fused
frame→feature→VAD pipeline in one device call, print a summary, and
optionally render the four-plot PNG and export the features.

    python -m sspv_tpu.analyze INPUT [--png OUT.png] [--npz OUT.npz]
"""

from __future__ import annotations

import argparse

import numpy as np

from .config import Config
from .utils.export import export_features_npz, summarize_features


def analyze_file(path: str, png: str | None = None, npz: str | None = None) -> dict:
    import jax

    from .ops.pipeline import FeatureConfig, FeaturePipeline
    from .runtime.audio_source import FileAudioSource

    src = FileAudioSource(path, sample_rate=Config.SAMPLE_RATE)
    src.open()
    pcm = src.read(1 << 62)
    src.close()

    pipe = FeaturePipeline(FeatureConfig.from_config(Config))
    # bucketed-length path (files of any length share a few compiled
    # programs), fused with the signal-view pitch track: features + VAD +
    # VAD-gated F0 in ONE device dispatch — the ACF spectrum comes from
    # hop-phase matmuls on the already-shipped int16 signal, and the signal
    # transfers once instead of twice.
    block, _, f0, conf = pipe.process_signal_pitch_auto(pcm)
    jax.block_until_ready(block)

    energy = np.asarray(block.energy)
    zcr = np.asarray(block.zcr)
    entropy = np.asarray(block.entropy)
    vad = np.asarray(block.vad)
    mfcc = np.asarray(block.mfcc)

    # shared summary fields + npz schema with the batch CLI (utils/export.py)
    sl = {
        "energy": energy, "zcr": zcr, "entropy": entropy, "vad": vad,
        "vad_adaptive": np.asarray(block.vad_adaptive), "mfcc": mfcc,
        "f0": f0, "pitch_confidence": conf,
    }
    summary = summarize_features(path, len(pcm), sl, Config.SAMPLE_RATE)

    if npz:
        export_features_npz(
            npz, sl, Config.SAMPLE_RATE, Config.FRAME_SIZE, Config.HOP_SIZE
        )
        summary["npz"] = npz

    if png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(5, 1, figsize=(11, 10))
        fig.suptitle(f"sspv_tpu analysis: {path}")
        axes[0].plot(pcm, lw=0.3, color="#4fc3f7")
        axes[0].set_ylabel("waveform")
        axes[1].plot(energy, lw=0.8, color="#ffb74d")
        axes[1].set_ylabel("energy")
        axes[2].plot(zcr, lw=0.8, color="#aed581")
        axes[2].set_ylabel("zcr")
        axes[3].fill_between(np.arange(vad.size), 0, vad, step="mid",
                             color="#e57373", alpha=0.7)
        axes[3].set_ylabel("vad")
        masked = np.where(f0 > 0, f0, np.nan)
        axes[4].plot(masked, ".", ms=2, color="#ba68c8")
        axes[4].set_ylabel("f0 (Hz)")
        axes[4].set_xlabel("frame")
        fig.tight_layout()
        fig.savefig(png, dpi=100)
        plt.close(fig)
        summary["png"] = png

    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input", help="audio file to analyze")
    parser.add_argument("--png", help="render plots to this PNG")
    parser.add_argument("--npz", help="export features to this npz")
    args = parser.parse_args(argv)

    Config.setup_logging()
    # same override layers as every sibling CLI (main/batch/serve): without
    # these, RTP_ knobs silently change results between `analyze` and `batch`
    # runs of the same file.
    import os

    yaml_path = os.environ.get("RTP_CONFIG_YAML")
    if yaml_path:
        Config.load_from_yaml(yaml_path)
    Config.load_from_env(prefix="RTP_")
    Config.setup_logging()  # re-apply a LOG_LEVEL override
    from .utils.cache import enable_persistent_cache

    enable_persistent_cache()
    summary = analyze_file(args.input, png=args.png, npz=args.npz)
    import json

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
