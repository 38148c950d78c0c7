#!/usr/bin/env python3
"""Headless visualization backend.

Runs the same poll loop as the GUI (every ``Config.PLOT_UPDATE_INTERVAL`` ms)
against the runtime's 6-method contract, prints live status lines, and can
render the four stacked plots (waveform / energy / zcr / vad) to a PNG via
matplotlib (Agg) — the display-less stand-in for the reference's pyqtgraph
window (SURVEY.md §7 S6 "headless plot export").
"""

from __future__ import annotations

import logging
import time

import numpy as np

from ..config import Config
from .plots import PlotModel

logger = logging.getLogger(__name__)

__all__ = ["HeadlessVisualizer"]


class HeadlessVisualizer:
    """Poll-loop UI without a display.

    Parameters
    ----------
    runtime:
        Object honoring the runtime contract (start/stop/get_recent_audio/
        get_recent_processed/save_data, optional set_audio_source).
    duration:
        Seconds to run before stopping; None runs until the runtime stops
        itself (EOF auto-stop) or KeyboardInterrupt.
    snapshot_path:
        Where to write the final PNG (None skips rendering).
    """

    def __init__(self, runtime, title: str = "Real-time speech processing",
                 duration: float | None = None,
                 snapshot_path: str | None = "sspv_snapshot.png"):
        self.runtime = runtime
        self.title = title
        self.duration = duration
        self.snapshot_path = snapshot_path
        self.model = PlotModel(runtime)

    def run(self) -> None:
        interval = Config.PLOT_UPDATE_INTERVAL / 1000.0
        self.runtime.start()
        start = time.time()
        last_status = 0.0
        try:
            while self.runtime.is_running:
                if getattr(self.runtime, "last_error", None) is not None:
                    logger.error("runtime error: %s", self.runtime.last_error)
                    break
                self.model.poll()
                now = time.time()
                if now - last_status >= 1.0:
                    prog = self.model.progress()
                    logger.info(
                        "%s%s", self.model.summary(), f" [{prog}]" if prog else ""
                    )
                    last_status = now
                if self.duration is not None and now - start >= self.duration:
                    break
                time.sleep(interval)
        except KeyboardInterrupt:
            pass
        finally:
            self.runtime.stop()
            self.model.poll()
        if self.snapshot_path:
            try:
                self.render_png(self.snapshot_path)
            except Exception as e:
                # a missing matplotlib, an unwritable path, or any render
                # error must not crash the whole run at the very end — the
                # session's work is done; the snapshot degrades to a warning
                logger.warning("snapshot failed (%s): %s", type(e).__name__, e)

    def render_png(self, path: str) -> str:
        """Render the stacked plots to a PNG and return the path — the
        reference's 4 panels, plus a fifth F0 panel when the runtime has a
        real-time pitch track (``Config.TPU_ENGINE_PITCH``)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        m = self.model
        with_pitch = m.f0.size > 0
        rows = 5 if with_pitch else 4
        fig, axes = plt.subplots(
            rows, 1, figsize=(10, 9 if rows == 4 else 11), sharex=False
        )
        fig.suptitle(self.title)

        axes[0].plot(m.waveform, lw=0.5, color="#4fc3f7")
        axes[0].set_ylabel("waveform")
        axes[0].set_ylim(*m.ranges["waveform"])

        axes[1].plot(m.energies, lw=1.0, color="#ffb74d")
        axes[1].set_ylabel("energy")
        axes[1].set_ylim(*m.ranges["energy"])

        axes[2].plot(m.zcrs, lw=1.0, color="#aed581")
        axes[2].set_ylabel("zcr")
        axes[2].set_ylim(*m.ranges["zcr"])

        if m.vads.size:
            axes[3].fill_between(np.arange(m.vads.size), 0, m.vads,
                                 step="mid", color="#e57373", alpha=0.7)
        axes[3].set_ylabel("vad")
        axes[3].set_ylim(*m.ranges["vad"])

        if with_pitch:
            f0 = np.where(m.f0 > 0, m.f0, np.nan)  # gaps where unvoiced
            axes[4].plot(f0, ".-", ms=3, lw=0.8, color="#ba68c8")
            axes[4].set_ylabel("f0 (Hz)")
            voiced = m.f0[m.f0 > 0]
            top = float(np.max(voiced)) * 1.2 if voiced.size else 400.0
            axes[4].set_ylim(0.0, max(top, 50.0))
        axes[rows - 1].set_xlabel("frame")

        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
        logger.info("saved visualization snapshot: %s", path)
        return path
