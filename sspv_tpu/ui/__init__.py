#!/usr/bin/env python3
"""Visualization layer: interactive Qt GUI with a headless fallback.

``VisualizationUI(runtime, title)`` keeps the reference's constructor and
``run()`` contract (ui/visualization.py:47, 606-613) and depends on the
runtime only through its 6-method duck-typed surface.
"""

from __future__ import annotations

import logging

from .files import collect_audio_files, default_audio_dir
from .headless import HeadlessVisualizer
from .plots import PlotModel, RangeTracker

logger = logging.getLogger(__name__)

__all__ = [
    "VisualizationUI",
    "HeadlessVisualizer",
    "PlotModel",
    "RangeTracker",
    "collect_audio_files",
    "default_audio_dir",
]


def _qt_available() -> bool:
    try:
        import pyqtgraph  # noqa: F401
        from pyqtgraph.Qt import QtWidgets  # noqa: F401

        return True
    except Exception:
        return False


class VisualizationUI:
    """Front-door UI class: Qt when available, headless otherwise."""

    def __init__(self, runtime, title: str = "Real-time speech processing",
                 headless: bool | None = None, **headless_kwargs):
        self.runtime = runtime
        use_headless = headless if headless is not None else not _qt_available()
        if not use_headless:
            try:
                from .qt import QtVisualizer

                self._impl = QtVisualizer(runtime, title=title)
                return
            except Exception:
                # importability is not startability: Qt bindings import fine
                # on a display-less host but QApplication construction fails
                # to load a platform plugin — fall back instead of dying
                logger.exception(
                    "Qt GUI failed to start; falling back to headless"
                )
        else:
            logger.info("pyqtgraph/Qt unavailable or headless requested; "
                        "using headless visualizer")
        self._impl = HeadlessVisualizer(runtime, title=title, **headless_kwargs)

    def run(self):
        return self._impl.run()
