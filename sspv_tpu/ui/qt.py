#!/usr/bin/env python3
"""Qt/pyqtgraph visualization backend (interactive GUI).

Functional equivalent of the reference GUI (ui/visualization.py): four
stacked live plots (waveform, short-time energy, ZCR, VAD; a fifth F0 panel
appears lazily when the runtime streams pitch data — ``TPU_ENGINE_PITCH``,
mirroring the headless backend's conditional panel), a settings group
for source selection (microphone / auto-scan of the default audio directory /
custom file-or-directory path, test-all vs test-one), auto-stop-on-EOF and
auto-range toggles, start/stop/save controls with status + playlist progress
+ running summary labels, a 50 ms poll timer, and an EOF completion prompt.

Requires ``pyqtgraph`` + a Qt binding; ``VisualizationUI`` falls back to the
headless backend when they are missing. The plotting/auto-range state lives
in the shared backend-agnostic ``PlotModel`` (ui/plots.py).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..config import Config
from .files import collect_audio_files, default_audio_dir
from .plots import PlotModel

logger = logging.getLogger(__name__)

__all__ = ["QtVisualizer"]

_STYLESHEET = """
QWidget { background-color: #1e1e1e; color: #dddddd; font-size: 12px; }
QPushButton { background-color: #333333; border: 1px solid #555555;
              padding: 4px 12px; border-radius: 3px; }
QPushButton:hover { background-color: #444444; }
QPushButton:disabled { color: #777777; }
QGroupBox { border: 1px solid #444444; margin-top: 6px; }
QGroupBox::title { subcontrol-origin: margin; left: 8px; }
"""


class QtVisualizer:
    """Interactive pyqtgraph window over the runtime contract."""

    def __init__(self, runtime, title: str = "Real-time speech processing"):
        import pyqtgraph as pg
        from pyqtgraph.Qt import QtCore, QtWidgets

        self.pg = pg
        self.QtCore = QtCore
        self.QtWidgets = QtWidgets
        self.runtime = runtime
        self.model = PlotModel(runtime)

        self.app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
        self.app.setStyleSheet(_STYLESHEET)
        self.win = QtWidgets.QWidget()
        self.win.setWindowTitle(title)
        self.win.resize(1100, 850)

        layout = QtWidgets.QVBoxLayout(self.win)
        layout.addWidget(self._build_plots())
        layout.addWidget(self._build_settings())
        layout.addLayout(self._build_controls())

        self.timer = QtCore.QTimer()
        self.timer.setInterval(Config.PLOT_UPDATE_INTERVAL)
        self.timer.timeout.connect(self._update)
        self.timer.start()
        self._was_running = False
        self._prompted_eof = False

    # -- construction ------------------------------------------------------

    def _build_plots(self):
        pg = self.pg
        glw = pg.GraphicsLayoutWidget()
        self.curves = {}
        specs = [
            ("waveform", "Waveform", "#4fc3f7"),
            ("energy", "Short-time energy", "#ffb74d"),
            ("zcr", "Zero-crossing rate", "#aed581"),
            ("vad", "Voice activity", "#e57373"),
        ]
        self.plots = {}
        for i, (key, label, color) in enumerate(specs):
            p = glw.addPlot(row=i, col=0, title=label)
            p.showGrid(x=True, y=True, alpha=0.2)
            # Construct with NO positional data (the reference-proven call
            # shape, visualization.py:286-307): real pyqtgraph's stepMode
            # validation (len(x) == len(y)+1) is unverified for empty
            # arrays in this Qt-less environment, so data only ever reaches
            # the step curve via the guarded non-empty setData in _update.
            if key == "vad":
                curve = p.plot(
                    pen=pg.mkPen(color, width=1.5),
                    fillLevel=0, brush=pg.mkBrush(color + "60"),
                    stepMode="center",
                )
            else:
                curve = p.plot(pen=pg.mkPen(color, width=1))
            self.curves[key] = curve
            self.plots[key] = p
        self._glw = glw
        return glw

    def _add_pitch_plot(self):
        """Lazily add the fifth F0 panel the first time pitch data appears
        (runtimes with ``TPU_ENGINE_PITCH`` on) — the default 4-panel layout
        stays reference-identical for every other runtime. Unvoiced frames
        plot at 0 Hz (the track's own convention), so no NaN-gap plumbing
        is needed on the Qt side."""
        p = self._glw.addPlot(row=4, col=0, title="Pitch (F0, Hz)")
        p.showGrid(x=True, y=True, alpha=0.2)
        self.curves["f0"] = p.plot(pen=self.pg.mkPen("#ba68c8", width=1))
        self.plots["f0"] = p

    def _build_settings(self):
        QtWidgets = self.QtWidgets
        group = QtWidgets.QGroupBox("Audio source")
        form = QtWidgets.QGridLayout(group)

        self.radio_mic = QtWidgets.QRadioButton("Microphone")
        self.radio_scan = QtWidgets.QRadioButton("Scan default directory")
        self.radio_custom = QtWidgets.QRadioButton("Custom path")
        self.radio_scan.setChecked(True)
        form.addWidget(self.radio_mic, 0, 0)
        form.addWidget(self.radio_scan, 0, 1)
        form.addWidget(self.radio_custom, 0, 2)

        self.path_edit = QtWidgets.QLineEdit()
        self.path_edit.setPlaceholderText("file or directory path")
        browse_file = QtWidgets.QPushButton("File…")
        browse_dir = QtWidgets.QPushButton("Dir…")
        browse_file.clicked.connect(self._pick_file)
        browse_dir.clicked.connect(self._pick_dir)
        form.addWidget(self.path_edit, 1, 0)
        form.addWidget(browse_file, 1, 1)
        form.addWidget(browse_dir, 1, 2)

        self.radio_all = QtWidgets.QRadioButton("Test all files")
        self.radio_one = QtWidgets.QRadioButton("Test one file:")
        self.radio_all.setChecked(True)
        self.file_combo = QtWidgets.QComboBox()
        scope = QtWidgets.QButtonGroup(group)
        scope.addButton(self.radio_all)
        scope.addButton(self.radio_one)
        form.addWidget(self.radio_all, 2, 0)
        form.addWidget(self.radio_one, 2, 1)
        form.addWidget(self.file_combo, 2, 2)

        self.chk_autostop = QtWidgets.QCheckBox("Auto-stop at end of file")
        self.chk_autostop.setChecked(True)
        self.chk_autorange = QtWidgets.QCheckBox("Auto-range plots")
        self.chk_autorange.setChecked(True)
        form.addWidget(self.chk_autostop, 3, 0)
        form.addWidget(self.chk_autorange, 3, 1)

        # populate the per-file combo for the initial (default-scan) mode
        # and keep it in sync with mode switches — otherwise "Test one file"
        # and playlist reordering only work after browsing via "Dir…"
        # (reference populates at construction and on mode change,
        # visualization.py:500, :775, :794)
        for radio in (self.radio_mic, self.radio_scan, self.radio_custom):
            radio.clicked.connect(self._sync_combo)
        if hasattr(self.path_edit, "editingFinished"):  # real Qt binding
            self.path_edit.editingFinished.connect(self._sync_combo)
        self._sync_combo()
        return group

    def _build_controls(self):
        QtWidgets = self.QtWidgets
        row = QtWidgets.QHBoxLayout()
        self.btn_start = QtWidgets.QPushButton("Start")
        self.btn_stop = QtWidgets.QPushButton("Stop")
        self.btn_save = QtWidgets.QPushButton("Save data")
        self.btn_start.clicked.connect(self._on_start)
        self.btn_stop.clicked.connect(self._on_stop)
        self.btn_save.clicked.connect(self._on_save)
        self.status_label = QtWidgets.QLabel("stopped")
        self.progress_label = QtWidgets.QLabel("")
        self.result_label = QtWidgets.QLabel("")
        for w in (self.btn_start, self.btn_stop, self.btn_save,
                  self.status_label, self.progress_label, self.result_label):
            row.addWidget(w)
        row.addStretch(1)
        return row

    # -- source assembly ---------------------------------------------------

    def _pick_file(self):
        path, _ = self.QtWidgets.QFileDialog.getOpenFileName(self.win, "Audio file")
        if path:
            self.path_edit.setText(path)
            self.radio_custom.setChecked(True)

    def _pick_dir(self):
        path = self.QtWidgets.QFileDialog.getExistingDirectory(self.win, "Audio dir")
        if path:
            self.path_edit.setText(path)
            self.radio_custom.setChecked(True)
            self._refresh_combo(collect_audio_files(path))

    def _refresh_combo(self, files):
        self.file_combo.clear()
        for f in files:
            self.file_combo.addItem(os.path.basename(f), f)

    def _sync_combo(self):
        """Repopulate the per-file combo for the ACTIVE source mode."""
        if self.radio_custom.isChecked():
            path = self.path_edit.text().strip()
            files = [path] if os.path.isfile(path) else collect_audio_files(path)
        elif self.radio_mic.isChecked():
            files = []
        else:
            files = collect_audio_files(default_audio_dir())
        self._refresh_combo(files)

    def _build_source(self):
        from ..runtime.audio_source import FileAudioSource, PlaylistAudioSource

        if self.radio_mic.isChecked():
            return None
        if self.radio_custom.isChecked():
            path = self.path_edit.text().strip()
            if os.path.isfile(path):
                return FileAudioSource(path, sample_rate=Config.SAMPLE_RATE)
            files = collect_audio_files(path)
            if not files:
                # a typo'd custom path must NOT silently fall back to the
                # live microphone (None -> mic); surface it to the user
                raise ValueError(f"no audio found at custom path: {path!r}")
        else:
            files = collect_audio_files(default_audio_dir())
        if not files:
            return None
        if self.radio_one.isChecked():
            # "test one file": the combo selection if it belongs to the
            # CURRENT file set (a stale selection from a previously browsed
            # directory must not bypass the chosen source), else the first
            sel = self.file_combo.currentData() if self.file_combo.count() else None
            files = [sel if sel in files else files[0]]
        elif self.file_combo.count():
            # start the playlist at the combo selection (reference
            # visualization.py:854-881 reorders similarly)
            sel = self.file_combo.currentData()
            if sel in files:
                i = files.index(sel)
                files = files[i:] + files[:i]
        return PlaylistAudioSource(files, sample_rate=Config.SAMPLE_RATE)

    # -- handlers ----------------------------------------------------------

    def _on_start(self):
        try:
            src = self._build_source()
            if hasattr(self.runtime, "set_audio_source"):
                self.runtime.set_audio_source(
                    src, auto_stop_on_eof=self.chk_autostop.isChecked()
                )
            self.runtime.start()
            self._prompted_eof = False
            self.status_label.setText("running")
        except Exception as e:
            logger.exception("start failed")
            self.QtWidgets.QMessageBox.critical(self.win, "Start failed", str(e))

    def _on_stop(self):
        self.runtime.stop()
        self.status_label.setText("stopped")

    def _on_save(self):
        try:
            path = self.runtime.save_data()
            self.QtWidgets.QMessageBox.information(self.win, "Saved", path)
        except Exception as e:
            self.QtWidgets.QMessageBox.critical(self.win, "Save failed", str(e))

    def _update(self):
        m = self.model
        m.auto_range = self.chk_autorange.isChecked()
        m.poll()
        self.curves["waveform"].setData(m.waveform)
        self.curves["energy"].setData(m.energies)
        self.curves["zcr"].setData(m.zcrs)
        # always set (x of len N+1 satisfies the stepMode contract for N==0
        # too): a cleared session must clear the VAD trace like the others
        self.curves["vad"].setData(np.arange(m.vads.size + 1), m.vads)
        if m.f0.size and "f0" not in self.curves:
            self._add_pitch_plot()
        if "f0" in self.curves:
            self.curves["f0"].setData(m.f0)
        if m.auto_range:
            # only drive ranges while auto-range is on — forcing setYRange
            # every tick with the frozen ranges would fight the user's
            # manual zoom/pan the moment they uncheck the box
            for key, plot in self.plots.items():
                if key == "f0":
                    voiced = m.f0[m.f0 > 0]
                    top = float(np.max(voiced)) * 1.2 if voiced.size else 400.0
                    plot.setYRange(0.0, max(top, 50.0), padding=0)
                    continue
                lo, hi = m.ranges[key]
                plot.setYRange(lo, hi, padding=0)
        self.progress_label.setText(m.progress())
        self.result_label.setText(m.summary())
        running = bool(getattr(self.runtime, "is_running", False))
        self.status_label.setText("running" if running else "stopped")
        # defensive getattr chain: the runtime is a documented duck-typed
        # contract (plots.py) — an unhandled AttributeError in a Qt slot
        # aborts the process under PyQt5
        exhausted = bool(
            getattr(getattr(self.runtime, "audio_source", None), "exhausted", False)
        )
        if self._was_running and not running and exhausted and not self._prompted_eof:
            self._prompted_eof = True
            self._prompt_completion()
        self._was_running = running
        self.btn_start.setEnabled(not running)
        self.btn_stop.setEnabled(running)

    def _prompt_completion(self):
        QtWidgets = self.QtWidgets
        box = QtWidgets.QMessageBox(self.win)
        box.setWindowTitle("Playback complete")
        box.setText("All audio consumed. Continue with another source or quit?")
        # enum location differs between Qt5 bindings and strict Qt6 ones
        roles = getattr(QtWidgets.QMessageBox, "ButtonRole", QtWidgets.QMessageBox)
        cont = box.addButton("Continue", roles.AcceptRole)
        box.addButton("Quit", roles.RejectRole)
        _exec(box)
        if box.clickedButton() is not cont:
            self.app.quit()

    def run(self):
        self.win.show()
        return _exec(self.app)


def _exec(obj):
    """Qt6 uses .exec(); some Qt5 bindings only have .exec_()."""
    fn = getattr(obj, "exec", None) or getattr(obj, "exec_")
    return fn()
