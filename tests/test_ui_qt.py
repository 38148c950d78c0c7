#!/usr/bin/env python3
"""Execute the Qt UI backend (ui/qt.py) against the real engine using the
strict stub-Qt harness (tests/qt_stubs.py) — no display or Qt binding needed.

Covers the gap "the Qt backend has never been executed":
construction, repeated ``_update()`` polls over live engine output,
``_build_source()`` for every radio state, start/stop/save handlers, the EOF
completion prompt, and the ``VisualizationUI`` front door selecting the Qt
backend when pyqtgraph imports succeed. Mirrors reference
visualization.py:47-613.
"""

import importlib
import sys
import time
import wave

import numpy as np
import pytest

import qt_stubs
from test_runtime_engine import DummyAudioSource

from sspv_tpu.config import Config
from sspv_tpu.runtime import AudioRuntime


@pytest.fixture
def qtvis(monkeypatch):
    """Stub Qt installed + sspv_tpu.ui.qt (re)imported against the stubs."""
    qt_stubs.install(monkeypatch)
    import sspv_tpu.ui.qt as qt_mod

    importlib.reload(qt_mod)
    yield qt_mod
    # leave the module un-stubbed for other tests
    sys.modules.pop("sspv_tpu.ui.qt", None)


def _write_wav(path, seconds=0.2, freq=330.0):
    sr = Config.SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    sig = (np.sin(2 * np.pi * freq * t) * 12000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(sig.tobytes())
    return str(path)


def test_qt_visualizer_full_session(qtvis, monkeypatch, tmp_path):
    """Construct, start, poll to EOF, save, and hit the completion prompt."""
    monkeypatch.setattr(Config, "SAVE_DIRECTORY", str(tmp_path))
    rt = AudioRuntime(audio_source=DummyAudioSource(duration_sec=0.3))
    ui = qtvis.QtVisualizer(rt, title="stub session")

    assert ui.win._title == "stub session"
    assert ui.timer._started and ui.timer._interval == Config.PLOT_UPDATE_INTERVAL
    assert set(ui.curves) == {"waveform", "energy", "zcr", "vad"}

    # no-source start keeps mic=None path out: radios default to "scan";
    # empty default dir -> _build_source returns None -> engine defaults to
    # mic -> pyaudio missing -> capture thread dies and surfaces last_error.
    # Drive the session with the dummy source instead (set before start).
    ui.radio_mic.setChecked(True)
    ui.radio_scan.setChecked(False)
    monkeypatch.setattr(
        rt, "set_audio_source",
        lambda src, auto_stop_on_eof=False: AudioRuntime.set_audio_source(
            rt, DummyAudioSource(duration_sec=0.3), auto_stop_on_eof=True),
    )
    ui._on_start()  # engine may already hit EOF by the next line: don't
    # assert is_running here, assert on the processed output below instead
    deadline = time.time() + 60
    polls = 0
    while time.time() < deadline:
        ui.timer.timeout.emit()  # the 50 ms tick -> _update()
        polls += 1
        if not rt.is_running:
            break
        time.sleep(0.01)
    # auto-stop flips is_running at EOF but the processing thread may still
    # be draining its in-flight block; stop() joins it so results are final
    # (same contract stop() documents for headless consumers).
    ui._on_stop()
    assert not rt.is_running and rt.last_error is None

    # one more tick after EOF -> completion prompt fires exactly once.
    # The engine may reach EOF before any tick observed it running, so pin
    # the running->stopped transition the prompt keys on.
    qt_stubs.QMessageBox.next_clicked_index = 0  # "Continue"
    if not ui._prompted_eof:
        ui._was_running = True
    ui.timer.timeout.emit()
    prompts = [s for s in qt_stubs.QMessageBox.shown if s[0] == "question"]
    assert len(prompts) == 1 and "complete" in prompts[0][1].lower()
    assert not ui.app._quit_called
    ui.timer.timeout.emit()
    assert len([s for s in qt_stubs.QMessageBox.shown if s[0] == "question"]) == 1

    # live data reached the curves and labels
    assert ui.curves["energy"].n_sets >= polls >= 1
    assert ui.curves["energy"].y.size > 0
    assert ui.curves["vad"].x is not None  # stepMode length contract checked in stub
    assert "frames=" in ui.result_label.text()
    assert ui.status_label.text() == "stopped"
    assert ui.btn_start.isEnabled() and not ui.btn_stop.isEnabled()

    # save goes through runtime.save_data and reports the path
    ui._on_save()
    infos = [s for s in qt_stubs.QMessageBox.shown if s[0] == "information"]
    assert len(infos) == 1 and infos[0][2].endswith(".npz")


def test_qt_build_source_all_radio_states(qtvis, monkeypatch, tmp_path):
    from sspv_tpu.runtime.audio_source import FileAudioSource, PlaylistAudioSource

    wavs = [_write_wav(tmp_path / f"{n}.wav") for n in ("a", "b", "c")]
    rt = AudioRuntime(audio_source=DummyAudioSource(duration_sec=0.1))
    ui = qtvis.QtVisualizer(rt)

    def choose(radio):
        for r in (ui.radio_mic, ui.radio_scan, ui.radio_custom):
            r.setChecked(r is radio)

    # microphone -> None (engine then defaults to PyAudioSource)
    choose(ui.radio_mic)
    assert ui._build_source() is None

    # custom path = file -> FileAudioSource
    choose(ui.radio_custom)
    ui.path_edit.setText(wavs[0])
    src = ui._build_source()
    assert isinstance(src, FileAudioSource)

    # custom path = dir, test-all -> playlist over every file
    ui.path_edit.setText(str(tmp_path))
    ui._refresh_combo(wavs)
    src = ui._build_source()
    assert isinstance(src, PlaylistAudioSource)
    assert src._paths == wavs

    # playlist reorder: combo selection becomes the starting file
    ui.file_combo.setCurrentIndex(1)
    src = ui._build_source()
    assert src._paths == [wavs[1], wavs[2], wavs[0]]

    # test-one -> single-file playlist at the combo selection
    ui.radio_one.setChecked(True)
    ui.radio_all.setChecked(False)
    src = ui._build_source()
    assert isinstance(src, PlaylistAudioSource)
    assert src._paths == [wavs[1]]

    # scan default dir (empty in this checkout) -> None
    choose(ui.radio_scan)
    monkeypatch.setattr(qtvis, "default_audio_dir", lambda: str(tmp_path / "none"))
    assert ui._build_source() is None

    # file/dir pickers route into path_edit + custom radio + combo
    qt_stubs.QFileDialog.next_file = wavs[2]
    ui._pick_file()
    assert ui.path_edit.text() == wavs[2] and ui.radio_custom.isChecked()
    qt_stubs.QFileDialog.next_dir = str(tmp_path)
    ui._pick_dir()
    assert ui.file_combo.count() == len(wavs)


def test_qt_start_failure_shows_message_box(qtvis, monkeypatch):
    rt = AudioRuntime(audio_source=DummyAudioSource(duration_sec=0.1))
    ui = qtvis.QtVisualizer(rt)
    monkeypatch.setattr(
        rt, "start", lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    )
    ui._on_start()
    crits = [s for s in qt_stubs.QMessageBox.shown if s[0] == "critical"]
    assert len(crits) == 1 and "boom" in crits[0][2]


def test_visualization_ui_selects_qt_backend(qtvis, monkeypatch):
    """With importable pyqtgraph, the front door picks QtVisualizer
    (reference main.py routes through VisualizationUI the same way)."""
    import sspv_tpu.ui as ui_pkg

    rt = AudioRuntime(audio_source=DummyAudioSource(duration_sec=0.1))
    vui = ui_pkg.VisualizationUI(rt)
    assert type(vui._impl).__name__ == "QtVisualizer"
    # run() enters the (stub) event loop and returns its exit code
    assert vui.run() == 0
    assert vui._impl.win._visible


def test_qt_custom_bad_path_raises_not_mic(qtvis, tmp_path):
    """A typo'd custom path must surface an error, never silently fall back
    to the live microphone."""
    rt = AudioRuntime(audio_source=DummyAudioSource(duration_sec=0.1))
    ui = qtvis.QtVisualizer(rt)
    ui.radio_custom.setChecked(True)
    ui.radio_scan.setChecked(False)
    ui.radio_mic.setChecked(False)
    ui.path_edit.setText(str(tmp_path / "typo.wav"))
    with pytest.raises(ValueError):
        ui._build_source()
    ui._on_start()  # handler catches it and shows the error dialog
    crits = [s for s in qt_stubs.QMessageBox.shown if s[0] == "critical"]
    assert any("typo.wav" in c[2] for c in crits)


def test_qt_stale_combo_selection_does_not_leak_across_dirs(qtvis, monkeypatch,
                                                            tmp_path):
    """'Test one file' with a combo still holding another directory's files
    must pick from the CURRENT source set, not the stale selection."""
    from sspv_tpu.runtime.audio_source import PlaylistAudioSource

    dir_a = tmp_path / "a"; dir_a.mkdir()
    dir_b = tmp_path / "b"; dir_b.mkdir()
    _write_wav(dir_a / "a1.wav"); _write_wav(dir_a / "a2.wav")
    b1 = _write_wav(dir_b / "b1.wav")
    rt = AudioRuntime(audio_source=DummyAudioSource(duration_sec=0.1))
    ui = qtvis.QtVisualizer(rt)
    qt_stubs.QFileDialog.next_dir = str(dir_a)
    ui._pick_dir()  # combo now holds dir A's files; path_edit = dir A
    assert ui.file_combo.count() == 2
    ui.path_edit.setText(str(dir_b))  # user re-points at dir B
    ui.radio_one.setChecked(True)
    src = ui._build_source()
    assert isinstance(src, PlaylistAudioSource)
    assert src._paths == [b1]  # NOT a stale dir-A path


def test_qt_autorange_toggle_releases_ranges_and_vad_clears(qtvis, monkeypatch):
    rt = AudioRuntime(audio_source=DummyAudioSource(duration_sec=0.3))
    ui = qtvis.QtVisualizer(rt)
    monkeypatch.setattr(
        rt, "set_audio_source",
        lambda src, auto_stop_on_eof=False: AudioRuntime.set_audio_source(
            rt, DummyAudioSource(duration_sec=0.3),
            auto_stop_on_eof=auto_stop_on_eof,
        ),
    )
    ui.chk_autostop.setChecked(True)
    ui._on_start()
    t0 = time.time()
    while rt.is_running and time.time() - t0 < 60:
        ui._update()
        time.sleep(0.01)
    ui._on_stop()  # join + drain the in-flight block
    ui._update()
    assert rt.last_error is None
    assert len(rt.processed_data) > 0
    # auto-range on (default): ranges were driven
    assert all(p.y_range is not None for p in ui.plots.values())
    # uncheck -> ranges released (user zoom/pan must not be fought)
    for p in ui.plots.values():
        p.y_range = None
    ui.chk_autorange.setChecked(False)
    ui._update()
    assert all(p.y_range is None for p in ui.plots.values())
    # vad curve had data; clearing the session must clear the trace too
    assert ui.curves["vad"].y is not None and ui.curves["vad"].y.size > 0
    rt.set_audio_source(DummyAudioSource(duration_sec=0.1))
    ui._update()
    assert ui.curves["vad"].y.size == 0


def test_visualization_ui_falls_back_when_qt_constructor_fails(qtvis,
                                                               monkeypatch):
    """Importable Qt but unstartable GUI (no display: QApplication raises)
    must fall back to the headless visualizer, not die."""
    import sspv_tpu.ui as ui_pkg

    class Boom:
        def __init__(self, *a, **k):
            raise RuntimeError("xcb platform plugin failed")

    monkeypatch.setattr("sspv_tpu.ui.qt.QtVisualizer", Boom)
    rt = AudioRuntime(audio_source=DummyAudioSource(duration_sec=0.1))
    v = ui_pkg.VisualizationUI(rt, headless=False, snapshot_path=None)
    from sspv_tpu.ui.headless import HeadlessVisualizer

    assert isinstance(v._impl, HeadlessVisualizer)


def test_qt_pitch_panel_appears_only_with_pitch_data(qtvis, monkeypatch):
    """With TPU_ENGINE_PITCH on, the first _update carrying F0 data lazily
    adds the fifth panel and feeds it; without pitch the reference 4-panel
    layout never changes (mirrors the headless backend's conditional fifth
    panel)."""
    monkeypatch.setattr(Config, "TPU_ENGINE_PITCH", True)
    sr = Config.SAMPLE_RATE
    t = np.arange(int(0.4 * sr)) / sr
    sig = (9000 * np.sin(2 * np.pi * 150 * t)).astype(np.int16)
    rt = AudioRuntime(audio_source=DummyAudioSource(signal=sig))
    rt.auto_stop_on_eof = True
    ui = qtvis.QtVisualizer(rt, title="pitch session")
    assert set(ui.curves) == {"waveform", "energy", "zcr", "vad"}

    rt.start()
    deadline = time.time() + 60
    while time.time() < deadline and rt.is_running:
        time.sleep(0.01)
    rt.stop()
    assert rt.last_error is None
    ui.timer.timeout.emit()  # one poll over the finished session

    assert "f0" in ui.curves and "f0" in ui.plots
    f0 = np.asarray(ui.curves["f0"].y)
    assert f0.size and (f0 > 0).any()
    v = f0[f0 > 0]
    assert abs(float(np.median(v)) - 150) < 10
    # auto-range drove the pitch panel's own scale (0-floored)
    assert ui.plots["f0"].y_range[0] == 0.0

    # a pitch-off runtime keeps the 4-panel layout across polls
    monkeypatch.setattr(Config, "TPU_ENGINE_PITCH", False)
    rt2 = AudioRuntime(audio_source=DummyAudioSource(signal=sig))
    rt2.auto_stop_on_eof = True
    ui2 = qtvis.QtVisualizer(rt2, title="plain session")
    rt2.start()
    deadline = time.time() + 60
    while time.time() < deadline and rt2.is_running:
        time.sleep(0.01)
    rt2.stop()
    ui2.timer.timeout.emit()
    assert set(ui2.curves) == {"waveform", "energy", "zcr", "vad"}
