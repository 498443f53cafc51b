"""The port's data-collection tree (``capture/book.py``, ``recorder.py``,
``session.py``, ``clean_audio.py`` and ``dsp/denoise.py``) against the JAX
package's ``capture/`` and ``dsp/denoise.py``: the same sentences and
bookmarks, the same files byte for byte from the same captured samples
(stub boards and microphones that return fixed arrays), the same key
protocol, the same denoised and cleaned audio. Everything here is numpy on
the host: the arrays must be equal, not close."""

import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from silent_speech_tpu.capture import book as jax_book
from silent_speech_tpu.capture import clean_audio as jax_clean
from silent_speech_tpu.capture import recorder as jax_recorder
from silent_speech_tpu.capture import session as jax_session
from silent_speech_tpu.dsp import denoise as jax_denoise
from silent_speech_tpu_torch.capture import book, clean_audio, recorder
from silent_speech_tpu_torch.capture import session
from silent_speech_tpu_torch.config import DataConfig
from silent_speech_tpu_torch.data.dataset import EMGDataset
from silent_speech_tpu_torch.dsp import denoise
from silent_speech_tpu_torch.utils.audio_io import read_audio
from silent_speech_tpu_torch.utils.flac import write_flac

ROOT = Path(__file__).resolve().parent.parent
SIDES = {"jax": (jax_book, jax_recorder, jax_session, jax_clean),
         "port": (book, recorder, session, clean_audio)}
TEXTS = [
    "Mr. Smith went to Washington. He arrived at 3 p.m.! \"Was it "
    "raining?\" Nobody knew.",
    "One sentence here. Another one follows. A third ends.",
    "Dr. No met Prof. X at St. Paul's (vol. 2). Then... nothing?  'Yes,' "
    "said she.\n\nNew paragraph [1]. Fig. 3 shows it!",
    "",
    "no terminal punctuation at all",
]


def _dir_bytes(path):
    return {f: (Path(path) / f).read_bytes()
            for f in sorted(os.listdir(path)) if (Path(path) / f).is_file()}


@pytest.mark.parametrize("text", TEXTS)
def test_split_sentences_matches_jax(text):
    assert book.split_sentences(text) == jax_book.split_sentences(text)


def test_the_book_and_its_bookmark_match_jax(tmp_path):
    positions = {}
    for side, (bk, *_rest) in SIDES.items():
        f = tmp_path / side / "b.txt"
        f.parent.mkdir()
        f.write_text(TEXTS[0] + " " + TEXTS[1])
        b = bk.Book(str(f))
        seen = [(len(b), b.name, b.current_sentence())]
        b.advance()
        b.advance()
        resumed = bk.Book(str(f))        # resumes from the bookmark
        seen.append((resumed.current_sentence_index(),
                     resumed.current_sentence()))
        with bk.Book(str(f)) as again:
            again.position = 4           # written on exit, not advanced
        seen.append(f.with_name("b.txt.bookmark").read_text())
        seen.append(bk.Book(str(f), name="custom").name)
        positions[side] = seen
    assert positions["port"] == positions["jax"]
    assert positions["port"][1][0] == 2 and positions["port"][2] == "4"


class StubBoard:
    """A board that hands out utterance n's fixed samples once after the
    n-th ``start_stream``, and nothing after."""

    sampling_rate = 1000

    def __init__(self, n_samples=(300, 420, 260), seed=0):
        rng = np.random.default_rng(seed)
        self._data = []
        for n in n_samples:
            d = 30 * rng.normal(size=(9, n))
            d[8] = rng.random(n) < 0.05            # the button row
            self._data.append(d)
        self._n, self._pending = -1, None

    def start_stream(self):
        self._n += 1
        self._pending = self._data[self._n % len(self._data)]

    def stop_stream(self):
        pass

    def get_board_data(self):
        out, self._pending = self._pending, None
        return out if out is not None else np.zeros((9, 0))


class StubMicrophone:
    sampling_rate = 16000

    def __init__(self, n_samples=(4800, 6720, 4160), seed=1):
        rng = np.random.default_rng(seed)
        self._data = [(0.1 * rng.normal(size=n)).astype(np.float32)
                      for n in n_samples]
        self._n, self._pending = -1, None

    def start_stream(self):
        self._n += 1
        self._pending = self._data[self._n % len(self._data)]

    def stop_stream(self):
        pass

    def get_audio(self):
        out, self._pending = self._pending, None
        return out if out is not None else np.zeros(0, np.float32)


def _stub_recorder(rec_module):
    return rec_module.Recorder(board=StubBoard(), microphone=StubMicrophone())


def test_record_utterance_writes_jax_s_files(tmp_path):
    infos = {}
    for side, (_, rec, ses, _) in SIDES.items():
        r = _stub_recorder(rec)
        infos[side] = [
            ses.record_utterance(r, str(tmp_path / side), i, f"text {i}",
                                 "book", 10 + i, 0.01) for i in range(2)]
    assert infos["port"] == infos["jax"]
    files = _dir_bytes(tmp_path / "port")
    assert sorted(files) == sorted(
        f"{i}_{n}" for i in range(2)
        for n in ("emg.npy", "button.npy", "audio.flac", "info.json"))
    assert files == _dir_bytes(tmp_path / "jax")
    assert np.load(tmp_path / "port" / "1_emg.npy").shape == (420, 8)
    r = _stub_recorder(recorder)
    with pytest.raises(FileExistsError, match="refusing to overwrite"):
        session.record_utterance(r, str(tmp_path / "port"), 0, "again",
                                 "book", 0, 0.01)
    with pytest.raises(AssertionError):     # JAX refuses with an assert
        jax_session.record_utterance(_stub_recorder(jax_recorder),
                                     str(tmp_path / "jax"), 0, "again",
                                     "book", 0, 0.01)


@pytest.mark.parametrize("keys", [["", "", "", ""], ["", "r", "q"],
                                  ["", "", "r", ""]])
def test_run_session_matches_jax(tmp_path, monkeypatch, keys):
    for side, (_, rec, ses, _) in SIDES.items():
        f = tmp_path / side / "b.txt"
        f.parent.mkdir()
        f.write_text(TEXTS[1])
        monkeypatch.setattr(ses, "Recorder",
                            lambda debug=True, rec=rec: _stub_recorder(rec))
        answers = iter(keys)
        monkeypatch.setattr("builtins.input", lambda _prompt: next(answers))
        n = ses.run_session(str(tmp_path / side / "s"), str(f),
                            seconds_per_sentence=0.01)
        (tmp_path / side / f"n{n}").write_text("")
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "jax")
    assert _dir_bytes(tmp_path / "port" / "s") == \
        _dir_bytes(tmp_path / "jax" / "s")


class StubStream:
    """``get_data`` of a streaming recorder: the k-th call's fixed segment
    (multi-chunk, long enough for the 500-sample edges)."""

    def __init__(self, seed=2):
        self._rng = np.random.default_rng(seed)

    def get_data(self):
        sizes = [(int(n), 16 * int(n), int(n))
                 for n in self._rng.integers(100, 400, size=3)]
        emg = 30 * self._rng.normal(size=(sum(s[0] for s in sizes), 8))
        audio = (0.1 * self._rng.normal(size=sum(s[1] for s in sizes))
                 ).astype(np.float32)
        button = self._rng.random(emg.shape[0]) < 0.01
        return emg, audio, button, sizes


def test_reading_session_protocol_matches_jax(tmp_path):
    keys = ["x", "n", " ", "r", "n", "r", "n", "q", "n"]
    trail = {}
    for side, (bk, _, ses, _) in SIDES.items():
        f = tmp_path / side / "b.txt"
        f.parent.mkdir()
        f.write_text("First sentence here. Second sentence here. "
                     "Third sentence here. Fourth one.")
        with bk.Book(str(f)) as b:
            s = ses.ReadingSession(StubStream(), b, str(tmp_path / side /
                                                         "s"))
            seen = [s.current_prompt()]
            for k in keys:
                s.handle_key(k)
                seen.append((s.current_prompt(), s.output_idx, s.done,
                             s.recording))
        trail[side] = seen
    assert trail["port"] == trail["jax"]
    assert trail["port"][-1][2]         # 'q' ended it; later keys do nothing
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "jax")
    assert _dir_bytes(tmp_path / "port" / "s") == \
        _dir_bytes(tmp_path / "jax" / "s")


def test_streaming_recorder_chunks_match_jax():
    out = {}
    for side, (_, rec, _, _) in SIDES.items():
        board, mic = StubBoard(), StubMicrophone()
        with rec.Recorder(board=board, microphone=mic) as r:
            for _ in range(3):
                r.update()       # utterance 0's samples, then nothing new
            first = r.get_data()
            board.start_stream()
            mic.start_stream()
            r.update()
            second = r.get_data()
            third = r.get_data()   # cleared
        out[side] = (first, second, third)
    for a, b in zip(out["port"], out["jax"]):
        assert a[3] == b[3]
        for x, y in zip(a[:3], b[:3]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert out["port"][0][3] == [(300, 4800, 300)]
    assert out["port"][2][0].shape == (0, 8)


@pytest.mark.parametrize("noise_len", [0, 700, 16000])
def test_spectral_gate_equals_jax(noise_len):
    rng = np.random.default_rng(noise_len)
    sr = 16000
    t = np.arange(sr) / sr
    audio = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=sr)
    noise = 0.05 * rng.normal(size=noise_len)
    ours = denoise.spectral_gate(audio, noise, sample_rate=sr)
    ref = jax_denoise.spectral_gate(audio, noise, sample_rate=sr)
    assert ours.dtype == ref.dtype == np.float64
    assert np.array_equal(ours, ref)


def _write_raw_session(directory, seed, rate=16000, wav_index=None):
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True)
    for i in range(4):
        n = rate // 2 + 1000 * i
        audio = 0.02 * rng.normal(size=n)
        if i:
            audio += (0.15 * i) * np.sin(2 * np.pi * 300 * np.arange(n)
                                         / rate)
        write_flac(str(directory / f"{i}_audio.flac"),
                   audio.astype(np.float32), rate)


@pytest.mark.parametrize("denoise_on", [True, False])
def test_clean_session_equals_jax(tmp_path, denoise_on):
    written = {}
    for side, (_, _, _, cln) in SIDES.items():
        d = tmp_path / side
        _write_raw_session(d, seed=5)
        written[side] = [os.path.basename(p) for p in
                         cln.clean_session(str(d), denoise=denoise_on)]
    assert written["port"] == written["jax"] == [
        f"{i}_audio_clean.flac" for i in range(4)]
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "jax")
    audio, rate = read_audio(str(tmp_path / "port" / "3_audio_clean.flac"))
    assert rate == 22050 and np.abs(audio).max() <= 1.0


def test_clip_rms_equals_jax():
    rng = np.random.default_rng(0)
    for n in (100, 2048, 9000):
        x = rng.normal(size=n)
        assert clean_audio._clip_rms(x) == jax_clean._clip_rms(x)


def test_clean_session_refuses_an_empty_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="no raw audio clips"):
        clean_audio.clean_session(str(tmp_path))


@pytest.mark.parametrize("missing", ["brainflow", "sounddevice"])
def test_absent_hardware_packages_raise_jax_s_import_error(monkeypatch,
                                                           missing):
    monkeypatch.setitem(sys.modules, missing, None)
    if missing == "brainflow":
        monkeypatch.setitem(sys.modules, "brainflow.board_shim", None)
    errors = {}
    for side, (_, rec, _, _) in SIDES.items():
        cls = rec.BrainFlowBoard if missing == "brainflow" else rec.Microphone
        with pytest.raises(ImportError) as e:
            cls()
        errors[side] = str(e.value)
    assert errors["port"] == errors["jax"]
    with pytest.raises(ImportError):
        recorder.Recorder(debug=False)


class _FakeShim:
    calls = []

    def __init__(self, board_id, params):
        self.board_id, self.params = board_id, params
        self._calls = _FakeShim.calls

    @staticmethod
    def get_emg_channels(board_id):
        return list(range(1, 9))

    @staticmethod
    def get_analog_channels(board_id):
        return [19, 20]

    def prepare_session(self):
        self._calls.append("prepare")

    def start_stream(self):
        self._calls.append("start")

    def stop_stream(self):
        self._calls.append("stop")

    def release_session(self):
        self._calls.append("release")

    def get_board_data(self):
        return np.arange(24 * 5, dtype=np.float64).reshape(24, 5)


def _fake_brainflow(monkeypatch):
    pkg = types.ModuleType("brainflow")
    shim = types.ModuleType("brainflow.board_shim")
    shim.BoardShim = _FakeShim
    shim.BrainFlowInputParams = types.SimpleNamespace
    shim.BoardIds = types.SimpleNamespace(
        CYTON_WIFI_BOARD=types.SimpleNamespace(value=5),
        CYTON_BOARD=types.SimpleNamespace(value=0))
    pkg.board_shim = shim
    monkeypatch.setitem(sys.modules, "brainflow", pkg)
    monkeypatch.setitem(sys.modules, "brainflow.board_shim", shim)


@pytest.mark.parametrize("mode", ["wifi", "serial"])
def test_brainflow_board_with_a_fake_package_matches_jax(monkeypatch, mode):
    _fake_brainflow(monkeypatch)
    seen = {}
    for side, (_, rec, _, _) in SIDES.items():
        _FakeShim.calls = []
        b = rec.BrainFlowBoard(mode=mode)
        b.start_stream()
        data = b.get_board_data()
        b.stop_stream()
        seen[side] = (b.sampling_rate, b._shim.board_id,
                      vars(b._shim.params), data.tolist(),
                      list(_FakeShim.calls))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == (1000 if mode == "wifi" else 250)
    assert len(seen["port"][3]) == 9   # 8 EMG rows and the analog row


def test_microphone_with_a_fake_sounddevice_matches_jax(monkeypatch):
    class InputStream:
        def __init__(self, samplerate, channels, callback):
            self.callback, self.log = callback, []

        def start(self):
            self.log.append("start")

        def stop(self):
            self.log.append("stop")

    monkeypatch.setitem(sys.modules, "sounddevice",
                        types.SimpleNamespace(InputStream=InputStream))
    blocks = [np.full((4, 1), 0.5, np.float32),
              np.arange(6, dtype=np.float32)[:, None]]
    seen = {}
    for side, (_, rec, _, _) in SIDES.items():
        mic = rec.Microphone()
        mic.start_stream()
        empty = mic.get_audio()
        for blk in blocks:
            mic._stream.callback(blk, len(blk), None, None)
        audio = mic.get_audio()
        mic.stop_stream()
        seen[side] = (empty.tolist(), audio.tolist(), mic._stream.log,
                      mic.sampling_rate)
    assert seen["port"] == seen["jax"]


def test_synthetic_microphone_and_recorder_shapes():
    mic = recorder.SyntheticMicrophone()
    with pytest.raises(RuntimeError, match="stream not started"):
        mic.get_audio()
    emg, audio, button = recorder.Recorder(debug=True).record(0.12)
    assert emg.shape[1] == 8 and emg.shape[0] > 50
    assert button.shape == (emg.shape[0],) and audio.ndim == 1
    assert audio.dtype == np.float32 and audio.shape[0] > 800


def test_live_scope_without_matplotlib_sleeps(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    r = recorder.Recorder(board=StubBoard(), microphone=StubMicrophone(),
                          display=True)
    assert r._scope._plt is None
    with r:
        r.update()
        emg, *_ = r.get_data()
    assert emg.shape == (300, 8)


def test_live_scope_draws_the_last_window(monkeypatch):
    import matplotlib
    matplotlib.use("Agg")
    r = recorder.Recorder(board=StubBoard(), microphone=StubMicrophone(),
                          display=True)
    with r:
        r.update()   # the scope ticks before each pump's reads
        r.update()
        e = r._scope._e_lines[3].get_ydata()
        a = r._scope._a_line.get_ydata()
    assert len(e) == 4000 and len(a) == 64000
    emg3 = r.board._data[0][3]
    assert np.array_equal(e[-300:], emg3)
    assert np.array_equal(a[-4800:], r.microphone._data[0])


def test_the_session_and_cleaning_clis_with_piped_stdin(tmp_path):
    """The CLIs as a user runs them, on the host: three Enter lines record
    the book's three sentences from the synthetic board, the book ends the
    session, the cleaning CLI writes the clean audio, and the port's
    dataset reads the session."""
    bf = tmp_path / "book.txt"
    bf.write_text("The first line. The second line. The third line.")
    sess = tmp_path / "voiced" / "s0"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    run = subprocess.run(
        [sys.executable, "-m", "silent_speech_tpu_torch.capture.session",
         "--debug", "--seconds", "0.4", "--book_file", str(bf),
         "--output_directory", str(sess)],
        input="\n\n\n", capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.count("Enter=record") == 3
    run = subprocess.run(
        [sys.executable, "-m", "silent_speech_tpu_torch.capture.clean_audio",
         str(sess)], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120)
    assert run.returncode == 0, run.stderr
    assert "wrote 3 cleaned clips" in run.stdout
    for i in range(3):
        info = json.loads((sess / f"{i}_info.json").read_text())
        assert info["book"] == "book" and info["sentence_index"] == i
        emg = np.load(sess / f"{i}_emg.npy")
        assert emg.shape[1] == 8 and emg.shape[0] == info["chunks"][0][0]
        assert np.load(sess / f"{i}_button.npy").shape == (emg.shape[0],)
        assert (sess / f"{i}_audio_clean.flac").is_file()
    assert (tmp_path / "book.txt.bookmark").read_text() == "3"
    data = EMGDataset(DataConfig(silent_data_directories=[],
                                 voiced_data_directories=[
                                     str(tmp_path / "voiced")]),
                      no_testset=True, no_normalizers=True)
    assert len(data) == 3
    ex = data[0]
    assert ex["raw_emg"].shape == (8 * ex["emg"].shape[0], 8)
    assert ex["text"].startswith("The ")


def _read_until(fd, needle, timeout):
    """Drain the pseudo-terminal until ``needle`` shows (or the time is
    up); returns what was read."""
    import select

    seen, end = b"", time.monotonic() + timeout
    while time.monotonic() < end and needle not in seen:
        ready, _, _ = select.select([fd], [], [], 0.05)
        if ready:
            try:
                seen += os.read(fd, 65536)
            except OSError:
                break
    return seen


def test_the_curses_session_in_a_pseudo_terminal(tmp_path):
    """``--curses``: the reference's prompter in a terminal. A key starts
    recording, ``n`` saves the leading silence, ``n`` the first sentence,
    ``q`` the trailing silence and ends the session."""
    bf = tmp_path / "book.txt"
    bf.write_text("First sentence here. Second sentence here.")
    out = tmp_path / "sess"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "TERM": "xterm",
           "LINES": "24", "COLUMNS": "80"}
    fd, slave = os.openpty()
    proc = subprocess.Popen(
        [sys.executable, "-m", "silent_speech_tpu_torch.capture.session",
         "--curses", "--debug", "--book_file", str(bf),
         "--output_directory", str(out)],
        stdin=slave, stdout=slave, stderr=slave, cwd=ROOT, env=env,
        start_new_session=True)
    os.close(slave)
    try:
        assert b"Press any key" in _read_until(fd, b"Press any key", 60)
        for key, needle in ((b"x", b"<silence>"),
                            (b"n", b"First sentence"),
                            (b"n", b"Second sentence"), (b"q", None)):
            time.sleep(0.3)    # the synthetic board fills in wall time
            os.write(fd, key)
            if needle:
                assert needle in _read_until(fd, needle, 30)
        end = time.monotonic() + 60
        while proc.poll() is None and time.monotonic() < end:
            _read_until(fd, b"\0", 0.1)
        assert proc.poll() == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        os.close(fd)
    infos = [json.loads((out / f"{i}_info.json").read_text())
             for i in range(3)]
    assert [(i["book"], i["sentence_index"], i["text"]) for i in infos] == [
        ("", -1, ""), ("book", 0, "First sentence here."), ("", -1, "")]
    emg1 = np.load(out / "1_emg.npy")
    assert emg1.shape[1] == 8 and emg1.shape[0] == sum(
        c[0] for c in infos[1]["chunks"])
    assert (tmp_path / "book.txt.bookmark").read_text() == "1"
