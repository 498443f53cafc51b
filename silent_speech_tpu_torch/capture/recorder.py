"""EMG and microphone capture (host side, numpy).

Own copy of the JAX package's ``silent_speech_tpu/capture/recorder.py``
(reference ``data_collection/record_data.py``): an OpenBCI Cyton board
through BrainFlow (WiFi 1 kHz, serial 250 Hz) pumped beside a 16 kHz
microphone, with sample-drop detection and a button channel. The hardware
packages (``brainflow``, ``sounddevice``) are imported only when their
class is built; ``SyntheticBoard`` and ``SyntheticMicrophone`` (the
reference's ``debug=True`` backend, ``record_data.py:63-65``) need
neither, so that capture, cleaning and training run without hardware.
Nothing here touches a device.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np

EMG_CHANNELS = 8


class SyntheticBoard:
    """Fake EMG board: ``get_board_data`` returns the samples due since the
    last call, (channels + 1, n): the EMG rows, then the button row."""

    def __init__(self, sampling_rate: int = 1000, seed: int = 0):
        self.sampling_rate = sampling_rate
        self._rng = np.random.default_rng(seed)
        self._t0: Optional[float] = None
        self._consumed = 0

    def start_stream(self) -> None:
        self._t0 = time.monotonic()
        self._consumed = 0

    def stop_stream(self) -> None:
        self._t0 = None

    def get_board_data(self) -> np.ndarray:
        if self._t0 is None:
            raise RuntimeError("stream not started")
        avail = int((time.monotonic() - self._t0) * self.sampling_rate)
        n = max(avail - self._consumed, 0)
        self._consumed += n
        # the hum's phase counts from the new total, as the JAX board's does
        t = (np.arange(n) + self._consumed) / self.sampling_rate
        emg = self._rng.normal(size=(EMG_CHANNELS, n)) * 30
        emg += 5 * np.sin(2 * np.pi * 60 * t)[None, :]
        return np.concatenate([emg, np.zeros((1, n))], axis=0)


class BrainFlowBoard:
    """OpenBCI capture through BrainFlow (an optional package). ``mode``:
    ``"wifi"`` (Cyton with the WiFi shield, 1 kHz) or ``"serial"`` (the
    dongle, 250 Hz)."""

    def __init__(self, mode: str = "wifi", ip_port: int = 6677,
                 serial_port: str = "/dev/ttyUSB0"):
        try:
            from brainflow.board_shim import (  # type: ignore
                BoardIds, BoardShim, BrainFlowInputParams,
            )
        except ImportError as e:
            raise ImportError(
                "brainflow is not installed; use SyntheticBoard for "
                "hardware-free capture") from e
        params = BrainFlowInputParams()
        if mode == "wifi":
            params.ip_port = ip_port
            board_id = BoardIds.CYTON_WIFI_BOARD.value
            self.sampling_rate = 1000
        else:
            params.serial_port = serial_port
            board_id = BoardIds.CYTON_BOARD.value
            self.sampling_rate = 250
        self._shim = BoardShim(board_id, params)
        self._shim.prepare_session()
        self._emg_rows = BoardShim.get_emg_channels(board_id)[:EMG_CHANNELS]
        self._analog_rows = BoardShim.get_analog_channels(board_id)[:1]

    def start_stream(self) -> None:
        self._shim.start_stream()

    def stop_stream(self) -> None:
        self._shim.stop_stream()
        self._shim.release_session()

    def get_board_data(self) -> np.ndarray:
        data = self._shim.get_board_data()
        return data[list(self._emg_rows) + list(self._analog_rows)]


class Microphone:
    """A 16 kHz mono microphone through sounddevice (an optional package;
    its ``ImportError`` propagates, as in the JAX package)."""

    def __init__(self, sampling_rate: int = 16000):
        import sounddevice as sd  # type: ignore

        self.sampling_rate = sampling_rate
        self._chunks: List[np.ndarray] = []
        self._stream = sd.InputStream(
            samplerate=sampling_rate, channels=1,
            callback=self._on_audio)

    def _on_audio(self, indata, frames, time_info, status):
        if status:
            logging.warning("audio status: %s", status)
        self._chunks.append(indata[:, 0].copy())

    def start_stream(self) -> None:
        self._chunks = []
        self._stream.start()

    def stop_stream(self) -> None:
        self._stream.stop()

    def get_audio(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, dtype=np.float32)
        out = np.concatenate(self._chunks)
        self._chunks = []
        return out


class SyntheticMicrophone:
    """Hardware-free microphone: low-level noise from the seed, the
    samples due since the last call in wall-clock time."""

    sampling_rate = 16000

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._t0: Optional[float] = None
        self._consumed = 0

    def start_stream(self) -> None:
        self._t0 = time.monotonic()
        self._consumed = 0

    def stop_stream(self) -> None:
        self._t0 = None

    def get_audio(self) -> np.ndarray:
        if self._t0 is None:
            raise RuntimeError("stream not started")
        avail = int((time.monotonic() - self._t0) * self.sampling_rate)
        n = max(avail - self._consumed, 0)
        self._consumed += n
        return (0.01 * self._rng.normal(size=n)).astype(np.float32)


class LiveScope:
    """Rolling matplotlib scope of the audio and the 8 EMG channels with
    an RMS readout (reference ``record_data.py:100-130``). matplotlib is
    optional: without it each tick is a plain sleep."""

    COLORS = ["grey", "mediumpurple", "blue", "green", "yellow", "orange",
              "red", "sienna"]

    def __init__(self, recorder, window_seconds: float = 4.0):
        self.recorder = recorder
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            logging.warning("matplotlib unavailable — live scope disabled")
            self._plt = None
            return
        self._plt = plt
        w = int(window_seconds * recorder.emg_rate)
        aw = int(window_seconds * recorder.microphone.sampling_rate)
        self._w, self._aw = w, aw
        plt.ion()
        self._fig, (a_ax, e_ax) = plt.subplots(2)
        a_ax.axis((0, aw, -1, 1))
        e_ax.axis((0, w, -300, 300))
        self._a_line, = a_ax.plot(np.zeros(aw))
        self._e_lines = e_ax.plot(np.zeros((w, EMG_CHANNELS)))
        for line, c in zip(self._e_lines, self.COLORS):
            line.set_color(c)
        self._text = e_ax.text(50, -250, "RMS: 0")
        for ax in (a_ax, e_ax):
            ax.set_yticks([0])
            ax.yaxis.grid(True)
            ax.tick_params(bottom=False, top=False, labelbottom=False,
                           right=False, left=False, labelleft=False)
        self._fig.tight_layout(pad=0)

    @staticmethod
    def _last_window(chunks, n, width):
        flat = (np.concatenate(chunks, axis=0) if chunks
                else np.zeros((0, width) if width > 1 else 0))
        flat = flat[-n:]
        pad = n - flat.shape[0]
        if pad > 0:
            shape = (pad, width) if width > 1 else (pad,)
            flat = np.concatenate([np.zeros(shape, flat.dtype), flat],
                                  axis=0)
        return flat

    def tick(self) -> None:
        if self._plt is None:
            time.sleep(0.005)
            return
        a = self._last_window(self.recorder._audio_chunks, self._aw, 1)
        self._a_line.set_ydata(a)
        e = self._last_window(self.recorder._emg_chunks, self._w,
                              EMG_CHANNELS)
        for col, line in enumerate(self._e_lines):
            line.set_ydata(e[:, col])
        rate = self.recorder.emg_rate
        self._text.set_text(
            f"RMS: {e[-rate * 2: -rate // 2].std():.1f}")
        self._plt.gcf().canvas.draw_idle()
        self._plt.gcf().canvas.start_event_loop(0.005)

    def close(self) -> None:
        if self._plt is not None:
            self._plt.close(self._fig)


class Recorder:
    """Pumps the EMG and audio streams, one utterance at a time: chunked
    draining of the board's buffer, sample-drop detection against the wall
    clock (``record_data.py:152-155``), and the button channel beside the
    EMG rows. ``debug`` picks the synthetic board and microphone where
    none is given."""

    def __init__(self, debug: bool = True, board=None, microphone=None,
                 display: bool = False):
        if board is None:
            board = SyntheticBoard() if debug else BrainFlowBoard()
        if microphone is None:
            microphone = SyntheticMicrophone() if debug else Microphone()
        self.board = board
        self.microphone = microphone
        self.emg_rate = board.sampling_rate
        self._emg_chunks: List[np.ndarray] = []
        self._audio_chunks: List[np.ndarray] = []
        self._button_chunks: List[np.ndarray] = []
        self._scope = LiveScope(self) if display else None

    # ---- the streaming session (reference record_data.py:132-170) -----
    def __enter__(self) -> "Recorder":
        self.board.start_stream()
        self.microphone.start_stream()
        self._emg_chunks, self._audio_chunks, self._button_chunks = \
            [], [], []
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.microphone.stop_stream()
        self.board.stop_stream()
        if self._scope is not None:
            self._scope.close()

    def update(self) -> None:
        """Pump both streams once. Each pump's reads are one chunk, so that
        ``info['chunks']`` holds the reference's (emg_len, audio_len,
        button_len) tuples (``record_data.py:139-170``)."""
        if self._scope is not None:
            self._scope.tick()
        else:
            time.sleep(0.005)
        audio = self.microphone.get_audio()
        if audio.shape[0] == 0:
            return
        self._audio_chunks.append(audio)
        data = self.board.get_board_data()
        emg = data[:EMG_CHANNELS].T
        button = (data[EMG_CHANNELS].astype(bool)
                  if data.shape[0] > EMG_CHANNELS
                  else np.zeros(emg.shape[0], bool))
        self._emg_chunks.append(emg)
        self._button_chunks.append(button)
        if button.any():
            logging.info("button pressed")

    def get_data(self):
        """(emg (T, 8), audio (A,), button (T,), chunk sizes) accumulated
        since the last call, which clears them (``record_data.py:163-170``).
        """
        emg = (np.concatenate(self._emg_chunks, axis=0)
               if self._emg_chunks else np.zeros((0, EMG_CHANNELS)))
        audio = (np.concatenate(self._audio_chunks)
                 if self._audio_chunks else np.zeros(0, np.float32))
        button = (np.concatenate(self._button_chunks)
                  if self._button_chunks else np.zeros(0, bool))
        chunk_sizes = [
            (e.shape[0], a.shape[0], b.shape[0])
            for e, a, b in zip(self._emg_chunks, self._audio_chunks,
                               self._button_chunks)]
        self._emg_chunks, self._audio_chunks, self._button_chunks = \
            [], [], []
        return emg, audio, button, chunk_sizes

    def record(self, seconds: float
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Record for ``seconds``: (emg (T, 8), audio (A,), button (T,))."""
        self.board.start_stream()
        self.microphone.start_stream()
        t0 = time.monotonic()
        emg_parts: List[np.ndarray] = []
        while time.monotonic() - t0 < seconds:
            time.sleep(0.02)
            emg_parts.append(self.board.get_board_data())
        emg_parts.append(self.board.get_board_data())
        audio = self.microphone.get_audio()
        self.microphone.stop_stream()
        self.board.stop_stream()

        data = np.concatenate([p for p in emg_parts if p.shape[1]], axis=1)
        emg = data[:EMG_CHANNELS].T
        button = data[EMG_CHANNELS] if data.shape[0] > EMG_CHANNELS \
            else np.zeros(emg.shape[0])

        expected = seconds * self.emg_rate
        if emg.shape[0] < 0.95 * expected:
            logging.warning(
                "possible dropped samples: got %d EMG samples, expected ~%d",
                emg.shape[0], int(expected))
        return emg, audio, button
