"""Recording session: prompt sentences and write the dataset's schema.

Own copy of the JAX package's ``silent_speech_tpu/capture/session.py``
(reference ``data_collection/record_reading.py``). For each utterance i it
writes ``{i}_emg.npy``, ``{i}_audio.flac``, ``{i}_button.npy`` and
``{i}_info.json`` with ``{book, sentence_index, text, chunks}``
(``record_reading.py:30-52``), the schema ``EMGDataset`` reads once
``capture.clean_audio`` has written ``{i}_audio_clean.flac``. It runs on
the host and touches no device.

CLI, one sentence a prompt (Enter records, ``r`` re-records the previous
sentence, ``q`` quits; the session ends with the book), or the reference's
curses prompter with chunked recording::

    python -m silent_speech_tpu_torch.capture.session \\
        --output_directory sess/ --book_file book.txt [--debug] \\
        [--seconds 4.0] [--curses] [--display]

``--debug`` records from the synthetic board and microphone.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from ..utils.flac import write_flac
from .book import Book
from .recorder import Recorder

AUDIO_RATE = 16000  # the chunked session's microphone rate


def _refuse_overwrite(path: str, what: str) -> None:
    # reference record_reading.py:36
    if os.path.exists(path):
        raise FileExistsError(f"refusing to overwrite existing {what} "
                              f"{path}")


def record_utterance(recorder: Recorder, output_directory: str, index: int,
                     text: str, book_name: str, sentence_index: int,
                     seconds: float) -> dict:
    """Record one utterance for ``seconds`` and write the four schema
    files; raises ``FileExistsError`` rather than overwrite them."""
    info_path = os.path.join(output_directory, f"{index}_info.json")
    _refuse_overwrite(info_path, "utterance")
    os.makedirs(output_directory, exist_ok=True)

    emg, audio, button = recorder.record(seconds)
    np.save(os.path.join(output_directory, f"{index}_emg.npy"), emg)
    np.save(os.path.join(output_directory, f"{index}_button.npy"), button)
    write_flac(os.path.join(output_directory, f"{index}_audio.flac"),
               audio.astype(np.float32), recorder.microphone.sampling_rate)

    info = {
        "text": text,
        "book": book_name,
        "sentence_index": sentence_index,
        "chunks": [[int(emg.shape[0]), int(audio.shape[0]), 0]],
    }
    with open(info_path, "w") as f:
        json.dump(info, f)
    return info


def run_session(output_directory: str, book_file: str,
                debug: bool = True, seconds_per_sentence: float = 4.0,
                max_sentences: Optional[int] = None,
                interactive: bool = True) -> int:
    """The prompted recording loop; returns the number of utterances
    recorded. Interactive keys as the reference's: Enter records the next
    sentence, ``r`` re-records the previous one under a new index, ``q``
    quits. Numbering continues after the directory's last utterance."""
    book = Book(book_file)
    recorder = Recorder(debug=debug)
    os.makedirs(output_directory, exist_ok=True)
    existing = [int(f.split("_")[0])
                for f in os.listdir(output_directory)
                if f.endswith("_info.json")]
    index = max(existing) + 1 if existing else 0
    recorded = 0

    while not book.done():
        if max_sentences is not None and recorded >= max_sentences:
            break
        text = book.current_sentence()
        if interactive:
            print(f"\n[{book.current_sentence_index()}] {text}")
            cmd = input("Enter=record  r=redo-prev  q=quit > ").strip()
            if cmd == "q":
                break
            if cmd == "r" and recorded > 0:
                book.position = max(book.position - 1, 0)
                text = book.current_sentence()
        record_utterance(
            recorder, output_directory, index, text, book.name,
            book.current_sentence_index(), seconds_per_sentence)
        index += 1
        recorded += 1
        book.advance()
    return recorded


# ---- the chunk-streamed session (reference record_reading.py) ----------


def save_chunked(output_directory: str, output_idx: int, data,
                 book=None) -> None:
    """Write one captured segment in the reference schema
    (``record_reading.py:30-52``). ``book=None`` marks a silence segment
    (book '', sentence_index −1, empty text)."""
    emg, audio, button, chunk_info = data
    emg_file = os.path.join(output_directory, f"{output_idx}_emg.npy")
    _refuse_overwrite(emg_file, "segment")
    np.save(emg_file, emg)
    write_flac(os.path.join(output_directory, f"{output_idx}_audio.flac"),
               np.asarray(audio, np.float32), AUDIO_RATE)
    np.save(os.path.join(output_directory, f"{output_idx}_button.npy"),
            np.asarray(button, bool))
    if book is None:
        bf, bi, t = "", -1, ""
    else:
        bf, bi, t = book.name, book.current_sentence_index(), \
            book.current_sentence()
    with open(os.path.join(output_directory,
                           f"{output_idx}_info.json"), "w") as f:
        json.dump({"book": bf, "sentence_index": bi, "text": t,
                   "chunks": [list(c) for c in chunk_info]}, f)


def edge_silence_segments(data):
    """The first and last 500 EMG samples as silence segments
    (``record_reading.py:56-62``)."""
    emg, audio, button, chunk_info = data
    dummy_audio = np.zeros(8000, np.float32)
    dummy_button = np.zeros(500, bool)
    ci = [(500, 8000, 500)]
    return ((emg[:500], dummy_audio, dummy_button, ci),
            (emg[-500:], dummy_audio, dummy_button, ci))


class ReadingSession:
    """The key protocol of the reference's curses prompter
    (``record_reading.py:64-123``):

    - the first key starts recording (a leading-silence segment);
    - ``n`` or space saves the segment read since the last key (index 0 is
      the silence segment, with no book) and advances the book;
    - ``r`` restarts: saves the edge silences and prompts the sentence
      again;
    - ``q`` saves the leading edge as silence and stops.

    The curses shell only renders around it, so the protocol runs without
    a terminal.
    """

    def __init__(self, recorder, book, output_directory: str):
        self.recorder = recorder
        self.book = book
        self.output_directory = output_directory
        os.makedirs(output_directory, exist_ok=True)
        self.output_idx = 0
        self.recording = False
        self.done = False

    def current_prompt(self) -> str:
        if not self.recording:
            return "<Press any key to begin.>"
        if self.output_idx == 0:
            return "<silence>"
        return self.book.current_sentence()

    def handle_key(self, key: str) -> None:
        if self.done:
            return
        if not self.recording:
            self.recording = True
            self.recorder.get_data()  # drop the pre-roll
            return
        if key == "q":
            start, _end = edge_silence_segments(self.recorder.get_data())
            save_chunked(self.output_directory, self.output_idx, start)
            self.done = True
        elif key in ("n", " "):
            data = self.recorder.get_data()
            if self.output_idx == 0:
                save_chunked(self.output_directory, 0, data)
            else:
                save_chunked(self.output_directory, self.output_idx, data,
                             self.book)
                self.book.advance()
            self.output_idx += 1
        elif key == "r":
            if self.output_idx == 0:
                self.recorder.get_data()
            else:
                start, end = edge_silence_segments(
                    self.recorder.get_data())
                save_chunked(self.output_directory, self.output_idx, start)
                self.output_idx += 1
                save_chunked(self.output_directory, self.output_idx, end)
                self.output_idx += 1


def run_curses_session(output_directory: str, book_file: str,
                       debug: bool = True, display: bool = False) -> int:
    """The interactive curses prompter (reference ``record_reading.py``);
    returns the next segment index."""
    import curses
    import textwrap

    def loop(stdscr):
        curses.curs_set(False)
        stdscr.nodelay(True)
        text_win = curses.newwin(curses.LINES - 1, curses.COLS, 0, 0)

        def show(sentence):
            height, width = text_win.getmaxyx()
            text_win.clear()
            for i, line in enumerate(textwrap.wrap(sentence, width)):
                if i >= height:
                    break
                text_win.addstr(i, 0, line)
            text_win.refresh()

        with Recorder(debug=debug, display=display) as recorder, \
                Book(book_file) as book:
            session = ReadingSession(recorder, book, output_directory)
            stdscr.clear()
            stdscr.addstr(0, 0, session.current_prompt())
            stdscr.refresh()
            while not session.done and not book.done():
                recorder.update()
                c = stdscr.getch()
                if c < 0:
                    continue
                was_recording = session.recording
                session.handle_key(chr(c) if 0 <= c < 256 else "")
                if not was_recording and session.recording:
                    stdscr.addstr(
                        curses.LINES - 1, 0,
                        "Type 'q' to quit, 'n' or ' ' for next, "
                        "'r' to restart segment")
                show(session.current_prompt())
                stdscr.refresh()
            return session.output_idx

    return curses.wrapper(loop)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Record a reading session in the dataset's schema "
                    "(host side).")
    p.add_argument("--output_directory", required=True)
    p.add_argument("--book_file", required=True)
    p.add_argument("--debug", action="store_true",
                   help="use the synthetic board (no hardware)")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--curses", action="store_true",
                   help="reference-style curses prompter with "
                        "button-marked chunked recording")
    p.add_argument("--display", action="store_true",
                   help="live signal scope (matplotlib)")
    args = p.parse_args(argv)
    if args.curses:
        return run_curses_session(args.output_directory, args.book_file,
                                  debug=args.debug, display=args.display)
    return run_session(args.output_directory, args.book_file,
                       debug=args.debug, seconds_per_sentence=args.seconds)


if __name__ == "__main__":
    main()
