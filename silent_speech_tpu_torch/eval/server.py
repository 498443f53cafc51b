"""HTTP serving daemon over the port's bundles (stdlib only).

Counterpart of ``silent_speech_tpu/eval/server.py`` with the same routes and
JSON contract (arrays as nested lists):

- ``GET  /healthz``       → {"ok": true, "kinds": [...]}
- ``POST /v1/recognize``  {"emg": (T,112), "raw_emg": (T*8,8)}
                          → {"log_probs": (T,38), "text": "..."}
- ``POST /v1/transduce``  {"emg": ..., "raw_emg": ..., "session_ids": (T,)}
                          → {"mel": (T,80)}, plus {"audio": (T·hop,)}
                          when a vocoder bundle is attached

A malformed request gets 400, and so does a vocoded request when the
transduction bundle carries no mel normalizer. Requests are handled on
threads; the forwards run one at a time on the card.

Run::

    python -m silent_speech_tpu_torch.eval.server --port 8008 \
        --recognition_bundle rec_serving/ \
        --transduction_bundle trans_serving/ \
        [--vocoder_bundle voc_serving/] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from .export import ServingBundle


class ServingServer:
    """Own the bundles and the HTTP server; ``start()`` returns once bound
    (serving runs on a daemon thread), ``port`` is the bound port."""

    def __init__(self, recognition: Optional[ServingBundle] = None,
                 transduction: Optional[ServingBundle] = None,
                 vocoder: Optional[ServingBundle] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.bundles = {}
        for kind, bundle in (("recognition", recognition),
                             ("transduction", transduction),
                             ("vocoder", vocoder)):
            if bundle is not None:
                if bundle.kind != kind:
                    raise ValueError(f"a {bundle.kind} bundle was passed "
                                     f"as the {kind} bundle")
                self.bundles[kind] = bundle
        if not self.bundles:
            raise ValueError("attach at least one bundle")
        self._model_lock = threading.Lock()

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"ok": True,
                                      "kinds": sorted(server.bundles)})
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/v1/recognize":
                        self._reply(200, server.recognize(req))
                    elif self.path == "/v1/transduce":
                        self._reply(200, server.transduce(req))
                    else:
                        self._reply(404, {"error": f"no route {self.path}"})
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    # ---------------- request handlers (plain python, testable) --------

    @staticmethod
    def _arrays(req: dict):
        emg = np.asarray(req["emg"], np.float32)
        raw = np.asarray(req["raw_emg"], np.float32)
        if emg.ndim != 2 or raw.ndim != 2 or raw.shape[0] != 8 * emg.shape[0]:
            raise ValueError(
                f"expected emg (T,F) and raw_emg (8T,C), got {emg.shape} "
                f"and {raw.shape}")
        return emg, raw

    def _bundle(self, kind: str) -> ServingBundle:
        bundle = self.bundles.get(kind)
        if bundle is None:
            raise ValueError(f"no {kind} bundle attached")
        return bundle

    def recognize(self, req: dict) -> dict:
        bundle = self._bundle("recognition")
        emg, raw = self._arrays(req)
        with self._model_lock:
            lp = bundle.predict(emg, raw)
        return {"log_probs": lp.tolist(), "text": bundle.decode_greedy(lp)}

    def transduce(self, req: dict) -> dict:
        bundle = self._bundle("transduction")
        emg, raw = self._arrays(req)
        sess = np.asarray(req["session_ids"], np.int64)
        voc = self.bundles.get("vocoder")
        if voc is not None and not bundle.has_normalizer:
            raise ValueError(
                "vocoding needs mel denormalization stats: re-export "
                "the transduction bundle with audio_normalizer (the "
                "CLI embeds them when --normalizers_file exists)")
        with self._model_lock:
            mel = bundle.predict(emg, raw, sess)
            audio = (None if voc is None
                     else voc.vocode(bundle.denormalize(mel)))
        out = {"mel": mel.tolist()}
        if audio is not None:
            out["audio"] = audio.tolist()
        return out

    # ---------------- lifecycle ----------------------------------------

    def start(self) -> "ServingServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve the port's bundles over HTTP.")
    ap.add_argument("--recognition_bundle")
    ap.add_argument("--transduction_bundle")
    ap.add_argument("--vocoder_bundle")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the forwards (default cuda)")
    args = ap.parse_args(argv)

    def load(d):
        return ServingBundle.load(d, device=args.device) if d else None

    server = ServingServer(recognition=load(args.recognition_bundle),
                           transduction=load(args.transduction_bundle),
                           vocoder=load(args.vocoder_bundle),
                           host=args.host, port=args.port)
    print(f"serving {sorted(server.bundles)} on "
          f"http://{args.host}:{server.port}", flush=True)
    try:
        server._httpd.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
