"""HTTP front end of the port, standard library only.

Endpoints (JSON in and out; binary payloads base64):

  GET  /healthz        -> {"status": "ok"}  (never needs auth)
  GET  /stats          -> engine counters (per model when several)
  GET  /v1/models      -> {"models": [...], "default": ...}
  POST /v1/transfer    -> {"content_wav_b64" | "content_png_b64",
                           "style_png_b64" | "style_wav_b64", "seed": 0}
                       <- {"image_png_b64", "audio_wav_b64"}
  POST /v1/generate    -> {"style_png_b64" | "style_wav_b64", "seed": 0}
                          (generation from noise, synchronous)
                       <- {"image_png_b64", "audio_wav_b64"}
  POST /v1/models/<name>/{transfer|generate} -> the same, on that model

Hardening: optional bearer-token auth (401), a request size limit (413),
a per-request timeout (504, the generate lock included) and load
shedding on the engine's pending count (429 with Retry-After).

WAV inputs become images on the engine's device (``engine.ap``, kernel C
on the card); PNGs are read and written by ``utils/png.py``.  The
engines are warmed before the server listens, so a kernel that does not
build fails the start, not a request.
"""

from __future__ import annotations

import base64
import hmac
import io
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
from scipy.io import wavfile

from music_style_transfer_ldm_tpu_torch.audio.io import (
    _to_float_mono, resample, write_wav,
)
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    unit_image_to_uint8,
)
from music_style_transfer_ldm_tpu_torch.datasets.folder import (
    image_unit_from_gray,
)
from music_style_transfer_ldm_tpu_torch.utils.png import (
    read_png_gray, write_png_gray,
)

MAX_REQUEST_BYTES = 32 * 1024 * 1024  # base64 WAV/PNG payloads
DEFAULT_TIMEOUT_S = 120.0
DEFAULT_MAX_QUEUE = 256


def _png_to_image(b: bytes, size: int = 128) -> np.ndarray:
    return image_unit_from_gray(read_png_gray(b), size)


def _wav_to_image(b: bytes, ap, size: int = 128) -> np.ndarray:
    """WAV bytes -> [size, size, 1] image: mono, resample, trim, the
    first 3 s through the front end (the CLI's preprocessing)."""
    sr, data = wavfile.read(io.BytesIO(b))
    y = resample(_to_float_mono(data), int(sr), ap.target_sr)
    return ap.clip_to_content_image(ap.trim_silence(y), size=size)


def _image_to_png_b64(img01: np.ndarray) -> str:
    u8 = unit_image_to_uint8(img01[..., 0]).numpy()
    return base64.b64encode(write_png_gray(u8)).decode()


def _audio_to_wav_b64(audio: np.ndarray, sr: int) -> str:
    buf = io.BytesIO()
    write_wav(buf, audio, sr)
    return base64.b64encode(buf.getvalue()).decode()


def make_handler(engine, max_request_bytes: int = MAX_REQUEST_BYTES,
                 auth_token: str | None = None,
                 request_timeout_s: float = DEFAULT_TIMEOUT_S,
                 max_queue: int = DEFAULT_MAX_QUEUE):
    """``engine`` is one InferenceEngine or a {name: engine} dict (the
    first entry is the default model, served at /v1/transfer).
    auth_token: every endpoint but /healthz then needs
    'Authorization: Bearer <token>'.  request_timeout_s bounds the wait
    for the engine (504); max_queue sheds load (429) while the target
    engine has that many requests pending."""
    engines = engine if isinstance(engine, dict) else {"default": engine}
    if not engines:
        raise ValueError("need at least one engine")
    default_name = next(iter(engines))

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict, headers=()) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def _authorized(self) -> bool:
            if auth_token is None:
                return True
            got = self.headers.get("Authorization", "")
            # constant-time compare: the token must not leak via timing
            return hmac.compare_digest(got, f"Bearer {auth_token}")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif not self._authorized():
                self._json(401, {"error": "unauthorized"})
            elif self.path == "/stats":
                if len(engines) == 1:
                    self._json(200, engines[default_name].stats())
                else:
                    self._json(200, {"models": {n: e.stats()
                                                for n, e in engines.items()}})
            elif self.path == "/v1/models":
                self._json(200, {"models": list(engines),
                                 "default": default_name})
            else:
                self._json(404, {"error": "not found"})

        def _route(self):
            """(model name, op) of a POST path, or None."""
            if self.path in ("/v1/transfer", "/v1/generate"):
                return default_name, self.path.rsplit("/", 1)[1]
            parts = self.path.strip("/").split("/")
            if (len(parts) == 4 and parts[:2] == ["v1", "models"]
                    and parts[3] in ("transfer", "generate")):
                return parts[2], parts[3]
            return None

        def do_POST(self):
            route = self._route()
            if route is None:
                self._json(404, {"error": "not found"})
                return
            name, op = route
            if not self._authorized():
                self._json(401, {"error": "unauthorized"})
                return
            engine = engines.get(name)
            if engine is None:
                self._json(404, {"error": f"unknown model {name!r}"})
                return
            if engine.pending() >= max_queue:
                self._json(429, {"error": "server overloaded"},
                           headers=[("Retry-After", "1")])
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > max_request_bytes:
                    # Drain so the client can finish writing and read the
                    # status instead of hitting a broken pipe.
                    remaining = length
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    self._json(413, {"error": f"request body {length} bytes "
                                              f"exceeds {max_request_bytes}"})
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                style = self._decode_input(engine, req, "style")
                seed = int(req.get("seed", 0))
                if op == "generate":
                    batch = engine.generate(style[None], seed=seed,
                                            timeout=request_timeout_s)
                    out = {k: v[0] for k, v in batch.items()}
                else:
                    content = self._decode_input(engine, req, "content")
                    done = engine.submit(content, style, seed=seed)
                    out = done.get(timeout=request_timeout_s)
                    if isinstance(out, Exception):
                        raise out
                resp = {"image_png_b64": _image_to_png_b64(out["image"])}
                if "audio" in out:
                    resp["audio_wav_b64"] = _audio_to_wav_b64(
                        out["audio"], engine.ap.target_sr)
                self._json(200, resp)
            except (queue.Empty, TimeoutError):
                self._json(504, {"error": "request timed out after "
                                          f"{request_timeout_s:.0f}s"})
            except KeyError as e:
                self._json(400, {"error": f"missing field: {e}"})
            except Exception as e:  # noqa: BLE001 — serving boundary
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _decode_input(self, engine, req: dict, kind: str) -> np.ndarray:
            size = engine.config.image_size
            if f"{kind}_png_b64" in req:
                return _png_to_image(
                    base64.b64decode(req[f"{kind}_png_b64"]), size)
            if f"{kind}_wav_b64" in req:
                return _wav_to_image(
                    base64.b64decode(req[f"{kind}_wav_b64"]), engine.ap, size)
            raise KeyError(f"{kind}_png_b64 or {kind}_wav_b64")

    return Handler


class _Server(ThreadingHTTPServer):
    # The default listen backlog of 5 resets connections under bursts.
    request_queue_size = 128


def serve(engine, host: str = "127.0.0.1", port: int = 8787,
          block: bool = True, auth_token: str | None = None,
          request_timeout_s: float = DEFAULT_TIMEOUT_S,
          max_queue: int = DEFAULT_MAX_QUEUE
          ) -> Optional[ThreadingHTTPServer]:
    """Start the HTTP server over an engine (or {name: engine}); each
    engine is warmed and started first.  block=False returns the server
    (call ``shutdown()`` and each engine's ``stop()`` to end it)."""
    engines = engine if isinstance(engine, dict) else {"default": engine}
    for e in engines.values():
        e.start()
    httpd = _Server((host, port), make_handler(
        engine, auth_token=auth_token, request_timeout_s=request_timeout_s,
        max_queue=max_queue))
    if block:
        try:
            httpd.serve_forever()
        finally:
            for e in engines.values():
                e.stop()
        return None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd
