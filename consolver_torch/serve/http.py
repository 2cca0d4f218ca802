"""Stdlib HTTP front-end for the serving engines.

Port of ``consolver_tpu/serve/http.py``.

Endpoints
---------
``GET /healthz``          liveness probe -> ``{"ok": true}``
``GET /v1/stats``         engine counters (batches, occupancy, errors, latency)
                          and ``spans``: per span name, ``count``,
                          ``total_ms``, ``self_ms`` and ``blocked_ms`` since
                          the engine started (below)
``POST /v1/generate``     ``{"prompt", "seed", "num_inference_steps",
                          "guidance_scale", "solver", "deterministic"}`` ->
                          JSON with a base64 PNG (``image_png_b64``) + timing;
                          an omitted field takes the engine family's default
                          (SD-1.5: consistencysolver at 3.0; SD3: fmppo at 3.5).
``POST /v1/edit``         ``{"instruction", "image_png_b64", "seed",
                          "num_inference_steps", "guidance_scale", "solver",
                          "deterministic"}`` -> the edited image as base64
                          PNG; 404 unless the server has an edit engine.
``POST /v1/refine``       the body of ``/v1/generate``, defaulting to the
                          engine's refine signature (SD-1.5: the teacher's,
                          40-step multistep DPM): the
                          preview -> refine product loop.  A request's noise
                          comes from its ``seed`` alone, so refining with the
                          preview's seed starts from the preview's noise.
                          400 on an SD3 server, which has no refine signature.
``POST /v1/edit/refine``  the edit twin: the body of ``/v1/edit``, defaulting
                          to the edit engine's refine signature (the
                          full-quality Kontext one, 28-step Euler at guidance
                          2.5); same seed contract.
``POST /v1/admin/reload_factor``  hot-reload the policy from a server-side
                          checkpoint: ``{"path": ..., "engine": "generate" |
                          "edit"}`` (``engine`` optional with one engine).
                          Batches in flight finish on the old policy; other
                          dims are refused with 409.  ``path`` is read on the
                          SERVER host: keep the port private.

Limits: bodies over ``MAX_BODY_BYTES`` are refused 413 before being read;
images over ``MAX_EDIT_PIXELS`` are refused 400 from the PNG header, before
any pixel is decoded; anything but an 8-bit non-interlaced PNG is refused
400.  A request past the engine's ``max_wait_s`` queue deadline returns 503.

A ``ThreadingHTTPServer`` handles the sockets; every handler thread blocks on
the engine's future, so concurrent requests coalesce into one batch.

Where the time goes, for an operator: ``/v1/stats``'s ``spans`` holds the
running totals of the program's spans (:mod:`consolver_torch.utils.
profiling`).  Each generate or edit request gets an id, and its handler
records ``serve.request`` (the whole handler), ``serve.png_decode`` (an
edit's source), ``serve.engine_wait`` (blocked on the engine) and
``serve.png_encode`` (the answer's PNG and base64); the engine adds
``engine.queue``, ``engine.batch``, ``engine.prep`` and ``engine.fetch``,
and the pipeline ``pipeline.text``, ``pipeline.vae_encode``,
``pipeline.step`` (with ``model.unet`` / ``model.dit`` and
``pipeline.policy`` inside), ``pipeline.decode`` and ``host.sync`` (a copy
or call of the step loops or their set-up that blocks the host on the card;
``blocked_ms`` is the time such spans take inside a span).  Differences of two reads give a window's means.
For a timeline, run the server inside ``profiling.trace(log_dir)``: the
chrome trace it writes holds the same spans as ranges named
``<span>#<id>`` on the threads that ran them, beside the kernels they
launched.
"""

from __future__ import annotations

import base64
import binascii
import itertools
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from consolver_torch.serve.engine import EditInferenceEngine, InferenceEngine, RequestExpired
from consolver_torch.utils import profiling
from consolver_torch.utils.png import decode_png, encode_png, png_size

# one oversized /v1/edit body would otherwise fill host RAM before any check
MAX_BODY_BYTES = 64 * 1024 * 1024
# checked from the PNG header, before the pixels are decoded
MAX_EDIT_PIXELS = 16 * 1024 * 1024


def _json_bool(value) -> bool:
    """Strict JSON boolean: ``bool("false")`` is True, so a permissive cast
    would flip the determinism knob on a string-typed field."""
    if not isinstance(value, bool):
        raise ValueError(f"'deterministic' must be a JSON boolean, got {value!r}")
    return value


_COMMON_FIELDS = {
    "seed": int,
    "num_inference_steps": int,
    "guidance_scale": float,
    "solver": str,
    "deterministic": _json_bool,
}
_GENERATE_FIELDS = {"prompt": str, **_COMMON_FIELDS}
_GENERATE_PATHS = ("/v1/generate", "/v1/refine")
_EDIT_PATHS = ("/v1/edit", "/v1/edit/refine")
_EDIT_FIELDS = {"instruction": str, **_COMMON_FIELDS}
# each takes the refine signature of its engine (``engine.request``)
_REFINE_PATHS = ("/v1/refine", "/v1/edit/refine")


def _png_b64(image: np.ndarray) -> str:
    # zlib level 1: the encode sits on every request's latency, and level 6
    # costs several times as much for a somewhat smaller file
    return base64.b64encode(encode_png(image, level=1)).decode("ascii")


def _decode_image_b64(b64: str) -> np.ndarray:
    raw = base64.b64decode(b64, validate=True)
    w, h = png_size(raw)  # the header alone: bound the allocation first
    if w * h > MAX_EDIT_PIXELS:
        raise ValueError(f"image {w}x{h} = {w * h} pixels exceeds the "
                         f"{MAX_EDIT_PIXELS}-pixel limit")
    return decode_png(raw)


class ServeHandler(BaseHTTPRequestHandler):
    server: "ServeServer"

    def log_message(self, fmt, *args):  # noqa: A003 - silence the per-request log line
        pass

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib name
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/v1/stats":
            stats = {}
            if self.server.engine is not None:
                stats["generate"] = self.server.engine.stats()
            if self.server.edit_engine is not None:
                stats["edit"] = self.server.edit_engine.stats()
            if len(stats) == 1:  # a single-engine server keeps the flat shape
                stats = next(iter(stats.values()))
            self._reply(200, stats)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def _parse(self, fields: dict, payload: dict, required: str) -> dict:
        if required not in payload:
            raise ValueError(f"missing required field '{required}'")
        return {name: cast(payload[name]) for name, cast in fields.items() if name in payload}

    def do_POST(self):  # noqa: N802 - stdlib name
        engine = (self.server.engine if self.path in _GENERATE_PATHS
                  else self.server.edit_engine if self.path in _EDIT_PATHS else None)
        if engine is None:  # admin, an unknown path or a family this server lacks
            self._post(None, None)
            return
        rid = next(self.server.request_ids)
        with profiling.use(engine.spans), profiling.span("serve.request", rid):
            self._post(engine, rid)

    def _post(self, engine, rid: Optional[int]) -> None:
        """The POST handler: ``engine`` is the path's engine and ``rid`` the
        request's id, both None where the path has no engine."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                self._reply(413, {"error": f"body {length} bytes exceeds the "
                                           f"{MAX_BODY_BYTES}-byte limit"})
                return
            payload = json.loads(self.rfile.read(length) or b"{}")
        except ValueError as exc:  # includes json.JSONDecodeError
            self._reply(400, {"error": str(exc)})
            return

        if self.path == "/v1/admin/reload_factor":
            self._admin_reload_factor(payload)
            return
        edit = self.path in _EDIT_PATHS
        if not (edit or self.path in _GENERATE_PATHS):
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        if engine is None:
            self._reply(404, {"error": f"no {'edit' if edit else 'text-to-image'} engine "
                                       "configured"})
            return
        try:
            kwargs = (self._parse(_EDIT_FIELDS, payload, "instruction") if edit
                      else self._parse(_GENERATE_FIELDS, payload, "prompt"))
            if edit:
                if "image_png_b64" not in payload:
                    raise ValueError("missing required field 'image_png_b64'")
                with profiling.span("serve.png_decode", rid):
                    kwargs["image"] = _decode_image_b64(payload["image_png_b64"])
            # the omitted fields take the engine's family's defaults
            request = engine.request(refine=self.path in _REFINE_PATHS, **kwargs)
        except (ValueError, TypeError, binascii.Error) as exc:
            self._reply(400, {"error": str(exc)})
            return

        t0 = time.monotonic()
        try:
            with profiling.span("serve.engine_wait", rid):
                image = engine.generate(request, timeout=self.server.request_timeout,
                                        request_id=rid)
        except RequestExpired as exc:  # queue deadline: shed, retryable
            self._reply(503, {"error": f"RequestExpired: {exc}"})
            return
        except Exception as exc:  # an engine or solver error -> 500 with its message
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        with profiling.span("serve.png_encode", rid):
            png = _png_b64(image)
        self._reply(200, {
            "image_png_b64": png,
            "height": int(image.shape[0]),
            "width": int(image.shape[1]),
            "seed": request.seed,
            "latency_ms": round((time.monotonic() - t0) * 1e3, 1),
        })

    def _admin_reload_factor(self, payload: dict) -> None:
        engines = {}
        if self.server.engine is not None:
            engines["generate"] = self.server.engine
        if self.server.edit_engine is not None:
            engines["edit"] = self.server.edit_engine
        name = payload.get("engine")
        if name is None and len(engines) == 1:
            name = next(iter(engines))
        if name not in engines:
            self._reply(400, {"error": f"'engine' must be one of {sorted(engines)}"})
            return
        path = payload.get("path")
        if not isinstance(path, str) or not path:
            self._reply(400, {"error": "missing required field 'path'"})
            return
        try:
            out = engines[name].load_factor_ckpt(path)
        except ValueError as exc:  # dims / config mismatch: a serving-program property
            self._reply(409, {"error": str(exc)})
            return
        except Exception as exc:  # an unreadable or corrupt checkpoint
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, {"ok": True, "engine": name, **out})


class ServeServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: with socketserver's default of 5, a burst of
    # concurrent clients overflows it and the dropped connects retry a
    # second later, missing the batch they were meant to join
    request_queue_size = 128

    def __init__(self, address, engine: Optional[InferenceEngine],
                 request_timeout: float = 600.0,
                 edit_engine: Optional[EditInferenceEngine] = None):
        super().__init__(address, ServeHandler)
        self.engine = engine
        self.edit_engine = edit_engine
        self.request_timeout = request_timeout
        # each generate or edit request's id, in its spans and its batch's
        self.request_ids = itertools.count(1)


def make_server(
    engine: Optional[InferenceEngine] = None,
    host: str = "127.0.0.1",
    port: int = 8000,
    request_timeout: float = 600.0,
    edit_engine: Optional[EditInferenceEngine] = None,
) -> ServeServer:
    """Bind (``port=0`` picks a free one; read ``server.server_address``).
    ``engine`` serves ``/v1/generate`` and ``/v1/refine`` (SD family),
    ``edit_engine`` ``/v1/edit`` and ``/v1/edit/refine`` (FLUX-Kontext);
    pass both to serve the two families from one process."""
    if engine is None and edit_engine is None:
        raise ValueError("need at least one engine")
    return ServeServer((host, port), engine, request_timeout, edit_engine=edit_engine)
