"""HTTP front-end for the SwapEngine (stdlib-only, threaded).

Port of ``denoising_diffusion_deep_fake_tpu/serving/server.py``. Endpoints:

* ``GET  /healthz``      — liveness + model info (JSON)
* ``GET  /v1/stats``     — engine counters: batches, occupancy, latency (JSON)
* ``POST /v1/swap``      — body = encoded image (JPEG/PNG, any size; BGR file
                           convention). Center-cropped/resized to the model
                           frame, swapped, returned as JPEG at quality 95.
                           cv2 decodes and encodes where it imports (as
                           the JAX server does); elsewhere the native
                           library (``data/codec.py``), else the request
                           fails naming what is missing.
* ``POST /v1/swap_raw``  — body = raw uint8 frame bytes; header ``X-Shape:
                           H,W,3`` or ``N,H,W,3`` (must match the engine's
                           frame shape). Returns raw uint8 of the same
                           shape. ``X-Format: i420`` (with ``X-Shape: H,W``
                           or ``N,H,W``) carries 4:2:0-packed frames, half
                           the bytes, both ways: passed straight through
                           when the engine's wire is i420, converted on the
                           request thread when it is rgb (and the other way
                           round).

All routes accept ``?identity=a|b`` when the server holds both identities;
without the parameter the first engine serves the request.

Every request thread blocks inside ``SwapEngine.swap``; the engine's
dispatcher micro-batches concurrent requests into shared device batches, so
throughput scales with client concurrency up to the device batch size.

Overload degrades into EARLY shedding: admission is probed from the request
headers alone (frame count comes from ``X-Shape``), so a 503 + Retry-After
goes out before the body is read. ``Expect: 100-continue`` clients pay zero
body bytes on shed (the final 503 replaces the interim 100, RFC 7231
§5.1.1); other clients get the 503 plus a connection close.

Admitted work is CANCELLABLE: an optional per-request deadline (header
``X-Deadline-Ms``, counted from header parse so the body upload spends it;
or the engine's ``request_deadline_ms`` default, counted from dispatch)
turns into a 504 when it passes, and any frames the engine has not yet
packed into a device batch are dropped at gather time.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from denoising_diffusion_deep_fake_tpu_torch.data import codec
from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
    pack_rgb_batch_to_i420_np,
    unpack_i420_batch_to_rgb_np,
    validate_i420_dims,
)
from denoising_diffusion_deep_fake_tpu_torch.serving.engine import (
    EngineOverloadedError,
    RequestExpiredError,
    SwapEngine,
)


def _supported_formats(engine: SwapEngine) -> list[str]:
    """The wire formats the engine's frame geometry can carry."""
    try:
        validate_i420_dims(engine.height, engine.width)
    except ValueError:
        return ["rgb"]
    return ["rgb", "i420"]


def _decode_bgr(body: bytes) -> np.ndarray:
    """An encoded image -> BGR uint8 HWC, as ``cv2.imdecode(IMREAD_COLOR)``."""
    cv2 = codec.cv2_or_none()
    if cv2 is not None:
        frame = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    else:
        try:
            frame = codec.decode_bytes(body)[..., ::-1]
        except (IOError, ValueError):
            frame = None
    if frame is None:
        raise ValueError("body is not a decodable image")
    return frame


def _encode_jpeg(rgb: np.ndarray) -> bytes:
    """RGB uint8 HWC -> JPEG at quality 95, as ``cv2.imencode``."""
    cv2 = codec.cv2_or_none()
    if cv2 is None:
        return codec.encode_jpeg(rgb, 95)
    ok, out = cv2.imencode(".jpg", rgb[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    if not ok:
        raise RuntimeError("jpeg encode failed")
    return out.tobytes()


def _make_handler(engines: dict[str, SwapEngine]):
    default_identity = next(iter(engines))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # --------------------------------------------------------- plumbing

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _drain_body(self) -> None:
            """Consume any unread request body before replying.

            With HTTP/1.1 keep-alive, unread body bytes would be parsed as
            the next request line, corrupting every later request on the
            pooled connection — so every reply path (especially 400/500s
            raised before ``_read_body``) drains first.
            """
            if self.headers.get("Transfer-Encoding"):
                self.close_connection = True  # chunked bodies unsupported
                return
            remaining = getattr(self, "_unread_body", 0)
            while remaining > 0:
                chunk = self.rfile.read(min(remaining, 1 << 20))
                if not chunk:
                    self.close_connection = True
                    return
                remaining -= len(chunk)
            self._unread_body = 0

        def _reply(self, code: int, body: bytes, content_type: str) -> None:
            self._drain_body()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def _note_body_length(self) -> None:
            """Per-request init (handler instances span a whole connection)."""
            self._unread_body = int(self.headers.get("Content-Length", 0) or 0)

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            self._unread_body = 0
            return body

        def _route(self) -> tuple[str, SwapEngine]:
            """Split path from query; pick the engine by ?identity=a|b."""
            parsed = urllib.parse.urlparse(self.path)
            query = urllib.parse.parse_qs(parsed.query)
            identity = query.get("identity", [default_identity])[0]
            engine = engines.get(identity)
            if engine is None:
                raise ValueError(
                    f"identity {identity!r} not served; have "
                    f"{sorted(engines)}")
            return parsed.path, engine

        # -------------------------------------------------- early admission

        def _admission_probe(self) -> None:
            """Shed from headers ALONE — before any body byte is read.

            A raw-RGB wire can saturate on request bytes while the queue sits
            below the watermark, and every eventual shed would then have cost
            a full body upload. The frame count is recoverable from ``X-Shape`` (or is 1 for
            ``/v1/swap``), so overload is detectable for the price of the
            header block. Malformed headers fall through — ``do_POST``'s 400
            path owns those.
            """
            path, engine = self._route()
            if path == "/v1/swap":
                engine.check_admission(1)
                return
            if path != "/v1/swap_raw":
                return
            shape_hdr = self.headers.get("X-Shape")
            if not shape_hdr:
                return
            try:
                shape = tuple(int(s) for s in shape_hdr.split(","))
            except ValueError:
                return
            fmt = self.headers.get("X-Format", "rgb").lower()
            n = 1
            if fmt == "rgb" and len(shape) == 4:
                n = shape[0]
            elif fmt == "i420" and len(shape) == 3:
                n = shape[0]
            engine.check_admission(max(1, n))

        def handle_expect_100(self):
            """``Expect: 100-continue`` face of early shedding.

            A well-behaved client that sends the header pays ZERO body bytes
            on overload: the 503 (final status) replaces the interim 100, and
            per RFC 7231 §5.1.1 the client must not transmit the body.
            """
            try:
                self._admission_probe()
            except EngineOverloadedError as e:
                self._reply_overloaded(e, drained=False)
                return False
            except Exception:
                pass  # surface routing/validation errors from do_POST
            return super().handle_expect_100()

        def _reply_overloaded(self, e: EngineOverloadedError, *,
                              drained: bool) -> None:
            """503 + Retry-After (drain estimate). ``drained=False`` means
            the request body was never read — close the connection instead
            of consuming payload bytes we refused to serve."""
            if drained:
                self._drain_body()
            else:
                self.close_connection = True
            body = json.dumps({"error": str(e)}).encode()
            self.send_response(503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After",
                             str(max(1, round(e.retry_after_s))))
            self.send_header("Content-Length", str(len(body)))
            if not drained:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        # ------------------------------------------------------------- GET

        def do_GET(self):
            self._note_body_length()
            try:
                path, engine = self._route()
            except ValueError as e:
                self._reply_json(400, {"error": str(e)})
                return
            if path == "/healthz":
                self._reply_json(200, {
                    "status": "ok",
                    "identities": sorted(engines),
                    "frame_shape": [engine.height, engine.width, 3],
                    "batch_size": engine.batch_size,
                    "transfer": engine.transfer,
                    "formats": _supported_formats(engine),
                })
            elif path == "/v1/stats":
                self._reply_json(200, engine.stats())
            else:
                self._reply_json(404, {"error": f"unknown path {path}"})

        # ------------------------------------------------------------ POST

        def _parse_deadline(self) -> None:
            """Per-request deadline from ``X-Deadline-Ms`` (optional).

            The clock starts at header parse, so the BODY UPLOAD time counts
            against it — a client on a saturated wire whose payload arrives
            after its own deadline is answered 504 without touching the
            engine. Absent the header, the engine's configured
            ``request_deadline_ms`` applies (measured from dispatch)."""
            self._deadline = None
            hdr = self.headers.get("X-Deadline-Ms")
            if hdr:
                try:
                    ms = float(hdr)
                except ValueError:
                    raise ValueError(f"bad X-Deadline-Ms {hdr!r}")
                if ms > 0:
                    self._deadline = time.monotonic() + ms / 1000.0

        def _remaining_deadline_ms(self) -> float | None:
            """None = use the engine default; raises if already expired."""
            if getattr(self, "_deadline", None) is None:
                return None
            remaining = (self._deadline - time.monotonic()) * 1000.0
            if remaining <= 0:
                raise RequestExpiredError(
                    "deadline passed before the request body finished "
                    "uploading")
            return remaining

        def do_POST(self):
            self._note_body_length()
            try:
                self._parse_deadline()
                path, engine = self._route()
                # Header-only admission probe: shed BEFORE reading the body
                # (the authoritative all-or-nothing check in swap_wire still
                # runs after the read — the queue may fill while the body
                # streams in).
                self._admission_probe()
                if path == "/v1/swap":
                    self._swap_encoded(engine)
                elif path == "/v1/swap_raw":
                    self._swap_raw(engine)
                else:
                    self._reply_json(404, {"error": f"unknown path {path}"})
            except ValueError as e:
                self._reply_json(400, {"error": str(e)})
            except RequestExpiredError as e:
                # The client's deadline passed (engine-side, or during the
                # body upload). 504: the request was admitted but its answer
                # could not be delivered in time — distinct from the 503
                # shed, which never admitted it.
                self._reply_json(504, {"error": str(e)})
            except EngineOverloadedError as e:
                # Load shed: bounded queueing delay for admitted requests,
                # an honest signal (with a drain estimate) for the rest.
                # A body left unread (the probe shed it) is never drained —
                # refused requests shouldn't cost their payload bytes.
                self._reply_overloaded(
                    e, drained=getattr(self, "_unread_body", 0) == 0)
            except Exception as e:  # surface engine errors as 500s
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})

        def _swap_encoded(self, engine: SwapEngine):
            from denoising_diffusion_deep_fake_tpu_torch.inference import (
                prepare_frame)

            body = self._read_body()
            frame_bgr = _decode_bgr(body)
            rgb = prepare_frame(frame_bgr, engine.width, engine.height)
            fake_rgb = engine.swap(rgb,
                                   deadline_ms=self._remaining_deadline_ms())
            self._reply(200, _encode_jpeg(fake_rgb), "image/jpeg")

        def _swap_raw(self, engine: SwapEngine):
            fmt = self.headers.get("X-Format", "rgb").lower()
            if fmt not in ("rgb", "i420"):
                raise ValueError(f"bad X-Format {fmt!r} (rgb or i420)")
            shape_hdr = self.headers.get("X-Shape")
            if not shape_hdr:
                raise ValueError("missing X-Shape header (H,W,3 or N,H,W,3; "
                                 "H,W or N,H,W with X-Format: i420)")
            shape = tuple(int(s) for s in shape_hdr.split(","))
            if fmt == "rgb":
                if len(shape) not in (3, 4) or shape[-1] != 3:
                    raise ValueError(f"bad X-Shape {shape_hdr}")
                n, h, w = ((1,) + shape[:2] if len(shape) == 3
                           else shape[:3])
                body_shape = (n, h, w, 3)
            else:
                if len(shape) not in (2, 3):
                    raise ValueError(
                        f"bad X-Shape {shape_hdr} for i420 (H,W or N,H,W)")
                n, h, w = (1,) + shape if len(shape) == 2 else shape
                validate_i420_dims(h, w)
                body_shape = (n, h * 3 // 2, w)
            body = self._read_body()
            expected = int(np.prod(body_shape))
            if len(body) != expected:
                raise ValueError(
                    f"body has {len(body)} bytes, shape needs {expected}")
            frames = np.frombuffer(body, np.uint8).reshape(body_shape)
            fake = self._swap_in_format(engine, frames, fmt,
                                        self._remaining_deadline_ms())
            squeeze = len(shape) == (3 if fmt == "rgb" else 2)
            if squeeze:
                fake = fake[0]
            hdr_shape = ",".join(str(d) for d in
                                 ((fake.shape[:-2] + (h, w)) if fmt == "i420"
                                  else fake.shape))
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-Shape", hdr_shape)
            self.send_header("X-Format", fmt)
            self.send_header("Content-Length", str(fake.nbytes))
            self.end_headers()
            self.wfile.write(fake.tobytes())

        @staticmethod
        def _swap_in_format(engine: SwapEngine, frames: np.ndarray,
                            fmt: str,
                            deadline_ms: float | None = None) -> np.ndarray:
            """Swap a stack given in wire format ``fmt``; reply in ``fmt``.

            When the client's format is the engine's device wire format the
            frames pass straight through (no host conversion, half the bytes
            on both hops for i420); otherwise they are converted on this
            request thread.
            """
            if fmt == engine.transfer:
                return engine.swap_wire(frames, deadline_ms=deadline_ms)
            if fmt == "i420":  # i420 client, rgb engine
                fake = engine.swap(unpack_i420_batch_to_rgb_np(frames),
                                   deadline_ms=deadline_ms)
                return pack_rgb_batch_to_i420_np(fake)
            return engine.swap(frames,  # rgb client, i420 engine
                               deadline_ms=deadline_ms)

    return Handler


class _SwapHTTPServer(ThreadingHTTPServer):
    # stdlib default listen backlog is 5: a 64-client burst gets TCP
    # connection RESETS before admission control can even answer 503.
    # Deep backlog + reuse so
    # overload degrades into engine-level shedding, not kernel-level resets.
    request_queue_size = 128
    allow_reuse_address = True


class SwapServer:
    """Owns the engine(s) + ThreadingHTTPServer; context-manageable.

    Accepts one engine (single identity) or a dict {"a": ..., "b": ...};
    requests pick with ``?identity=`` (default: the first engine)."""

    def __init__(self, engine: SwapEngine | dict[str, SwapEngine], *,
                 host: str = "127.0.0.1", port: int = 8000):
        if isinstance(engine, SwapEngine):
            engine = {engine.identity: engine}
        self.engines = engine
        self.httpd = _SwapHTTPServer((host, port), _make_handler(engine))
        self.httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        """Serve on a background thread (tests / embedding)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.httpd.server_close()
        for engine in self.engines.values():
            engine.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


def run_server(checkpoint_path, identity: str, *, host: str = "0.0.0.0",
               port: int = 8000, height: int = 448, width: int = 448,
               batch_size: int = 8, use_ema: bool = False,
               sampler_steps: int = 0, max_wait_ms: float = 5.0,
               transfer: str = "rgb", devices: int = 1,
               max_queue_frames: int | None = None,
               request_deadline_ms: float | None = None,
               verbose: bool = True, check: bool = False,
               device=None) -> None:
    """Entry point: load, warm up, then serve until interrupted.

    ``identity="both"`` serves a AND b from the one checkpoint (two engines,
    two pipelines); clients pick with ``?identity=``. ``check=True`` stops
    after warmup: the deployment-validation mode — restore + build + one
    device round-trip per engine, print each engine's stats JSON, return.
    Nothing listens, so it is safe on a host where the real server (or
    another validation) is already running. The engines run on ``cuda``
    unless given ``device``, each with ``devices`` replicas (one a card,
    ``serving/engine.py``)."""
    identities = ["a", "b"] if identity == "both" else [identity]
    engines = {}
    for name in identities:
        engines[name] = SwapEngine(
            checkpoint_path, name, height=height, width=width,
            batch_size=batch_size, use_ema=use_ema,
            sampler_steps=sampler_steps, max_wait_ms=max_wait_ms,
            transfer=transfer, devices=devices,
            max_queue_frames=max_queue_frames,
            request_deadline_ms=request_deadline_ms, device=device)
        if verbose:
            print(f"warming up the swap pipeline for '{name}' "
                  f"({height}x{width}, "
                  f"batch {batch_size}) ...", flush=True)
        secs = engines[name].warmup()
        if verbose:
            print(f"  '{name}' ready in {secs:.1f}s", flush=True)
    if check:
        for name, eng in engines.items():
            print(json.dumps({"engine": name, "serve_check": "ok",
                              **eng.stats()}), flush=True)
            eng.close()
        return
    server = SwapServer(engines, host=host, port=port)
    if verbose:
        print(f"serving identit{'ies' if len(engines) > 1 else 'y'} "
              f"{sorted(engines)} on {host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
