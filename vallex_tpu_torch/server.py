"""HTTP serving with dynamic micro-batching (port of vallex_tpu/server.py).

Every AR decode step streams the whole weight set, so concurrent requests
should share it (engine/ar.py::ar_generate_batch runs R requests as the
rows of one batched decode). This module turns that into a deployable
surface:

- ``DynamicBatcher``: a queue + worker thread that coalesces requests
  arriving within a short window into ONE batched decode. Requests with
  identical sampling settings batch together; incompatible ones run in
  separate groups. If a batched call fails, each member is retried alone
  so one malformed request cannot poison its neighbours.
- A dependency-free ``http.server`` app:
    POST /synthesize   {"text": ..., "prompt": ..., ...} → WAV bytes
                       (or JSON with base64 audio when "format": "json")
    GET  /healthz      liveness + queue depth
    GET  /presets      bundled voice-prompt names

Start it with ``python -m vallex_tpu_torch.cli serve --port 8000`` or
``serve_forever()`` from Python after ``api.preload_models()``; the batcher
and the streaming route default to this package's ``api`` functions.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .utils.audio import pcm16, wav_bytes

log = logging.getLogger(__name__)


class Metrics:
    """Thread-safe monotonic counters + latency histograms rendered in the
    Prometheus text exposition format (GET /metrics). Deliberately
    dependency-free."""

    # seconds; roughly log-spaced around the measured serving latencies
    # (short sentence ~0.1 s … long-text streams tens of seconds)
    HIST_BUCKETS = (
        0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: Dict[str, float] = {}
        self._h: Dict[str, List[float]] = {}  # name → [bucket counts, sum, n]

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0.0) + value

    def get(self, name: str) -> float:
        with self._lock:
            return self._c.get(name, 0.0)

    def observe(self, name: str, value: float) -> None:
        """Record one histogram observation (request latency seconds)."""
        with self._lock:
            h = self._h.get(name)
            if h is None:
                h = [0.0] * (len(self.HIST_BUCKETS) + 1) + [0.0, 0.0]
                self._h[name] = h
            for i, b in enumerate(self.HIST_BUCKETS):
                if value <= b:
                    h[i] += 1
                    break
            else:
                h[len(self.HIST_BUCKETS)] += 1  # +Inf bucket
            h[-2] += value
            h[-1] += 1

    def quantile(self, name: str, q: float) -> Optional[float]:
        """Approximate quantile from the histogram (upper bucket bound;
        None when no observations). Used by /healthz and the soak test."""
        with self._lock:
            h = self._h.get(name)
            if h is None or h[-1] == 0:
                return None
            target = q * h[-1]
            acc = 0.0
            for i, b in enumerate(self.HIST_BUCKETS):
                acc += h[i]
                if acc >= target:
                    return b
            return float("inf")

    def render(self) -> str:
        with self._lock:
            items = sorted(self._c.items())
            hists = sorted(self._h.items())
        lines = [f"# TYPE {k} counter\n{k} {v:g}" for k, v in items]
        for k, h in hists:
            lines.append(f"# TYPE {k} histogram")
            acc = 0.0
            for i, b in enumerate(self.HIST_BUCKETS):
                acc += h[i]
                lines.append(f'{k}_bucket{{le="{b:g}"}} {acc:g}')
            acc += h[len(self.HIST_BUCKETS)]
            lines.append(f'{k}_bucket{{le="+Inf"}} {acc:g}')
            lines.append(f"{k}_sum {h[-2]:g}")
            lines.append(f"{k}_count {h[-1]:g}")
        return "\n".join(lines) + ("\n" if lines else "")


@dataclass
class SynthesisRequest:
    text: str
    prompt: Optional[str] = None
    language: str = "auto"
    accent: str = "no-accent"
    best_of: int = 1
    top_k: int = -100
    top_p: float = 1.0
    temperature: float = 1.0
    seed: int = 0

    def group_key(self) -> Tuple:
        """Requests batch together only when every knob the batched engine
        shares across the batch is identical (api.generate_audio_batch
        applies language/accent/best_of/sampling/seed batch-wide; texts
        and prompts are per-request). best_of in the key means two
        concurrent best_of=5 requests coalesce into ONE decode of 10
        samples (engine/ar.py::ar_generate_batch beams)."""
        return (
            self.language, self.accent, self.best_of, self.top_k,
            self.top_p, self.temperature, self.seed,
        )


class DynamicBatcher:
    """Coalesce concurrent synthesis requests into batched decodes.

    submit() returns a Future resolving to the waveform. A worker thread
    takes the oldest pending request, waits up to ``max_wait_ms`` for
    compatible companions (same group_key), caps the group at
    ``max_batch``, and runs one batched call. Under light load a lone
    request pays at most max_wait_ms of extra latency; under heavy load
    batches fill immediately and throughput follows the batch-serving
    curve instead of the single-stream one.
    """

    def __init__(
        self,
        batch_fn: Optional[Callable] = None,
        single_fn: Optional[Callable] = None,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 30.0,
        max_rows: int = 5,
        metrics: Optional[Metrics] = None,
    ):
        if batch_fn is None or single_fn is None:
            from . import api

            batch_fn = batch_fn or api.generate_audio_batch
            single_fn = single_fn or api.generate_audio
        self.batch_fn = batch_fn
        self.single_fn = single_fn
        self.metrics = metrics or Metrics()
        self.max_batch = int(max_batch)
        # best_of requests occupy best_of decode rows each; max_rows caps
        # the TOTAL rows of one best_of>1 batched call (single-sample
        # groups are exempt — they batch to max_batch). The default (5),
        # kept from the JAX package, sends best_of>=3 requests alone
        # through the single-request path.
        self.max_rows = int(max_rows)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._q: "queue.Queue[Tuple[SynthesisRequest, Future]]" = queue.Queue()
        self._deferred: List[Tuple[SynthesisRequest, Future]] = []
        self._stop = threading.Event()
        # serializes submit's check-then-put against shutdown's stop-set:
        # without it a put can land after the worker's final drain, leaving
        # that Future unresolved until the client's request timeout
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name="vallex-batcher", daemon=True
        )
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, req: SynthesisRequest) -> "Future[np.ndarray]":
        fut: "Future[np.ndarray]" = Future()
        t0 = time.monotonic()
        fut.add_done_callback(
            lambda f: self.metrics.observe(
                "vallex_request_latency_seconds", time.monotonic() - t0
            )
        )
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher is shut down")
            self._q.put((req, fut))
        return fut

    def queue_depth(self) -> int:
        return self._q.qsize() + len(self._deferred)

    def shutdown(self, timeout: float = 10.0) -> None:
        with self._submit_lock:
            self._stop.set()
            self._q.put(None)  # wake the worker
        self._worker.join(timeout)

    # -- worker side ---------------------------------------------------------

    def _take(self, block: bool, deadline: Optional[float]):
        """Next (req, fut) from deferred-first order, or None."""
        if self._deferred:
            return self._deferred.pop(0)
        try:
            timeout = None
            if deadline is not None:
                timeout = max(0.0, deadline - time.monotonic())
            item = self._q.get(block=block, timeout=timeout)
        except queue.Empty:
            return None
        return item

    def _group_cap(self, best_of: int) -> int:
        """Requests per batched call: max_batch for best_of=1; under
        best_of each request brings best_of decode rows, so the cap shrinks
        to keep total rows within max_rows (a best_of > max_rows request
        simply runs alone through the single path)."""
        if best_of <= 1:
            return self.max_batch
        return min(self.max_batch, max(1, self.max_rows // best_of))

    def _collect_group(self, first) -> List[Tuple[SynthesisRequest, Future]]:
        group = [first]
        key = first[0].group_key()
        cap = self._group_cap(first[0].best_of)
        incompatible: List[Tuple[SynthesisRequest, Future]] = []
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < cap:
            item = self._take(block=True, deadline=deadline)
            if item is None:
                break
            req, fut = item
            if req.group_key() == key:
                group.append(item)
            else:
                # keep arrival order within the incompatible stream
                incompatible.append(item)
        self._deferred = incompatible + self._deferred
        return group

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._take(block=True, deadline=None)
            if item is None:
                continue
            if self._stop.is_set():
                # hold the just-dequeued request for the drain below —
                # dropping it would leave its Future unresolved forever
                self._deferred.insert(0, item)
                break
            group = self._collect_group(item)
            self._execute(group)
        # drain: fail whatever is left so clients don't hang
        leftovers = list(self._deferred)
        self._deferred = []
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                leftovers.append(it)
        for _, fut in leftovers:
            fut.set_exception(RuntimeError("server shutting down"))

    def _pad_size(self, n: int, best_of: int = 1) -> int:
        """Pad a request group to the next power-of-2 batch size (capped
        at the group cap for its best_of), as the JAX package does, so the
        set of batch shapes the decode sees stays {2, 4, ..., max_batch}.
        Padding costs only the extra rows' cache reads — the weight stream
        (the dominant term) is shared either way. Greedy outputs are
        unchanged (each row's products and attention do not depend on its
        companions); sampled draws depend on batch shape, so they are
        distributionally equivalent rather than bit-stable."""
        b = 1
        while b < n:
            b *= 2
        return max(n, min(b, self._group_cap(best_of)))

    def _execute(self, group) -> None:
        reqs = [r for r, _ in group]
        futs = [f for _, f in group]
        r0 = reqs[0]
        m = self.metrics
        m.inc("vallex_decode_calls_total")
        m.inc("vallex_decode_requests_total", len(reqs))
        if len(reqs) > 1:
            m.inc("vallex_batched_calls_total")
        t0 = time.monotonic()
        try:
            if len(reqs) == 1:
                waves = [
                    self.single_fn(
                        r0.text, prompt=r0.prompt, language=r0.language,
                        accent=r0.accent, best_of=r0.best_of,
                        top_k=r0.top_k, top_p=r0.top_p,
                        temperature=r0.temperature, seed=r0.seed,
                    )
                ]
            else:
                padded = reqs + [reqs[-1]] * (
                    self._pad_size(len(reqs), r0.best_of) - len(reqs)
                )
                m.inc("vallex_pad_requests_total", len(padded) - len(reqs))
                waves = self.batch_fn(
                    [r.text for r in padded],
                    [r.prompt for r in padded],
                    language=r0.language, accent=r0.accent,
                    best_of=r0.best_of,
                    top_k=r0.top_k, top_p=r0.top_p,
                    temperature=r0.temperature, seed=r0.seed,
                )[: len(reqs)]
            m.inc("vallex_synth_seconds_total", time.monotonic() - t0)
            m.inc(
                "vallex_audio_seconds_total",
                sum(len(w) for w in waves) / 24000.0,
            )
            for fut, w in zip(futs, waves):
                fut.set_result(w)
        except Exception as batch_err:  # noqa: BLE001
            if len(reqs) == 1:
                m.inc("vallex_synth_errors_total")
                futs[0].set_exception(batch_err)
                return
            # one bad request must not poison the batch: retry singly
            log.warning(
                "batched synthesis failed (%s); retrying %d requests singly",
                batch_err, len(reqs),
            )
            m.inc("vallex_batch_retries_total")
            for r, fut in zip(reqs, futs):
                try:
                    wave = self.single_fn(
                        r.text, prompt=r.prompt, language=r.language,
                        accent=r.accent, best_of=r.best_of,
                        top_k=r.top_k, top_p=r.top_p,
                        temperature=r.temperature, seed=r.seed,
                    )
                    m.inc(
                        "vallex_audio_seconds_total", len(wave) / 24000.0
                    )
                    fut.set_result(wave)
                except Exception as e:  # noqa: BLE001
                    m.inc("vallex_synth_errors_total")
                    fut.set_exception(e)
            m.inc("vallex_synth_seconds_total", time.monotonic() - t0)


# ---------------------------------------------------------------------------
# HTTP layer (stdlib only)
# ---------------------------------------------------------------------------

_MAX_BODY = 1 << 20  # 1 MiB of JSON is far beyond any sane request
_MAX_TEXT = 20_000


def _parse_body(body: bytes) -> Dict[str, Any]:
    """Parse + shape-check the JSON body (shared by both POST routes).
    Raises ValueError (→ 400) for everything malformed, including
    wrongly-typed fields — int(None)/float([]) raise TypeError, which
    must not escape as a connection-killing handler crash."""
    try:
        data = json.loads(body)
    except json.JSONDecodeError as e:
        raise ValueError(f"invalid JSON: {e}") from e
    if not isinstance(data, dict) or "text" not in data:
        raise ValueError('body must be a JSON object with a "text" field')
    text = data["text"]
    if not isinstance(text, str) or not text.strip():
        raise ValueError('"text" must be a non-empty string')
    if len(text) > _MAX_TEXT:
        raise ValueError(f'"text" exceeds {_MAX_TEXT} characters')
    return data


def _field(data: Dict[str, Any], key: str, conv, default):
    try:
        return conv(data.get(key, default))
    except (TypeError, ValueError) as e:
        raise ValueError(f'"{key}" must be a {conv.__name__}: {e}') from e


_MAX_BEST_OF = 16  # decode rows per request; UI signature mode is 5


def _request_from(data: Dict[str, Any]) -> SynthesisRequest:
    best_of = _field(data, "best_of", int, 1)
    if not 1 <= best_of <= _MAX_BEST_OF:
        raise ValueError(f'"best_of" must be in [1, {_MAX_BEST_OF}]')
    return SynthesisRequest(
        text=data["text"],
        prompt=data.get("prompt"),
        language=str(data.get("language", "auto")),
        accent=str(data.get("accent", "no-accent")),
        best_of=best_of,
        top_k=_field(data, "top_k", int, -100),
        top_p=_field(data, "top_p", float, 1.0),
        temperature=_field(data, "temperature", float, 1.0),
        seed=_field(data, "seed", int, 0),
    )


def _parse_request(body: bytes) -> SynthesisRequest:
    return _request_from(_parse_body(body))


def make_server(
    host: str = "127.0.0.1",
    port: int = 8000,
    *,
    batcher: Optional[DynamicBatcher] = None,
    request_timeout_s: float = 300.0,
    stream_fn: Optional[Callable] = None,
    max_streams: int = 2,
):
    """Build (but do not start) the HTTP server. Call .serve_forever() on
    the result; .shutdown() stops it. The batcher/stream_fn default to the
    public api functions — call api.preload_models() first. max_streams
    caps concurrent /synthesize-long streams (each bypasses the batcher
    and drives the device directly; excess requests get a 503)."""
    import http.server
    import socketserver

    b = batcher or DynamicBatcher()
    if stream_fn is None:
        from . import api

        stream_fn = api.stream_audio_from_long_text
    stream_slots = threading.BoundedSemaphore(max_streams)

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # a client that sends fewer body bytes than its Content-Length
        # must not pin a handler thread forever (slowloris)
        timeout = 60

        def log_message(self, fmt, *args):  # route through logging
            log.info("%s - %s", self.address_string(), fmt % args)

        def _send(self, code: int, ctype: str, payload: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _read_body(self) -> Optional[bytes]:
            """Read the request body, or send a 400 and return None. A
            rejected oversized/absent Content-Length also closes the
            connection — the unread body bytes would otherwise be parsed
            as the next request line on this keep-alive connection."""
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = 0
            if n <= 0 or n > _MAX_BODY:
                self.close_connection = True
                self._send_json(400, {"error": "bad Content-Length"})
                return None
            return self.rfile.read(n)

        def _send_json(self, code: int, obj: Dict[str, Any]) -> None:
            self._send(
                code, "application/json",
                json.dumps(obj).encode("utf-8"),
            )

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send_json(
                    200, {"status": "ok", "queue_depth": b.queue_depth()}
                )
            elif self.path == "/metrics":
                self._send(
                    200, "text/plain; version=0.0.4",
                    b.metrics.render().encode("utf-8"),
                )
            elif self.path == "/presets":
                import os

                from .api import PROMPT_SEARCH_DIRS

                names = sorted({
                    f[:-4]
                    for d in PROMPT_SEARCH_DIRS if os.path.isdir(d)
                    for f in os.listdir(d) if f.endswith(".npz")
                })
                self._send_json(200, {"presets": names})
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802 (stdlib API)
            if self.path == "/synthesize-long":
                self._synthesize_long()
                return
            if self.path != "/synthesize":
                self._send_json(404, {"error": "not found"})
                return
            b.metrics.inc("vallex_http_synthesize_total")
            body = self._read_body()
            if body is None:
                return
            try:
                data = _parse_body(body)
                req = _request_from(data)
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            as_json = data.get("format") == "json"
            try:
                wav = b.submit(req).result(timeout=request_timeout_s)
            except TimeoutError:
                self._send_json(504, {"error": "synthesis timed out"})
                return
            except Exception as e:  # noqa: BLE001 (surface as 500)
                self._send_json(500, {"error": str(e)})
                return
            payload = wav_bytes(np.asarray(wav))
            if as_json:
                self._send_json(200, {
                    "sample_rate": 24000,
                    "duration_s": round(len(wav) / 24000.0, 3),
                    "wav_base64": base64.b64encode(payload).decode("ascii"),
                })
            else:
                self._send(200, "audio/wav", payload)

        def _synthesize_long(self) -> None:
            """Long-text synthesis streamed as chunked raw PCM
            (s16le mono, Content-Type audio/L16;rate=24000): the first
            audio chunk arrives after ONE sentence instead of the whole
            paragraph. Body: {"text", "prompt"?, "language"?, "accent"?,
            "mode"?, "seed"?}. Concurrency is capped at max_streams —
            each stream bypasses the batcher and drives the device
            directly, so unbounded handler threads would contend the
            decode (503 when full)."""
            body = self._read_body()
            if body is None:
                return
            try:
                data = _parse_body(body)
                kwargs = dict(
                    prompt=data.get("prompt"),
                    language=str(data.get("language", "auto")),
                    accent=str(data.get("accent", "no-accent")),
                    mode=str(data.get("mode", "sliding-window")),
                    seed=_field(data, "seed", int, 0),
                )
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            b.metrics.inc("vallex_http_synthesize_long_total")
            if not stream_slots.acquire(blocking=False):
                b.metrics.inc("vallex_stream_rejects_total")
                self._send_json(
                    503, {"error": f"at capacity ({max_streams} streams)"}
                )
                return
            stream = None
            try:
                stream = stream_fn(data["text"], **kwargs)
                try:
                    first = next(stream)  # synthesize before committing 200
                except StopIteration:
                    self._send_json(400, {"error": "no sentences in text"})
                    return
                except Exception as e:  # noqa: BLE001 (surface as 500)
                    self._send_json(500, {"error": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/L16;rate=24000")
                self.send_header("X-Sample-Rate", "24000")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(wav: np.ndarray) -> None:
                    raw = pcm16(wav)
                    self.wfile.write(f"{len(raw):X}\r\n".encode())
                    self.wfile.write(raw)
                    self.wfile.write(b"\r\n")

                try:
                    chunk(first)
                    for wav in stream:
                        chunk(wav)
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
                    log.info("client disconnected mid-stream")
                except Exception:  # noqa: BLE001
                    # mid-stream synthesis failure after the 200: nothing
                    # valid can follow — drop the connection (no 0-chunk
                    # terminator) so the client sees a truncated stream
                    # rather than a clean end, and keep the handler alive
                    self.close_connection = True
                    log.exception("mid-stream synthesis failure")
            finally:
                # a client gone mid-stream: closing the generator ends its
                # sentence loop (and the loop's worker thread)
                getattr(stream, "close", lambda: None)()
                stream_slots.release()

    class Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
        daemon_threads = True
        allow_reuse_address = True

    srv = Server((host, port), Handler)
    srv.batcher = b  # type: ignore[attr-defined]
    return srv


def warmup(max_batch: int, prompt: Optional[str] = "paimon") -> None:
    """Run every serving shape once BEFORE accepting traffic: the
    single-request path plus every batch shape the DynamicBatcher can
    produce (groups pad to powers of 2 capped at max_batch, so that set
    is {2, 4, …, max_batch}). The first call also builds the CUDA kernels
    and allocates the decode weights, which then stay out of the first
    requests' latency."""
    from . import api

    sizes = [1]
    b = 2
    while b < max_batch:
        sizes.append(b)
        b *= 2
    if max_batch > 1:
        sizes.append(max_batch)
    t0 = time.monotonic()
    log.info("warmup: running the serving shapes (batch shapes %s)", sizes)
    text = "Server warm up sentence, medium length for the usual bucket."
    for n in sizes:
        if n == 1:
            api.generate_audio(text, prompt=prompt, top_k=1, seed=0)
        else:
            api.generate_audio_batch(
                [text] * n, [prompt] * n, top_k=1, seed=0
            )
    log.info("warmup done in %.1f s", time.monotonic() - t0)


def serve_forever(
    host: str = "127.0.0.1",
    port: int = 8000,
    *,
    max_batch: int = 8,
    max_wait_ms: float = 30.0,
    max_rows: int = 5,
) -> None:
    """Blocking entry point; call api.preload_models() first."""
    import signal

    b = DynamicBatcher(
        max_batch=max_batch, max_wait_ms=max_wait_ms, max_rows=max_rows
    )
    srv = make_server(host, port, batcher=b)

    def _graceful(signum, frame):  # noqa: ARG001 (signal API)
        log.info("signal %d: shutting down", signum)
        # srv.shutdown() blocks until serve_forever's loop exits, so it
        # must run off the loop's own thread
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    log.info("serving on http://%s:%d (max_batch=%d, max_wait=%.0f ms)",
             host, port, max_batch, max_wait_ms)
    try:
        srv.serve_forever()
    finally:
        b.shutdown()
