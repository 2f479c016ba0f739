"""Dynamic-batching TTS serving daemon.

Counterpart of ``isp_tts_tpu/serving_server.py``: an HTTP front door over
:class:`~isp_tts_tpu_torch.serving.Synthesizer` whose concurrent requests a
background batcher coalesces into one bucketed device call per window, so
independent clients share one batched call on the card. Standard library
only: ``http.server``, ``threading`` and ``wave``.

API
---
``POST /synthesize`` with JSON ``{"text": str, "seed": int,
"duration_factor": f, "pitch_factor": f, "pitch_delta": f,
"energy_factor": f, "energy_delta": f, "speaker": int,
"format": "wav" | "mel" | "pcm"}`` returns ``audio/wav`` (16-bit PCM), an
``.npy`` mel, or raw ``audio/L16`` PCM. One utterance per request: batching
happens across requests, not within one. ``POST /synthesize_long`` streams
a whole document as chunked raw PCM: the first sentence synthesizes alone
(time to first audio is one sentence's latency), the rest coalesce into
batched calls while the head chunk is already playing. ``GET /healthz``
liveness and stats; ``GET /stats`` the batching counters.

Requests inside one batching window are grouped by their control tuple
(seed and factors are batch-wide scalars of a synthesis call); each group
becomes one device call. A fixed ``seed`` pins the noise for a fixed batch
shape only: what shares a window changes a request's buckets and row.

``--artifact`` serves from an exported audio artifact
(:mod:`isp_tts_tpu_torch.export`) through :class:`ArtifactServing`, with no
model code; coalescing stops at the artifact's one batch shape.
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
import wave
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

logger = logging.getLogger("isp_tts_tpu_torch")


class OverloadedError(RuntimeError):
    """Request queue is full — mapped to HTTP 503."""


@dataclass
class ServerConfig:
    #: largest coalesced batch per device call (independent of the
    #: synthesizer's batch buckets — those round the final shape)
    max_batch: int = 32
    #: how long the batcher waits for more requests after the first one
    #: arrives — but ONLY when there is evidence of concurrency (peers
    #: already queued, or the previous window coalesced >1). A lone request
    #: on an idle daemon dispatches immediately and never pays this.
    max_wait_ms: float = 5.0
    #: "wav" (16-bit PCM via the neural vocoder / Griffin-Lim) or "mel"
    default_format: str = "wav"
    #: per-request wall-clock budget; it must cover a bucket's first call
    #: when the daemon runs without --warmup
    request_timeout_s: float = 600.0
    #: backpressure: requests beyond this queue depth are rejected with
    #: HTTP 503 instead of growing memory without bound
    max_queue: int = 256


@dataclass
class _Pending:
    text: str
    #: (seed, duration_factor, pitch_factor, pitch_delta, energy_factor,
    #:  energy_delta, speaker, fmt) — one device call per distinct tuple.
    #: fmt is part of the key: the wav path keeps the mel on the device
    #: between the acoustic model and the vocoder, so a mixed wav + mel
    #: group would cost the common all-wav case a host round trip.
    controls: tuple
    done: threading.Event = field(default_factory=threading.Event)
    result: bytes | None = None
    content_type: str = "application/octet-stream"
    error: str | None = None
    #: HTTP status for ``error`` (ValueError -> 400 client error, else 500)
    error_code: int = 500


def encode_pcm(audio: np.ndarray) -> bytes:
    """float32 [-1, 1] -> raw 16-bit little-endian PCM bytes."""
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def encode_wav(audio: np.ndarray, sample_rate: int) -> bytes:
    """float32 [-1, 1] -> 16-bit PCM WAV bytes (stdlib only)."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(encode_pcm(audio))
    return buf.getvalue()


def encode_npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


class TTSServer:
    """HTTP serving daemon with request coalescing.

    >>> server = TTSServer(synthesizer, port=0)   # 0 = ephemeral
    >>> server.start()                            # returns the bound port
    >>> ...                                       # POST /synthesize
    >>> server.stop()
    """

    def __init__(self, synthesizer, host: str = "127.0.0.1", port: int = 8080,
                 config: ServerConfig | None = None):
        self.synthesizer = synthesizer
        self.config = config or ServerConfig()
        self._host, self._port = host, port
        self._queue: queue.Queue = queue.Queue()
        #: finished device outputs awaiting host-side encoding: an encoder
        #: thread drains this so batch N's wav/npy encoding overlaps batch
        #: N+1's device call instead of serialising behind it
        self._encode_queue: queue.Queue = queue.Queue()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "max_coalesced": 0, "rejected": 0}
        self._httpd: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []
        self._stopping = False
        self._sample_rate = synthesizer.sample_rate

    # -- lifecycle -----------------------------------------------------------

    def start(self, warmup=None) -> int:
        """Bind, spawn the batcher + HTTP threads, return the bound port.

        ``warmup`` (a callable, e.g. the Synthesizer's ``warmup``) runs first
        on the batcher thread, the thread that serves every request, so the
        first request pays none of that thread's first-call costs; the HTTP
        thread starts accepting only after it returned. If it raises, the
        server stops and the error propagates."""
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self._host, self._port), handler)
        self._port = self._httpd.server_address[1]
        self._stopping = False
        ready = threading.Event()
        failure: list[BaseException] = []
        batcher = threading.Thread(target=self._batch_loop, args=(warmup, ready, failure),
                                   name="tts-batcher", daemon=True)
        encoder = threading.Thread(target=self._encode_loop,
                                   name="tts-encoder", daemon=True)
        serving = threading.Thread(target=self._httpd.serve_forever,
                                   name="tts-http", daemon=True)
        self._threads = [batcher, encoder, serving]
        batcher.start()
        encoder.start()
        ready.wait()
        if failure:
            self._threads = [batcher, encoder]
            self._httpd.server_close()  # never served: shutdown() would wait on it
            self._httpd = None
            self.stop()
            raise failure[0]
        serving.start()
        logger.info("TTS server on %s:%d (max_batch=%d, window=%.1fms)",
                    self._host, self._port, self.config.max_batch,
                    self.config.max_wait_ms)
        return self._port

    def stop(self) -> None:
        self._stopping = True
        self._queue.put(None)  # wake the batcher
        batcher = next((t for t in self._threads
                        if t.name == "tts-batcher"), None)
        if batcher is not None:
            batcher.join(timeout=30)
        self._encode_queue.put(None)  # drain + stop the encoder
        encoder = next((t for t in self._threads
                        if t.name == "tts-encoder"), None)
        if encoder is not None:
            encoder.join(timeout=30)
        # a batcher stuck past its join timeout (a long first call) can
        # still enqueue an encode job AFTER the encoder exited — fail any
        # such orphans so their handler threads don't sit out the timeout
        while True:
            try:
                job = self._encode_queue.get_nowait()
            except queue.Empty:
                break
            if job is None:
                continue
            for r in job[0]:
                if not r.done.is_set():
                    r.error = "server shutting down"
                    r.done.set()
        # fail anything still queued so blocked handler threads respond
        # promptly instead of sitting out the full request timeout
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = "server shutting down"
                req.done.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []

    @property
    def port(self) -> int:
        return self._port

    # -- request intake (called from HTTP handler threads) --------------------

    def enqueue(self, text: str, seed: int = 0, duration_factor: float = 1.0,
                pitch_factor: float = 1.0, pitch_delta: float = 0.0,
                energy_factor: float = 1.0, energy_delta: float = 0.0,
                speaker: int | None = None,
                fmt: str | None = None) -> _Pending:
        """Queue a request WITHOUT waiting (used by the streaming endpoint
        to let several sentences share one batching window); wait on
        ``req.done`` yourself."""
        fmt = fmt or self.config.default_format
        if fmt not in ("wav", "mel", "pcm"):
            raise ValueError(f"unknown format {fmt!r} (wav|mel|pcm)")
        req = _Pending(text=text, controls=(
            int(seed), float(duration_factor), float(pitch_factor),
            float(pitch_delta), float(energy_factor), float(energy_delta),
            None if speaker is None else int(speaker), fmt))
        # check + put under one lock: concurrent handler threads must not
        # all pass a bare qsize() check and overshoot the cap
        with self._stats_lock:
            if self._queue.qsize() >= self.config.max_queue:
                self.stats["rejected"] += 1
                raise OverloadedError(
                    f"queue depth {self.config.max_queue} reached — "
                    "retry later")
            self.stats["requests"] += 1
            self._queue.put(req)
        return req

    def submit(self, text: str, timeout: float | None = None,
               **controls) -> _Pending:
        timeout = self.config.request_timeout_s if timeout is None else timeout
        req = self.enqueue(text, **controls)
        if not req.done.wait(timeout):
            req.error = "synthesis timed out"
        return req

    # -- the batcher -----------------------------------------------------------

    def _batch_loop(self, warmup=None, ready: threading.Event | None = None,
                    failure: list | None = None) -> None:
        import time

        if warmup is not None:
            try:
                warmup()
            except BaseException as e:  # noqa: BLE001 - re-raised by start()
                failure.append(e)
        if ready is not None:
            ready.set()
        if failure:
            return
        last_window = 0
        while not self._stopping:
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if first is None:
                continue
            window = [first]
            stop = False
            # drain requests that are ALREADY queued — costs no latency
            while len(window) < self.config.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                window.append(nxt)
            # open the max_wait_ms batching window only on evidence of
            # concurrency (peers already queued, or the previous window
            # coalesced >1): a lone request on an idle daemon dispatches
            # immediately instead of paying the window as pure latency.
            # Under load the window re-engages, and usually the drain above
            # already collects everything that queued during the previous
            # device call.
            if not stop and len(window) < self.config.max_batch and (
                    len(window) > 1 or last_window > 1):
                deadline = time.monotonic() + self.config.max_wait_ms / 1e3
                while len(window) < self.config.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is None:
                        break
                    window.append(nxt)
            last_window = len(window)
            # one device call per distinct control tuple in the window
            groups: dict[tuple, list[_Pending]] = {}
            for r in window:
                groups.setdefault(r.controls, []).append(r)
            for controls, reqs in groups.items():
                self._run_group(controls, reqs)

    def _run_group(self, controls: tuple, reqs: list[_Pending],
                   _retry: bool = False) -> None:
        seed, df, pf, pd, ef, ed, speaker, fmt = controls
        texts = [r.text for r in reqs]
        kwargs = dict(seed=seed, duration_factor=df, pitch_factor=pf,
                      pitch_delta=pd, energy_factor=ef, energy_delta=ed,
                      speaker=speaker)
        try:
            if fmt in ("wav", "pcm"):
                outs = self.synthesizer.synthesize_audio(texts, **kwargs)
            else:
                outs = self.synthesizer(texts, **kwargs)
            if not _retry:  # a retried single is still the ORIGINAL window
                with self._stats_lock:
                    self.stats["batches"] += 1
                    self.stats["max_coalesced"] = max(
                        self.stats["max_coalesced"], len(reqs))
            # hand host-side encoding to the encoder thread: the batcher is
            # free to dispatch the NEXT window's device call immediately.
            # During shutdown the encoder may already be gone — fail the
            # requests directly rather than orphaning them on the queue.
            if self._stopping:
                for r in reqs:
                    if not r.done.is_set():
                        r.error = "server shutting down"
                        r.done.set()
            else:
                self._encode_queue.put((reqs, outs, fmt))
        except ValueError as e:
            # a bad INPUT (e.g. text over the largest bucket): isolate the
            # poison request by retrying each alone so only the offender
            # errors. Deliberately narrow — retrying a transient device
            # error would amplify it into N sequential single-row calls.
            if len(reqs) > 1:
                logger.warning("batch of %d failed on a bad input (%s); "
                               "retrying individually", len(reqs), e)
                for r in reqs:
                    self._run_group(controls, [r], _retry=True)
            else:
                self._fail(reqs[0], e, code=400)
        except Exception as e:  # noqa: BLE001 — served as HTTP error, not crash
            logger.exception("batch of %d failed", len(reqs))
            for r in reqs:
                self._fail(r, e, code=500)

    def _encode_loop(self) -> None:
        """Encoder thread: host-side wav/pcm/npy encoding of finished device
        outputs, overlapped with the batcher's next device call."""
        while True:
            job = self._encode_queue.get()
            if job is None:
                return
            reqs, outs, fmt = job
            try:
                if fmt == "wav":
                    payloads = [encode_wav(o, self._sample_rate) for o in outs]
                    ctype = "audio/wav"
                elif fmt == "pcm":
                    payloads = [encode_pcm(o) for o in outs]
                    ctype = f"audio/L16; rate={self._sample_rate}; channels=1"
                else:
                    payloads = [encode_npy(o) for o in outs]
                    ctype = "application/x-npy"
                for r, p in zip(reqs, payloads):
                    r.result, r.content_type = p, ctype
                    r.done.set()
            except Exception as e:  # noqa: BLE001
                logger.exception("encoding a batch of %d failed", len(reqs))
                for r in reqs:
                    if not r.done.is_set():
                        self._fail(r, e, code=500)

    def _fail(self, r: _Pending, e: Exception, code: int) -> None:
        with self._stats_lock:
            self.stats["errors"] += 1
        r.error = f"{type(e).__name__}: {e}"
        r.error_code = code
        r.done.set()


class ArtifactServing:
    """The daemon's synthesizer interface over an exported artifact
    (:class:`~isp_tts_tpu_torch.export.ExportedSynthesizer`): a deployment
    host needs the artifact and torch, nothing else. Only audio artifacts
    (exported with a vocoder) serve the wav and pcm formats; a mel request
    raises."""

    def __init__(self, exported):
        if exported.meta["output"] != "audio":
            raise ValueError("daemon artifact serving needs an audio artifact (export "
                             f"with --vocoder); this one outputs {exported.meta['output']!r}")
        self.exported = exported

    @property
    def max_batch(self) -> int:
        return int(self.exported.meta["batch"])

    @property
    def sample_rate(self) -> int:
        return int(self.exported.meta["sample_rate"])

    def synthesize_audio(self, texts, **controls):
        return self.exported(texts, **controls)

    def __call__(self, texts, **controls):
        raise ValueError("mel format is unavailable when serving from an audio artifact")


def _make_handler(server: TTSServer):
    class Handler(BaseHTTPRequestHandler):
        # route logging through the framework logger, not stderr
        def log_message(self, fmt, *args):  # noqa: A003
            logger.debug("http: " + fmt, *args)

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path in ("/healthz", "/stats"):
                with server._stats_lock:
                    stats = dict(server.stats)
                self._json(200, {"ok": True, "stats": stats})
            else:
                self._json(404, {"ok": False, "error": "not found"})

        def _parse(self):
            """Read + validate the JSON body; returns (text, controls)."""
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            text = payload["text"]
            if not isinstance(text, str) or not text.strip():
                # one utterance per request — batching happens ACROSS
                # requests (the coalescing window), not within one
                raise ValueError("'text' must be a non-empty string "
                                 "(one utterance per request)")
            speaker = payload.get("speaker")
            controls = dict(
                seed=payload.get("seed", 0),
                duration_factor=payload.get("duration_factor", 1.0),
                pitch_factor=payload.get("pitch_factor", 1.0),
                pitch_delta=payload.get("pitch_delta", 0.0),
                energy_factor=payload.get("energy_factor", 1.0),
                energy_delta=payload.get("energy_delta", 0.0),
                speaker=None if speaker is None else int(speaker),
            )
            return payload, text, controls

        def do_POST(self):  # noqa: N802
            if self.path == "/synthesize":
                self._synthesize()
            elif self.path == "/synthesize_long":
                self._synthesize_long()
            else:
                self._json(404, {"ok": False, "error": "not found"})

        def _synthesize(self):
            try:
                payload, text, controls = self._parse()
                req = server.submit(text, fmt=payload.get("format"),
                                    **controls)
            except OverloadedError as e:
                self._json(503, {"ok": False, "error": str(e)})
                return
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._json(400, {"ok": False, "error": str(e)})
                return
            if req.error is not None:
                self._json(req.error_code, {"ok": False, "error": req.error})
                return
            self.send_response(200)
            self.send_header("Content-Type", req.content_type)
            self.send_header("Content-Length", str(len(req.result)))
            self.end_headers()
            self.wfile.write(req.result)

        def _synthesize_long(self):
            """Streaming long-form synthesis: chunked raw-PCM response.

            The first sentence is synthesized ALONE (time-to-first-audio is
            one sentence's latency, not the document's), then streamed while
            the remaining sentences are enqueued together so they coalesce
            into one batched device call. ``pause_s`` of silence separates
            sentences, like Synthesizer.synthesize_long."""
            from .serving import split_sentences

            try:
                payload, text, controls = self._parse()
                parts = split_sentences(text)
                if not parts:
                    raise ValueError("no sentences found")
                pause_s = float(payload.get("pause_s", 0.25))
                head = server.submit(parts[0], fmt="pcm", **controls)
            except OverloadedError as e:
                self._json(503, {"ok": False, "error": str(e)})
                return
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._json(400, {"ok": False, "error": str(e)})
                return
            if head.error is not None:
                self._json(head.error_code, {"ok": False, "error": head.error})
                return
            sr = server._sample_rate
            self.send_response(200)
            self.send_header("Content-Type",
                             f"audio/L16; rate={sr}; channels=1")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes) -> None:
                if data:
                    self.wfile.write(f"{len(data):x}\r\n".encode()
                                     + data + b"\r\n")

            pause = b"\x00\x00" * int(pause_s * sr)
            chunk(head.result)
            # enqueue the tail in bounded waves of max_batch: each wave
            # coalesces into one device call, and a long document can never
            # blow past the backpressure cap (which would orphan accepted
            # requests the client will never read)
            deadline = server.config.request_timeout_s
            truncated = False
            for start in range(1, len(parts), server.config.max_batch):
                reqs = []
                for p in parts[start:start + server.config.max_batch]:
                    try:
                        reqs.append(server.enqueue(p, fmt="pcm", **controls))
                    except OverloadedError as e:
                        logger.error("stream backpressure: %s", e)
                        truncated = True
                        break
                for r in reqs:
                    ok = r.done.wait(deadline)
                    if not ok or r.error is not None:
                        # headers are already out — end the stream early;
                        # the truncation is the client-visible error signal
                        logger.error("streaming sentence failed: %s",
                                     r.error or "timeout")
                        truncated = True
                        break
                    chunk(pause)
                    chunk(r.result)
                if truncated:
                    break
            self.wfile.write(b"0\r\n\r\n")

    return Handler


def main(argv=None) -> None:
    """``python -m isp_tts_tpu_torch.serving_server --checkpoint ckpt [--vocoder v]``"""
    import argparse

    p = argparse.ArgumentParser(description="isp_tts_tpu_torch serving daemon")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--artifact", default=None,
                   help="serve from an exported audio artifact (isp_tts_tpu_torch.export) "
                        "instead of a checkpoint: no model code needed")
    p.add_argument("--vocoder", default=None, help="optional VocoderModel checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket once before accepting traffic")
    p.add_argument("--device", default="cuda",
                   help="device to serve on (default: cuda; there is no fallback)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if (args.checkpoint is None) == (args.artifact is None):
        p.error("exactly one of --checkpoint / --artifact is required")
    max_batch, warmup = args.max_batch, None
    if args.artifact is not None:
        from .export import ExportedSynthesizer

        synth = ArtifactServing(ExportedSynthesizer(args.artifact, device=args.device))
        # the artifact has one batch shape: don't coalesce past it
        max_batch = min(max_batch, synth.max_batch)
        if args.warmup:
            warmup = lambda: synth.synthesize_audio(["warm up."])  # noqa: E731
    else:
        from .serving import Synthesizer, SynthesizerConfig

        synth = Synthesizer.from_pretrained(args.checkpoint,
                                            SynthesizerConfig(steps=args.steps),
                                            vocoder_path=args.vocoder, device=args.device)
        if args.warmup:
            warmup = lambda: synth.warmup(batch_sizes=(1, max_batch))  # noqa: E731
    server = TTSServer(synth, host=args.host, port=args.port,
                       config=ServerConfig(max_batch=max_batch,
                                           max_wait_ms=args.max_wait_ms))
    port = server.start(warmup=warmup)
    logger.info("serving on http://%s:%d: POST /synthesize", args.host, port)
    try:
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
