"""The port's serving daemon (stdlib HTTP client, a tiny random port model
on the CPU): the cases of the JAX package's ``tests/test_serving_server.py``
but the mesh and artifact ones. Behaviour as there: coalescing windows, one
device call per control tuple, the encoder thread, poison-request
isolation, 503 backpressure and streamed ``/synthesize_long`` PCM; the wav
and pcm formats run the Synthesizer's Griffin-Lim (no vocoder attached)."""

import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.data.text.table import CodingTable
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from isp_tts_tpu_torch.serving import Synthesizer, SynthesizerConfig
from isp_tts_tpu_torch.serving_server import ServerConfig, TTSServer, encode_wav

from test_serving import TINY

CHARSET = ["<pad>", "</s>", "#punct", "#en"]


def plain_attention(cfg):
    """``cfg`` with ``flash: off`` in every attention layer: the JAX tests'
    head dim 8 runs on the plain version (the kernels take 64)."""
    if isinstance(cfg, dict):
        out = {k: plain_attention(v) for k, v in cfg.items()}
        if "heads" in out and "head_dim" in out:
            out["flash"] = "off"
        return out
    return cfg


@pytest.fixture(scope="module")
def server():
    ct = CodingTable.from_charset(CHARSET)
    cfg = build_config(AcousticModelConfig, plain_attention(
        dict(TINY, encoding_map=dict(ct.encoding_map))))
    torch.manual_seed(0)  # the same weights whatever ran before in this process
    model = AcousticModel(cfg)
    with torch.no_grad():  # durations of ~exp(1.5) - 1 frames a token: no empty answer
        model.temporal_adaptor.predictor.linear.bias[0] += 1.5
    synth = Synthesizer(model, SynthesizerConfig(
        text_buckets=(16, 32), frame_budgets=(64,), frames_per_token=3.0,
        steps=1, charset=tuple(CHARSET)))
    srv = TTSServer(synth, port=0, config=ServerConfig(
        max_batch=8, max_wait_ms=400.0, default_format="mel"))
    port = srv.start()
    yield srv, port
    srv.stop()


def _post(port, payload, path="/synthesize"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_healthz(server):
    _, port = server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as resp:
        body = json.loads(resp.read())
    assert resp.status == 200 and body["ok"] is True
    assert set(body["stats"]) >= {"requests", "batches", "max_coalesced"}


def test_single_request_mel(server):
    _, port = server
    status, ctype, body = _post(port, {"text": "hello world."})
    assert status == 200 and ctype == "application/x-npy"
    mel = np.load(io.BytesIO(body))
    assert mel.ndim == 2 and mel.shape[1] == 16 and np.isfinite(mel).all()


def test_wav_format(server):
    _, port = server
    status, ctype, body = _post(port, {"text": "hi there.", "format": "wav"})
    assert status == 200 and ctype == "audio/wav"
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == 22050
        assert w.getsampwidth() == 2 and w.getnchannels() == 1
        assert w.getnframes() > 0


def test_concurrent_requests_coalesce_into_one_batch(server):
    """N clients inside one batching window must share ONE device call:
    batches advances by less than requests, and max_coalesced > 1."""
    srv, port = server
    # settle in-flight state and warm the bucket so the window isn't
    # dominated by a first call
    _post(port, {"text": "warm."})
    with srv._stats_lock:
        before = dict(srv.stats)

    results, errs = [], []

    def call(i):
        try:
            results.append(_post(port, {"text": f"request number {i}."}))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs and len(results) == 6
    assert all(s == 200 for s, _, _ in results)
    with srv._stats_lock:
        after = dict(srv.stats)
    assert after["requests"] - before["requests"] == 6
    n_batches = after["batches"] - before["batches"]
    assert n_batches < 6, f"no coalescing: {n_batches} batches for 6 requests"
    assert after["max_coalesced"] > 1


def test_distinct_controls_are_separate_device_calls(server):
    """Controls are batch-wide scalars of a synthesis call, so
    requests with different seeds cannot share a call — but both succeed."""
    srv, port = server
    with srv._stats_lock:
        before = srv.stats["batches"]
    results = []

    def call(seed):
        results.append(_post(port, {"text": "same text.", "seed": seed}))

    threads = [threading.Thread(target=call, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(s == 200 for s, _, _ in results)
    with srv._stats_lock:
        assert srv.stats["batches"] - before >= 2


def test_bad_requests(server):
    _, port = server
    for payload in ({}, {"text": ""}, {"text": "ok.", "format": "ogg"},
                    # wrong-typed fields must be HTTP 400, not a dropped
                    # connection: list text (one utterance per request),
                    # non-numeric controls, non-object body
                    {"text": ["a.", "b."]},
                    {"text": "ok.", "speaker": [1]},
                    {"text": "ok.", "duration_factor": None},
                    [1, 2]):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, payload)
        assert exc.value.code == 400, f"payload {payload!r}"
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, {"text": "x."}, path="/nope")
    assert exc.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
    assert exc.value.code == 404


def test_synthesis_error_is_http_500(server):
    """A failing device call surfaces as HTTP 500 on every coalesced
    request, and the server stays alive."""
    srv, port = server
    real = srv.synthesizer._synthesize_mel

    def boom(*a, **k):
        raise RuntimeError("injected failure")

    srv.synthesizer._synthesize_mel = boom
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, {"text": "will fail."})
        assert exc.value.code == 500
        assert "injected failure" in json.loads(exc.value.read())["error"]
    finally:
        srv.synthesizer._synthesize_mel = real
    status, _, _ = _post(port, {"text": "alive again."})
    assert status == 200


def test_pcm_format(server):
    _, port = server
    status, ctype, body = _post(port, {"text": "hi.", "format": "pcm"})
    assert status == 200 and ctype.startswith("audio/L16")
    assert "rate=22050" in ctype
    assert len(body) > 0 and len(body) % 2 == 0  # int16 frames


def test_synthesize_long_streams_chunked_pcm(server):
    """Long-form endpoint: chunked raw-PCM stream — head sentence alone
    (time-to-first-audio), tail sentences coalesced into one device call,
    pause silence between sentences."""
    srv, port = server
    with srv._stats_lock:
        before = dict(srv.stats)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize_long",
        data=json.dumps({"text": "first one. second bit! third part?",
                         "pause_s": 0.1}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("audio/L16")
        assert resp.headers.get("Transfer-Encoding") == "chunked"
        body = resp.read()
    pause = 2 * int(0.1 * 22050)
    assert len(body) > 2 * pause and len(body) % 2 == 0
    with srv._stats_lock:
        after = dict(srv.stats)
    # 3 sentences = 3 requests, but at most 2 device batches (head + tail)
    assert after["requests"] - before["requests"] == 3
    assert after["batches"] - before["batches"] <= 2

    # degenerate input -> 400 before any streaming starts
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, {"text": "   "}, path="/synthesize_long")
    assert exc.value.code == 400


def test_synthesize_long_many_sentences_waves(server):
    """A document with more sentences than max_batch streams in bounded
    waves (backpressure can't orphan accepted requests)."""
    srv, port = server
    with srv._stats_lock:
        before = dict(srv.stats)
    text = " ".join(f"sentence number {i}." for i in range(10))
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize_long",
        data=json.dumps({"text": text, "pause_s": 0.05}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = resp.read()
    assert len(body) > 9 * 2 * int(0.05 * 22050)
    with srv._stats_lock:
        after = dict(srv.stats)
    assert after["requests"] - before["requests"] == 10
    # head + ceil(9 / max_batch=8) = 2 waves -> at most 3 device calls
    assert after["batches"] - before["batches"] <= 3


def test_transient_error_fails_batch_without_retry_amplification(server):
    """A non-ValueError (transient device error) on a coalesced window must
    fail the window as HTTP 500 WITHOUT N sequential single-row retries."""
    srv, port = server
    real = srv.synthesizer._synthesize_mel
    calls = []

    with srv._stats_lock:
        before = srv.stats["requests"]

    def boom(*a, **k):
        calls.append(1)
        # hold the first call until all 4 requests are queued: the other 3
        # then share the next window, whatever the threads' timing
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with srv._stats_lock:
                if srv.stats["requests"] - before >= 4:
                    break
            time.sleep(0.01)
        raise RuntimeError("transient device error")

    srv.synthesizer._synthesize_mel = boom
    try:
        codes = []

        def call(i):
            try:
                _post(port, {"text": f"will fail {i}."})
            except urllib.error.HTTPError as e:
                codes.append(e.code)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        srv.synthesizer._synthesize_mel = real
    assert codes == [500, 500, 500, 500]
    # no amplification: at most one device attempt per coalesced window
    assert len(calls) <= 2


def test_stop_fails_queued_requests_promptly():
    """stop() must fail anything still queued so handler threads don't sit
    out the full request timeout against a dead batcher."""
    from isp_tts_tpu_torch.serving_server import _Pending

    srv = TTSServer.__new__(TTSServer)  # no model needed for this path
    import queue as _q
    import threading as _t

    srv._queue = _q.Queue()
    srv._encode_queue = _q.Queue()
    srv._threads = []
    srv._httpd = None
    srv._stopping = False
    pending = _Pending(text="never served.", controls=(0,))
    srv._queue.put(pending)
    srv.stop()
    assert pending.done.is_set()
    assert pending.error == "server shutting down"


def test_poison_request_does_not_fail_the_batch(server):
    """One bad input in a coalesced window (text over the largest bucket ->
    ValueError) must fail ONLY the offender (HTTP 400), not the innocent
    requests sharing its device call."""
    srv, port = server
    results, codes = [], []

    def good(i):
        try:
            results.append(_post(port, {"text": f"fine request {i}."}))
        except urllib.error.HTTPError as e:
            codes.append(("good", e.code))

    def poison():
        try:
            _post(port, {"text": "x" * 500})  # exceeds every text bucket
        except urllib.error.HTTPError as e:
            codes.append(("poison", e.code))

    threads = [threading.Thread(target=good, args=(i,)) for i in range(3)]
    threads.append(threading.Thread(target=poison))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(results) == 3 and all(s == 200 for s, _, _ in results)
    assert ("poison", 400) in codes
    assert not any(k == "good" for k, _ in codes)


def test_queue_backpressure_returns_503():
    """Requests beyond max_queue are rejected (HTTP 503 via
    OverloadedError), not buffered without bound."""
    from isp_tts_tpu_torch.serving_server import OverloadedError, _Pending

    srv = TTSServer.__new__(TTSServer)
    import queue as _q
    import threading as _t

    srv._queue = _q.Queue()
    srv._stats_lock = _t.Lock()
    srv.stats = {"requests": 0, "batches": 0, "errors": 0,
                 "max_coalesced": 0, "rejected": 0}
    srv.config = ServerConfig(max_queue=2)
    srv.enqueue("one."), srv.enqueue("two.")
    with pytest.raises(OverloadedError):
        srv.enqueue("three.")
    assert srv.stats["rejected"] == 1 and srv.stats["requests"] == 2


def test_encode_wav_roundtrip():
    sr = 16000
    audio = np.sin(np.linspace(0, 100, 1600)).astype(np.float32) * 0.5
    data = encode_wav(audio, sr)
    with wave.open(io.BytesIO(data)) as w:
        assert w.getframerate() == sr and w.getnframes() == 1600
        pcm = np.frombuffer(w.readframes(1600), "<i2").astype(np.float32)
    np.testing.assert_allclose(pcm / 32767.0, audio, atol=1e-4)


def test_lone_request_skips_batching_window(server):
    """A lone request on an idle daemon must dispatch immediately — the
    max_wait_ms coalescing window only opens on evidence of concurrency
    (peers queued / previous window >1), so single-stream latency never
    pays it. A 5 s window with a << 2.5 s response proves the skip."""
    srv, _ = server
    srv2 = TTSServer(srv.synthesizer, port=0, config=ServerConfig(
        max_batch=8, max_wait_ms=5000.0, default_format="mel"))
    port2 = srv2.start()
    try:
        _post(port2, {"text": "warm."})
        t = time.monotonic()
        status, _, _ = _post(port2, {"text": "solo goes now."})
        elapsed = time.monotonic() - t
        assert status == 200
        assert elapsed < 2.5, f"lone request waited the window: {elapsed:.2f}s"
    finally:
        srv2.stop()


class _WarmupProbe:
    """A synthesizer stand-in that records the thread of each call."""

    sample_rate = 22050

    def __init__(self):
        self.threads = []

    def warmup(self, batch_sizes=(1,)):
        self.threads.append(threading.current_thread().name)


def test_warmup_runs_on_the_batcher_thread_before_the_socket_serves():
    """``--warmup`` warms the thread that serves requests (the per-thread
    first-call costs), and the HTTP thread starts only after it finished."""
    probe = _WarmupProbe()
    srv = TTSServer(probe, port=0)
    started = []

    def warm():
        started.append(srv._threads[-1].is_alive())  # the HTTP thread
        probe.warmup(batch_sizes=(1, 8))

    srv.start(warmup=warm)
    try:
        assert probe.threads == ["tts-batcher"]
        assert started == [False] and srv._threads[-1].is_alive()
    finally:
        srv.stop()


def test_warmup_failure_stops_the_server():
    def fail():
        raise RuntimeError("no card")

    srv = TTSServer(_WarmupProbe(), port=0)
    with pytest.raises(RuntimeError, match="no card"):
        srv.start(warmup=fail)
    assert srv._threads == [] and srv._httpd is None
