"""The port's serving layer (vallex_tpu_torch/server.py): dynamic
micro-batching + stdlib HTTP app.

The non-slow cases of tests/test_server.py, run against the port's copy of
the server with stub backends: grouping, routing, split groups,
retry-singly, shutdown, parse validation, the WAV round trip, metrics,
power-of-two padding and the best_of cap. Then the port's own routes
through its real api at toy width on the CPU: /synthesize-long streams
sentence by sentence, a best_of=2 request and concurrent requests answer
200, max_rows caps the coalesced rows as _group_cap says, and malformed
top_k / top_p values answer 400.
"""

import json
import threading
import time
import urllib.request
import wave as wave_mod
import io

import numpy as np
import pytest

from vallex_tpu_torch.server import (
    DynamicBatcher,
    SynthesisRequest,
    make_server,
    wav_bytes,
    _parse_request,
)


def _stub_backends(record, fail_texts=(), delay=0.0):
    """(batch_fn, single_fn) returning len(text)-keyed sine stubs."""

    def wave_for(text):
        if text in fail_texts:
            raise ValueError(f"boom: {text}")
        return np.full(100 + len(text), 0.25, np.float32)

    def batch_fn(texts, prompts, **kw):
        if delay:
            time.sleep(delay)
        record.append(("batch", list(texts), dict(kw)))
        return [wave_for(t) for t in texts]

    def single_fn(text, **kw):
        if delay:
            time.sleep(delay)
        record.append(("single", text, dict(kw)))
        return wave_for(text)

    return batch_fn, single_fn


def _batcher(record, **kw):
    bf, sf = _stub_backends(record, **{
        k: kw.pop(k) for k in ("fail_texts", "delay") if k in kw
    })
    return DynamicBatcher(bf, sf, **kw)


def test_single_request_uses_single_path():
    rec = []
    b = _batcher(rec, max_batch=4, max_wait_ms=20)
    w = b.submit(SynthesisRequest("hello")).result(timeout=5)
    b.shutdown()
    assert len(w) == 105
    assert [r[0] for r in rec] == ["single"]


def test_concurrent_compatible_requests_batch_together():
    rec = []
    b = _batcher(rec, max_batch=4, max_wait_ms=200, delay=0.05)
    # first request occupies the worker; the rest queue up and coalesce
    futs = [b.submit(SynthesisRequest(f"t{i}")) for i in range(5)]
    waves = [f.result(timeout=10) for f in futs]
    b.shutdown()
    assert all(len(w) == 102 for w in waves)
    kinds = [r[0] for r in rec]
    # 5 requests, max_batch 4 → at most 3 calls; at least one batched
    assert len(kinds) <= 3 and "batch" in kinds
    served = []
    for r in rec:
        served.extend(r[1] if r[0] == "batch" else [r[1]])
    assert sorted(served) == [f"t{i}" for i in range(5)]


def test_results_route_to_the_right_request():
    rec = []
    b = _batcher(rec, max_batch=8, max_wait_ms=100, delay=0.05)
    texts = ["a" * (i + 1) for i in range(6)]
    futs = {t: b.submit(SynthesisRequest(t)) for t in texts}
    for t, f in futs.items():
        assert len(f.result(timeout=10)) == 100 + len(t)
    b.shutdown()


def test_incompatible_settings_split_groups():
    rec = []
    b = _batcher(rec, max_batch=8, max_wait_ms=120, delay=0.05)
    f1 = b.submit(SynthesisRequest("warm"))  # occupies the worker
    fa = [b.submit(SynthesisRequest(f"a{i}", top_k=1)) for i in range(2)]
    fb = [b.submit(SynthesisRequest(f"b{i}", top_k=50)) for i in range(2)]
    for f in [f1, *fa, *fb]:
        f.result(timeout=10)
    b.shutdown()
    for kind, payload, kw in rec:
        if kind == "batch":
            # a-group and b-group must never share a batched call
            assert not (
                any(t.startswith("a") for t in payload)
                and any(t.startswith("b") for t in payload)
            ), rec


def test_batch_failure_retries_singly_and_isolates_error():
    rec = []
    b = _batcher(
        rec, max_batch=4, max_wait_ms=150, delay=0.05,
        fail_texts=("bad",),
    )
    b.submit(SynthesisRequest("warmup")).result(timeout=10)
    good = [b.submit(SynthesisRequest(f"ok{i}")) for i in range(2)]
    bad = b.submit(SynthesisRequest("bad"))
    for f in good:
        assert len(f.result(timeout=10)) > 0  # neighbours survive
    with pytest.raises(ValueError, match="boom"):
        bad.result(timeout=10)
    b.shutdown()


def test_shutdown_fails_pending_requests():
    rec = []
    b = _batcher(rec, max_batch=2, max_wait_ms=50, delay=0.3)
    futs = [b.submit(SynthesisRequest(f"x{i}")) for i in range(4)]
    b.shutdown(timeout=5)
    states = []
    for f in futs:
        try:
            f.result(timeout=5)
            states.append("ok")
        except RuntimeError:
            states.append("shutdown")
        except Exception:
            states.append("other")
    assert "other" not in states
    assert b.queue_depth() == 0


def test_parse_request_validation():
    with pytest.raises(ValueError, match="invalid JSON"):
        _parse_request(b"{nope")
    with pytest.raises(ValueError, match='"text"'):
        _parse_request(b'{"prompt": "p"}')
    with pytest.raises(ValueError, match="non-empty"):
        _parse_request(b'{"text": "  "}')
    r = _parse_request(
        b'{"text": "hi", "top_k": 50, "temperature": 0.8, "seed": 3}'
    )
    assert (r.top_k, r.temperature, r.seed) == (50, 0.8, 3)
    assert r.group_key() != SynthesisRequest("hi").group_key()


def test_wav_bytes_roundtrip():
    wav = 0.5 * np.sin(np.arange(2400) * 0.1).astype(np.float32)
    raw = wav_bytes(wav)
    with wave_mod.open(io.BytesIO(raw)) as f:
        assert f.getframerate() == 24000
        assert f.getnchannels() == 1
        assert f.getnframes() == 2400
        pcm = np.frombuffer(f.readframes(2400), np.int16)
    np.testing.assert_allclose(pcm / 32767.0, wav, atol=2e-4)


@pytest.fixture()
def http_server():
    rec = []
    bf, sf = _stub_backends(rec)
    b = DynamicBatcher(bf, sf, max_batch=4, max_wait_ms=10)
    srv = make_server("127.0.0.1", 0, batcher=b)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}", rec
    srv.shutdown()
    b.shutdown()


def test_http_synthesize_wav(http_server):
    url, _ = http_server
    req = urllib.request.Request(
        url + "/synthesize",
        data=json.dumps({"text": "hello server"}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.headers["Content-Type"] == "audio/wav"
        body = resp.read()
    with wave_mod.open(io.BytesIO(body)) as f:
        assert f.getnframes() == 100 + len("hello server")


def test_http_synthesize_json_format(http_server):
    url, _ = http_server
    req = urllib.request.Request(
        url + "/synthesize",
        data=json.dumps({"text": "hi", "format": "json"}).encode(),
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        out = json.loads(resp.read())
    assert out["sample_rate"] == 24000
    assert out["duration_s"] > 0
    import base64

    with wave_mod.open(io.BytesIO(base64.b64decode(out["wav_base64"]))) as f:
        assert f.getnframes() == 102


def test_http_bad_request_and_health(http_server):
    url, _ = http_server
    req = urllib.request.Request(url + "/synthesize", data=b'{"x": 1}')
    try:
        urllib.request.urlopen(req, timeout=10)
        raise AssertionError("expected 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400
        assert "text" in json.loads(e.read())["error"]
    with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
        h = json.loads(resp.read())
    assert h["status"] == "ok"
    with urllib.request.urlopen(url + "/presets", timeout=10) as resp:
        p = json.loads(resp.read())
    assert "paimon" in p["presets"]


@pytest.fixture()
def http_server_streaming():
    rec = []
    bf, sf = _stub_backends(rec)

    def stream_stub(text, **kw):
        for sent in text.split("."):
            if sent.strip():
                yield np.full(200, 0.5, np.float32)

    b = DynamicBatcher(bf, sf, max_batch=4, max_wait_ms=10)
    srv = make_server("127.0.0.1", 0, batcher=b, stream_fn=stream_stub)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    srv.shutdown()
    b.shutdown()


def test_http_synthesize_long_streams_pcm(http_server_streaming):
    url = http_server_streaming
    req = urllib.request.Request(
        url + "/synthesize-long",
        data=json.dumps({"text": "One. Two. Three."}).encode(),
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.headers["Content-Type"].startswith("audio/L16")
        body = resp.read()  # urllib de-chunks
    pcm = np.frombuffer(body, "<i2")
    assert len(pcm) == 3 * 200  # three sentences x 200 samples
    np.testing.assert_allclose(pcm / 32767.0, 0.5, atol=1e-4)


def test_http_synthesize_long_rejects_empty(http_server_streaming):
    url = http_server_streaming
    req = urllib.request.Request(
        url + "/synthesize-long", data=json.dumps({"text": "   "}).encode()
    )
    try:
        urllib.request.urlopen(req, timeout=10)
        raise AssertionError("expected 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_wrongly_typed_fields_get_400_not_crash(http_server):
    """int(None)/int([1]) used to raise TypeError past the handler's
    except ValueError, killing the connection with no response."""
    url, _ = http_server
    for payload in (
        {"text": "hi", "top_k": None},
        {"text": "hi", "top_k": [1]},
        {"text": "hi", "temperature": "warm"},
        {"text": "hi", "seed": {}},
    ):
        req = urllib.request.Request(
            url + "/synthesize", data=json.dumps(payload).encode()
        )
        try:
            urllib.request.urlopen(req, timeout=10)
            raise AssertionError(f"expected 400 for {payload}")
        except urllib.error.HTTPError as e:
            assert e.code == 400, payload


def test_long_non_dict_bodies_get_400(http_server_streaming):
    url = http_server_streaming
    for body in (b"123", b'["text"]', b'{"text": "hi", "seed": null}'):
        req = urllib.request.Request(url + "/synthesize-long", data=body)
        try:
            urllib.request.urlopen(req, timeout=10)
            raise AssertionError(f"expected 400 for {body!r}")
        except urllib.error.HTTPError as e:
            assert e.code == 400, body


def test_stream_capacity_503():
    import urllib.error

    rec = []
    bf, sf = _stub_backends(rec)
    release = threading.Event()

    def slow_stream(text, **kw):
        yield np.zeros(10, np.float32)
        release.wait(10)
        yield np.zeros(10, np.float32)

    b = DynamicBatcher(bf, sf, max_batch=2, max_wait_ms=5)
    srv = make_server(
        "127.0.0.1", 0, batcher=b, stream_fn=slow_stream, max_streams=1
    )
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{port}/synthesize-long"
    results = {}

    def go(name):
        req = urllib.request.Request(
            url, data=json.dumps({"text": "a. b."}).encode()
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                r.read()
            results[name] = 200
        except urllib.error.HTTPError as e:
            results[name] = e.code

    t1 = threading.Thread(target=go, args=("first",))
    t1.start()
    time.sleep(0.5)  # first stream is mid-flight, holding the only slot
    go("second")
    release.set()
    t1.join(10)
    srv.shutdown()
    b.shutdown()
    assert results["second"] == 503
    assert results["first"] == 200


def test_submit_shutdown_race_never_hangs():
    """A submit racing shutdown either raises immediately or resolves —
    no Future may be left unresolved (it used to hang request_timeout_s)."""
    for _ in range(20):
        rec = []
        b = _batcher(rec, max_batch=2, max_wait_ms=5, delay=0.01)
        futs, errs = [], []

        def spam():
            for i in range(10):
                try:
                    futs.append(b.submit(SynthesisRequest(f"s{i}")))
                except RuntimeError:
                    errs.append(i)

        t = threading.Thread(target=spam)
        t.start()
        b.shutdown(timeout=5)
        t.join(5)
        for f in futs:
            f.exception(timeout=5)  # raises concurrent TimeoutError if stuck


def test_metrics_counters_and_endpoint(http_server):
    url, _ = http_server
    req = urllib.request.Request(
        url + "/synthesize", data=json.dumps({"text": "count me"}).encode()
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        r.read()
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    lines = dict(
        line.split(" ", 1) for line in text.splitlines()
        if line and not line.startswith("#")
    )
    assert float(lines["vallex_http_synthesize_total"]) >= 1
    assert float(lines["vallex_decode_requests_total"]) >= 1
    assert float(lines["vallex_audio_seconds_total"]) > 0
    assert float(lines["vallex_synth_seconds_total"]) >= 0


def test_metrics_batch_retry_accounting():
    from vallex_tpu_torch.server import Metrics

    rec = []
    m = Metrics()
    bf, sf = _stub_backends(rec, fail_texts=("bad",), delay=0.05)
    b = DynamicBatcher(bf, sf, max_batch=4, max_wait_ms=150, metrics=m)
    b.submit(SynthesisRequest("warmup")).result(timeout=10)
    futs = [b.submit(SynthesisRequest(t)) for t in ("ok1", "bad", "ok2")]
    for f in futs[::2]:
        f.result(timeout=10)
    with pytest.raises(ValueError):
        futs[1].result(timeout=10)
    b.shutdown()
    assert m.get("vallex_batch_retries_total") == 1
    assert m.get("vallex_synth_errors_total") == 1
    assert m.get("vallex_decode_requests_total") == 4


def test_groups_pad_to_power_of_two_batch_shapes():
    """Group sizes pad to {2,4,...,max_batch} so every size reuses one
    compiled program; results still route only to the real requests."""
    rec = []
    b = _batcher(rec, max_batch=8, max_wait_ms=150, delay=0.05)
    b.submit(SynthesisRequest("warmup")).result(timeout=10)
    futs = [b.submit(SynthesisRequest(f"g{i}")) for i in range(3)]
    for i, f in enumerate(futs):
        assert len(f.result(timeout=10)) == 100 + 2  # its own text
    b.shutdown()
    batch_calls = [r for r in rec if r[0] == "batch"]
    assert len(batch_calls) == 1
    texts = batch_calls[0][1]
    assert len(texts) == 4  # 3 real + 1 pad
    assert texts == ["g0", "g1", "g2", "g2"]


def test_best_of_requests_coalesce_into_one_decode():
    """Two concurrent best_of=5 requests share ONE batched call (the
    signature UI quality mode batches across requests) and the best_of
    knob reaches the engine; a best_of=1 request never joins them."""
    rec = []
    b = _batcher(rec, max_batch=8, max_rows=16, max_wait_ms=200, delay=0.05)
    b.submit(SynthesisRequest("warmup")).result(timeout=10)
    futs = [
        b.submit(SynthesisRequest(f"q{i}", best_of=5)) for i in range(2)
    ]
    plain = b.submit(SynthesisRequest("p0", best_of=1))
    for f in [*futs, plain]:
        f.result(timeout=10)
    b.shutdown()
    batch_calls = [r for r in rec if r[0] == "batch"]
    assert len(batch_calls) == 1, rec
    texts, kw = batch_calls[0][1], batch_calls[0][2]
    assert set(t for t in texts if not t.startswith("p")) == {"q0", "q1"}
    assert kw["best_of"] == 5
    assert "p0" not in texts  # different best_of never shares a decode
    assert b.metrics.get("vallex_batched_calls_total") == 1


def test_best_of_group_cap_bounds_total_rows():
    """A best_of group holds at most max_rows//best_of requests: each
    request brings best_of decode lanes, and the padded row total must
    stay within the measured throughput knee."""
    rec = []
    b = _batcher(rec, max_batch=8, max_rows=16, max_wait_ms=200, delay=0.05)
    assert b._group_cap(1) == 8
    assert b._group_cap(5) == 3
    assert b._group_cap(16) == 1
    assert b._group_cap(100) == 1  # oversized best_of → single path
    b.submit(SynthesisRequest("warmup")).result(timeout=10)
    futs = [
        b.submit(SynthesisRequest(f"r{i}", best_of=5)) for i in range(5)
    ]
    for f in futs:
        f.result(timeout=10)
    b.shutdown()
    for kind, payload, kw in rec:
        if kind == "batch":
            assert len(payload) * kw["best_of"] <= 16, rec


def test_parse_request_best_of():
    r = _parse_request(b'{"text": "hi", "best_of": 5}')
    assert r.best_of == 5
    assert _parse_request(b'{"text": "hi"}').best_of == 1
    with pytest.raises(ValueError):
        _parse_request(b'{"text": "hi", "best_of": 0}')
    with pytest.raises(ValueError):
        _parse_request(b'{"text": "hi", "best_of": 99}')
    with pytest.raises(ValueError):
        _parse_request(b'{"text": "hi", "best_of": "five"}')


def _real_api(**engine):
    """The port's api with a toy-width random model on the CPU."""
    import torch

    from vallex_tpu_torch import api
    from vallex_tpu_torch.config import EngineConfig, ModelConfig

    torch.set_num_threads(1)
    return api.preload_models(
        random_weights=True, device="cpu", seed=3,
        cfg=ModelConfig(d_model=64, num_heads=4, num_layers=2, ffn_dim=128),
        ecfg=EngineConfig(text_buckets=(64, 128), audio_buckets=(128, 256, 512),
                          compute_dtype="float32", **engine))


@pytest.fixture()
def real_server():
    """make_server with its defaults: the batcher and the streaming route
    bound to the port's api."""
    b = DynamicBatcher(max_batch=4, max_wait_ms=1000)  # room for a loaded test host
    srv = make_server("127.0.0.1", 0, batcher=b)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", b
    srv.shutdown()
    b.shutdown()


def test_http_synthesize_long_port_streams_200_pcm(real_server):
    """The default stream_fn is now the port's stream_audio_from_long_text:
    POST /synthesize-long answers 200 and streams 24 kHz PCM whose length
    is the sentences' frames · 320 (greedy, so it equals the batch API's
    generate_audio_from_long_text)."""
    from vallex_tpu_torch import api

    _real_api(top_k=1)
    url, _ = real_server
    body = json.dumps({"text": "One. Two.", "language": "en", "mode": "sliding-window",
                       "seed": 2}).encode()
    with urllib.request.urlopen(urllib.request.Request(url + "/synthesize-long", data=body),
                                timeout=120) as r:
        assert r.status == 200 and r.headers["Content-Type"].startswith("audio/L16")
        pcm = np.frombuffer(r.read(), "<i2")
    sent = []
    orig = api.codes_to_wave
    api.codes_to_wave = lambda b, c: sent.append(len(c)) or orig(b, c)
    try:
        api.generate_audio_from_long_text("One. Two.", language="en", seed=2)
    finally:
        api.codes_to_wave = orig
    assert len(pcm) == sent[0] * 320 > 0


def test_http_best_of_request_on_cpu(real_server):
    """A best_of=2 request (sampled, then filtered) answers 200 with a
    24 kHz WAV through the port's best_of decode."""
    _real_api()
    url, b = real_server
    for extra in ({}, {"top_k": 5, "top_p": 0.9}):
        body = json.dumps({"text": "Hi there.", "language": "en", "best_of": 2, **extra}).encode()
        with urllib.request.urlopen(urllib.request.Request(url + "/synthesize", data=body),
                                    timeout=120) as r:
            assert r.status == 200
            with wave_mod.open(io.BytesIO(r.read())) as f:
                assert f.getframerate() == 24000 and f.getnframes() > 0
    assert b.metrics.get("vallex_synth_errors_total") == 0


@pytest.mark.parametrize("max_rows,best_of", [(4, 2), (6, 3), (5, 5)])
def test_max_rows_caps_coalesced_rows(max_rows, best_of):
    """Concurrent best_of requests coalesce into groups of at most
    _group_cap(best_of) = max_rows // best_of requests (1: the single
    path), so no batched call holds more than max_rows decode rows."""
    rec = []
    b = _batcher(rec, max_batch=8, max_rows=max_rows, max_wait_ms=200, delay=0.05)
    cap = b._group_cap(best_of)
    assert cap == max(1, min(8, max_rows // best_of))
    b.submit(SynthesisRequest("warmup")).result(timeout=10)
    futs = [b.submit(SynthesisRequest(f"r{i}", best_of=best_of)) for i in range(5)]
    for f in futs:
        f.result(timeout=10)
    b.shutdown()
    calls = [r for r in rec if r[1] != "warmup"]
    for kind, payload, kw in calls:
        n = len(payload) if kind == "batch" else 1
        assert n <= cap and n * best_of <= max(max_rows, best_of), rec
    assert sum(len(p) if k == "batch" else 1 for k, p, _ in calls) >= 5
    if cap == 1:
        assert all(k == "single" for k, _, _ in calls)


def test_http_bad_top_k_top_p_answer_400(http_server):
    """top_k must be an int and top_p a float: anything else is a 400 with
    the field named, before any synthesis runs."""
    url, rec = http_server
    for field, value in (("top_k", "ten"), ("top_k", None), ("top_k", [5]),
                         ("top_p", "high"), ("top_p", None), ("top_p", {"p": 1})):
        req = urllib.request.Request(
            url + "/synthesize", data=json.dumps({"text": "hi", field: value}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        assert field in json.loads(e.value.read())["error"]
    assert rec == []


@pytest.mark.parametrize("engine,texts", [
    (dict(), ["Hi.", "Go now.", "Yes."]),
    (dict(quantize="int8kv", decode_mode="megakernel"), ["Hi.", "Go now."]),
], ids=["bf16", "int8kv"])
def test_http_real_batched_synthesis_on_cpu(engine, texts):
    """Concurrent POST /synthesize requests through the default batcher,
    bound to the port's api.generate_audio_batch (toy width, CPU, random
    weights; also a server whose EngineConfig serves int8kv: int8 weights
    and batched int8 caches): each answers 200 with a 24 kHz WAV, the
    requests coalesce into a batched call, and nothing is retried or
    fails."""
    _real_api(**engine)
    b = DynamicBatcher(max_batch=4, max_wait_ms=1000)  # room for a loaded test host
    srv = make_server("127.0.0.1", 0, batcher=b)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/synthesize"
    out = {}

    def go(i, text):
        body = json.dumps({"text": text, "language": "en", "top_k": 1}).encode()
        with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as r:
            out[i] = (r.status, r.read())

    try:
        ts = [threading.Thread(target=go, args=(i, t)) for i, t in enumerate(texts)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(150)
    finally:
        srv.shutdown()
        b.shutdown()
    assert sorted(out) == list(range(len(texts)))
    for status, body in out.values():
        assert status == 200
        with wave_mod.open(io.BytesIO(body)) as f:
            assert f.getframerate() == 24000 and f.getnframes() > 0
    m = b.metrics
    assert m.get("vallex_batched_calls_total") >= 1
    assert m.get("vallex_batch_retries_total") == 0
    assert m.get("vallex_synth_errors_total") == 0
