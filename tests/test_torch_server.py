"""The port's HTTP server (ptts_torch/runtime/server.py) on the tiny
synthetic model, CPU, f32: real HTTP requests against a ThreadingHTTPServer
over the port's TTSService and ContinuousBatcher. The serving thread and
the handler threads are not the thread that built the slot pool.

Gates: WAV int16 PCM within 8 LSB of the port's quantized offline PCM and
of the JAX server's WAV for the same request (the batcher's gate).
"""

import http.client
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch.runtime import server as srv  # noqa: E402
from ptts_tpu import api as japi  # noqa: E402
from ptts_tpu.io.safetensors import save_safetensors  # noqa: E402
from ptts_tpu.io.wav import quantize_i16  # noqa: E402

FS = TINY_MIMI.frame_samples
Params = japi.Params


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("tsrvmodel"), seed=6)
    # a second voice, registered in the bank by the first request naming it
    cond = (np.random.default_rng(9).standard_normal((1, 2, TINY_FLOWLM.d_model)) * 0.3)
    save_safetensors(os.path.join(path, "embeddings", "bob.safetensors"),
                     {"audio_prompt": cond.astype(np.float32)})
    return path


def tctx_of(model_dir):
    return tapi.Context(model_dir, flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI, device="cpu")


def start(ctx, module=srv, **kw):
    args = dict(host="127.0.0.1", port=0, slots=2, max_len=96, prefix_budget=32,
                max_num_steps=4)
    args.update(kw)
    httpd = module.serve(ctx, **args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def stop(httpd):
    httpd.shutdown()
    httpd.tts_service.close()


@pytest.fixture(scope="module")
def httpd(model_dir):
    h = start(tctx_of(model_dir))
    yield h
    stop(h)


@pytest.fixture
def fresh(model_dir):
    """A server of its own per test (first request -> rid 0)."""
    made = []

    def make(**kw):
        made.append(start(tctx_of(model_dir), **kw))
        return made[-1]

    yield make
    for h in made:
        stop(h)


def post(httpd, payload, path="/tts"):
    conn = http.client.HTTPConnection(*httpd.server_address, timeout=300)
    conn.request("POST", path, json.dumps(payload), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), body


def parse_wav(body):
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE" and body[36:40] == b"data"
    (nbytes,) = struct.unpack("<I", body[40:44])
    return np.frombuffer(body[44 : 44 + nbytes], "<i2")


def max_lsb(a, b) -> int:
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    assert a.shape == b.shape
    return int(np.abs(a - b).max())


def offline_i16(ctx, text, voice=None, **p):
    return quantize_i16(ctx.engine.generate(text, voice=voice, params=Params(**p)).samples)


REQ = {"text": "hello world", "num_frames": 4, "num_steps": 1, "seed": 5, "temp": 0.5,
       "eos_enabled": False}


def test_healthz_stats_and_404(httpd):
    conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
    conn.request("GET", "/healthz")
    assert conn.getresponse().read() == b"ok"
    conn.request("GET", "/stats")
    resp = conn.getresponse()
    assert resp.getheader("Content-Type") == "application/json"
    stats = json.loads(resp.read())
    serving = stats["serving"]
    assert serving["slots"] == 2 and serving["max_queue"] == 8
    assert serving["queue_depth"] >= 0 and serving["live_slots"] >= 0
    assert set(serving["phase_ms_per_step"]) >= {"admit", "admit_wait", "dispatch", "collect"}
    conn.request("GET", "/nope")
    assert conn.getresponse().status == 404
    conn.close()
    assert httpd.request_queue_size >= 64 and httpd.daemon_threads


def test_stats_reads_the_engine_spans(httpd):
    """/stats carries the engine's timing summary beside the serving block."""
    httpd.tts_service.ctx.engine.generate("hi", params=Params(num_frames=2, seed=1))
    conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
    conn.request("GET", "/stats")
    stats = json.loads(conn.getresponse().read())
    conn.close()
    assert stats["FlowLM latents"]["count"] >= 1
    assert stats == {**httpd.tts_service.ctx.engine.stats(), "serving": stats["serving"]}


def test_tts_matches_offline_and_the_jax_server(fresh, model_dir):
    """The first request of a fresh server (rid 0, noise seed + 0): its WAV
    against the port's offline engine and against the JAX server's WAV."""
    from ptts_tpu.runtime import server as jsrv

    h = fresh()
    status, ctype, body = post(h, REQ)
    assert status == 200 and ctype == "audio/wav"
    got = parse_wav(body)
    assert got.shape == (4 * FS,)
    ctx = h.tts_service.ctx
    want = offline_i16(ctx, "hello world", num_frames=4, num_steps=1, seed=5, temp=0.5,
                       eos_enabled=False)
    assert max_lsb(got, want) <= 8
    jctx = japi.Context(model_dir, flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI)
    jh = start(jctx, module=jsrv)
    try:
        jstatus, _, jbody = post(jh, REQ)
    finally:
        stop(jh)
    assert jstatus == 200
    assert body[:44] == jbody[:44]  # same header
    assert max_lsb(got, parse_wav(jbody)) <= 8


def test_concurrent_requests(httpd):
    """More requests in flight than slots, from parallel client threads:
    each response a WAV of its own length."""
    payloads = [{"text": t, "num_frames": f, "num_steps": 1, "seed": 50 + i,
                 "eos_enabled": False}
                for i, (t, f) in enumerate([("hello world", 3), ("how low", 4),
                                            ("hello hello", 2), ("world world", 5),
                                            ("who who", 1)])]
    results = [None] * len(payloads)

    def worker(i):
        results[i] = post(httpd, payloads[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for (status, _, body), p in zip(results, payloads):
        assert status == 200, body
        assert len(parse_wav(body)) == p["num_frames"] * FS


def test_k_frame_server_matches_offline(fresh):
    """frames_per_step=3 (split-admit on by default) serves the same WAV."""
    h = fresh(frames_per_step=3)
    assert h.tts_service.batcher.split_admit
    status, _, body = post(h, REQ)
    assert status == 200
    want = offline_i16(h.tts_service.ctx, "hello world", num_frames=4, num_steps=1, seed=5,
                       temp=0.5, eos_enabled=False)
    assert max_lsb(parse_wav(body), want) <= 8


def raw_request(addr, payload, version=b"HTTP/1.1"):
    body = json.dumps(payload).encode()
    req = (b"POST /tts-stream " + version + b"\r\nHost: t\r\n"
           b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n" % len(body)) + body
    s = socket.create_connection(addr, timeout=300)
    s.sendall(req)
    return s


def read_headers(f):
    status = f.readline()
    headers = {}
    while True:
        line = f.readline().strip()
        if not line:
            return status, headers
        k, _, v = line.partition(b":")
        headers[k.strip().lower()] = v.strip()


def test_tts_stream_incremental_pcm(fresh):
    """/tts-stream sends s16le PCM in several HTTP chunks, whole frames each,
    whose concatenation matches the offline engine."""
    h = fresh(frames_per_step=2)
    p = dict(REQ, num_frames=5)
    with raw_request(h.server_address, p) as s:
        f = s.makefile("rb")
        status, headers = read_headers(f)
        chunks = []
        while True:
            n = int(f.readline().strip(), 16)
            if n == 0:
                f.readline()
                break
            chunks.append(f.read(n))
            assert f.read(2) == b"\r\n"
    assert b"200" in status
    assert headers[b"x-ptts-format"] == b"s16le"
    assert headers[b"transfer-encoding"] == b"chunked"
    assert headers[b"x-ptts-request-id"] == b"0"
    got = np.frombuffer(b"".join(chunks), "<i2")
    assert got.size == 5 * FS
    assert len(chunks) >= 2 and all(len(c) % (2 * FS) == 0 for c in chunks)
    want = offline_i16(h.tts_service.ctx, "hello world", num_frames=5, num_steps=1, seed=5,
                       temp=0.5, eos_enabled=False)
    assert max_lsb(got, want) <= 8
    assert not h.tts_service._streams  # subscription cleaned up


def test_http10_stream_unframed(httpd):
    """An HTTP/1.0 client gets raw s16le delimited by connection close."""
    with raw_request(httpd.server_address, dict(REQ, num_frames=3), b"HTTP/1.0") as s:
        f = s.makefile("rb")
        status, headers = read_headers(f)
        data = f.read()
    assert b"200" in status and b"transfer-encoding" not in headers
    assert np.frombuffer(data, "<i2").size == 3 * FS


@pytest.mark.parametrize("path", ["/tts", "/tts-stream"])
def test_bad_request(httpd, path):
    status, _, _ = post(httpd, {"no_text": True}, path)
    assert status == 400
    conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
    conn.request("POST", path, b"{not json", {"Content-Length": "9"})
    assert conn.getresponse().status == 400
    conn.close()


def test_user_input_error_maps_to_400(httpd):
    status, _, body = post(httpd, {"text": "word " * 64, "num_frames": 2, "num_steps": 1,
                                   "seed": 1})
    assert status == 400 and b"prefix columns" in body
    status, _, body = post(httpd, {"text": "hello", "num_steps": 9, "seed": 1})
    assert status == 400 and b"num_steps" in body


def gate_steps(b):
    """Hold the serving loop until the returned event is set."""
    gate = threading.Event()
    orig = b.step
    b.step = lambda: (gate.wait(60), orig())[1]
    return gate, orig


@pytest.mark.parametrize("path", ["/tts", "/tts-stream"])
def test_queue_full_maps_to_429(fresh, path):
    h = fresh(slots=1, max_queue=1)
    b = h.tts_service.batcher
    gate, orig = gate_steps(b)
    try:
        p = {"text": "hello", "num_frames": 2, "num_steps": 1, "seed": 1, "eos_enabled": False}
        threading.Thread(target=post, args=(h, p), daemon=True).start()
        deadline = time.monotonic() + 30
        while not b.queue and time.monotonic() < deadline:
            time.sleep(0.01)
        assert b.queue, "first request never reached the queue"
        conn = http.client.HTTPConnection(*h.server_address, timeout=60)
        conn.request("POST", path, json.dumps(p), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        assert resp.status == 429, body
        assert resp.getheader("Retry-After") == "1"
    finally:
        gate.set()
        b.step = orig


def test_wait_timeout_retires_request(fresh):
    """A timed-out wait() cancels the request itself (dequeued), and the
    HTTP layer maps the deadline to 504."""
    h = fresh(slots=1)
    service = h.tts_service
    b = service.batcher
    gate, orig = gate_steps(b)
    try:
        rid = service.submit("hello", params=Params(num_frames=2, num_steps=1, seed=3,
                                                    eos_enabled=False))
        with pytest.raises(TimeoutError):
            service.wait(rid, timeout=0.2)
        assert not b.queue and rid not in b.chunks
        gate.set()
        audio = service.generate("world", params=Params(num_frames=2, num_steps=1, seed=4,
                                                        eos_enabled=False), timeout=120)
        assert audio.num_samples == 2 * FS
        assert rid not in service._results
    finally:
        gate.set()
        b.step = orig


def test_deadline_maps_to_504(fresh, monkeypatch):
    h = fresh(slots=1)
    b = h.tts_service.batcher
    gate, orig = gate_steps(b)
    real = h.tts_service.generate
    monkeypatch.setattr(h.tts_service, "generate",
                        lambda *a, **kw: real(*a, **{**kw, "timeout": 0.2}))
    try:
        status, _, body = post(h, dict(REQ, num_frames=2))
        assert status == 504 and b"deadline" in body
        assert not b.queue and not b.chunks
    finally:
        gate.set()
        b.step = orig


def test_stream_disconnect_frees_slot(fresh):
    """A /tts-stream client that disconnects mid-stream has its request
    cancelled: slot freed, chunks dropped, subscription gone."""
    h = fresh(slots=1)
    service = h.tts_service
    b = service.batcher
    s = raw_request(h.server_address, dict(REQ, num_frames=60))
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(4096)
    while len(buf) < buf.index(b"\r\n\r\n") + 64:
        buf += s.recv(4096)
    assert any(r is not None for r in b.slot_req)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    s.close()  # RST: the server's next write fails
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if all(r is None for r in b.slot_req) and not service._streams and not b.chunks:
            break
        time.sleep(0.05)
    assert all(r is None for r in b.slot_req), "slot not freed"
    assert not service._streams and not b.chunks
    status, _, body = post(h, dict(REQ, num_frames=2))
    assert status == 200, body


def test_step_error_releases_batcher_state(fresh):
    """A failing step errors the waiters, releases chunks and slots, and
    the service keeps serving."""
    h = fresh()
    service = h.tts_service
    b = service.batcher
    orig = b.step

    def failing_step():
        raise RuntimeError("injected step failure")

    b.step = failing_step
    try:
        rid = service.submit("hello", params=Params(num_frames=2, num_steps=1, seed=3,
                                                    eos_enabled=False))
        with pytest.raises(RuntimeError, match="injected step failure"):
            service.wait(rid, timeout=60)
    finally:
        b.step = orig
    assert rid not in b.chunks and all(r is None for r in b.slot_req) and not b.queue
    status, _, body = post(h, dict(REQ, num_frames=2))
    assert status == 200, body


def test_step_error_propagates_to_stream_consumer(fresh):
    h = fresh()
    service = h.tts_service
    b = service.batcher
    orig = b.step

    def failing_step():
        raise RuntimeError("injected stream failure")

    b.step = failing_step
    try:
        rid = service.submit_stream("hello", params=Params(num_frames=2, num_steps=1, seed=3,
                                                           eos_enabled=False))
        with pytest.raises(RuntimeError, match="injected stream failure"):
            for _ in service.stream_chunks(rid, timeout=60):
                pass
    finally:
        b.step = orig
    assert rid not in service._streams


@pytest.mark.parametrize("spec_admit", [False, True])
def test_admission_error_reaches_the_waiter(fresh, monkeypatch, spec_admit):
    """An admission that raises inside step() fails its request's waiter
    promptly (with either admission mode), and the service serves on."""
    from ptts_torch.runtime import batching

    h = fresh(spec_admit=spec_admit)
    real = batching.admit_slots_ids
    fail = threading.Event()
    fail.set()

    def flaky(*a, **kw):
        if fail.is_set():
            fail.clear()
            raise RuntimeError("injected admission failure")
        return real(*a, **kw)

    monkeypatch.setattr(batching, "admit_slots_ids", flaky)
    service = h.tts_service
    rid = service.submit("hello", params=Params(num_frames=2, num_steps=1, seed=3,
                                                eos_enabled=False))
    with pytest.raises(RuntimeError, match="injected admission failure"):
        service.wait(rid, timeout=60)
    assert not service.batcher.queue and rid not in service.batcher.chunks
    status, _, body = post(h, dict(REQ, num_frames=2))
    assert status == 200, body


def test_voice_registered_from_handler_while_loop_steps(fresh):
    """A request naming a new voice registers it in the device bank from its
    handler thread while the serving loop steps a long stream; both finish
    and the new voice's WAV matches the offline engine with that voice."""
    h = fresh()
    service = h.tts_service
    b = service.batcher
    long_rid = service.submit("hello world", params=Params(num_frames=30, num_steps=1, seed=1,
                                                           eos_enabled=False))
    deadline = time.monotonic() + 60
    while not b.chunks.get(long_rid) and time.monotonic() < deadline:
        time.sleep(0.005)
    assert b.chunks.get(long_rid), "the long stream never started"
    status, _, body = post(h, dict(REQ, voice="bob", num_frames=3))
    assert status == 200, body
    assert b._voice_idx == {"alba": 0, "bob": 1}
    assert int(b.shards[0].cond_len[1]) == 2
    want = offline_i16(service.ctx, "hello world", voice="bob", num_frames=3, num_steps=1,
                       seed=5 + 1, temp=0.5, eos_enabled=False)  # rid 1
    assert max_lsb(parse_wav(body), want) <= 8
    assert service.wait(long_rid, timeout=120).num_samples == 30 * FS


def test_main_serves_after_warmup(model_dir, monkeypatch, capsys):
    """main(): --device and the JAX server's flags, a warm-up request
    served before accepting traffic, then serve_forever."""
    monkeypatch.setattr(srv.api, "load_dir", lambda d, device: tapi.Context(
        d, flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI, device=device))
    seen = {}
    real_serve = srv.serve

    def serve(ctx, **kw):
        httpd = real_serve(ctx, **kw)
        seen.update(kw, device=str(ctx.device), httpd=httpd)

        def forever():
            seen["served_before_traffic"] = httpd.tts_service.batcher.n_steps > 0
            httpd.server_close()

        httpd.serve_forever = forever
        return httpd

    monkeypatch.setattr(srv, "serve", serve)
    rc = srv.main(["--model-dir", model_dir, "--device", "cpu", "--port", "0", "--slots", "2",
                   "--max-len", "192", "--frames-per-step", "2", "--no-pipeline",
                   "--max-queue", "3", "--spec-admit"])
    assert rc == 0
    assert seen["device"] == "cpu" and seen["slots"] == 2 and seen["max_len"] == 192
    assert seen["frames_per_step"] == 2 and seen["pipeline"] is False
    assert seen["max_queue"] == 3 and seen["spec_admit"] is True
    assert seen["served_before_traffic"]
    assert "[ptts] warmup done" in capsys.readouterr().out
