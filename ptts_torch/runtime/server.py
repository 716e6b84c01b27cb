"""HTTP TTS server over the ContinuousBatcher (port of
ptts_tpu/runtime/server.py, which cannot be imported without jax).

Stdlib-only (http.server + threading): concurrent requests share one
device-resident slot pool, new utterances are admitted into freed KV slots
mid-flight, and each response is a complete 16-bit WAV.

    python -m ptts_torch.runtime.server --model-dir <dir> --device cuda --port 8080
    curl -d '{"text": "hello world"}' http://localhost:8080/tts > out.wav

Endpoints:
    POST /tts     {"text": str, "voice"?: str, "num_frames"?: int,
                   "num_steps"?: int, "temp"?: float, "seed"?: int,
                   "eos_enabled"?: bool, ...}      -> audio/wav
    POST /tts-stream  same body -> s16le PCM, one HTTP chunk per 80 ms frame
                   as it is produced (chunked on HTTP/1.1, unframed and
                   delimited by connection close on HTTP/1.0; headers
                   X-PTTS-Format: s16le, X-PTTS-Sample-Rate)
    GET  /healthz                                  -> 200 "ok"
    GET  /stats                                    -> engine timing summary
                                                      + a "serving" block

Errors: 400 for a malformed body or a request the pool cannot take, 429
(Retry-After) when the admission queue is full, 504 when a request outlives
its deadline (it is retired, its slot freed), 500 otherwise.

Threading model: HTTP handlers prepare and enqueue requests and wait on a
condition; ONE serving thread drives ``batcher.step()`` while anything is
queued or active. The batcher enters inference mode in each of its methods,
so both kinds of thread may call it.
"""

from __future__ import annotations

import argparse
import io
import json
import struct
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .. import api
from ..io.wav import Audio, quantize_i16
from .batching import ContinuousBatcher, QueueFull


def wav_bytes(audio: Audio) -> bytes:
    """In-memory 16-bit WAV with the reference's header and quantization."""
    bits = 16
    nch = audio.channels
    data_bytes = audio.num_samples * nch * (bits // 8)
    byte_rate = audio.sample_rate * nch * (bits // 8)
    if audio.pcm_i16 is not None:  # quantized on the device: exact bytes
        pcm = np.asarray(audio.pcm_i16[: audio.num_samples * nch], np.int16)
    else:
        pcm = quantize_i16(audio.samples[: audio.num_samples * nch])
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + data_bytes))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, nch, audio.sample_rate,
                          byte_rate, nch * (bits // 8), bits))
    buf.write(b"data")
    buf.write(struct.pack("<I", data_bytes))
    buf.write(pcm.astype("<i2").tobytes())
    return buf.getvalue()


class TTSService:
    """Owns the batcher; one background thread drives the serving loop.

    Lock discipline: HTTP handler threads do the host-heavy request prep
    (tokenize, prefix embed, noise draw) in ``batcher.prepare`` outside the
    condition lock; only the cheap enqueue and the result hand-off hold it.
    The serving thread runs ``batcher.step()`` OUTSIDE the lock too -- the
    deque/chunks handshake with enqueue is GIL-atomic -- so a submit never
    waits behind a frame in flight.
    """

    #: seconds an unclaimed result lives before it is dropped (a waiter that
    #: timed out never pops its entry)
    result_ttl: float = 600.0

    def __init__(self, ctx: "api.Context", slots: int = 16,
                 max_len: int = 768, prefix_budget: int = 128,
                 max_num_steps: int = 8, frames_per_step: int = 1,
                 pipeline: bool = True, split_admit=None,
                 max_queue: Optional[int] = None,
                 spec_admit: bool = False):
        # max_queue bounds queued-but-unserved requests (default 4x slots;
        # 0 = unbounded): past it, submit raises QueueFull -> HTTP 429
        self.ctx = ctx
        self.batcher = ContinuousBatcher(
            ctx.engine, slots=slots, max_len=max_len,
            prefix_budget=prefix_budget, max_num_steps=max_num_steps,
            frames_per_step=frames_per_step, pipeline=pipeline,
            split_admit=split_admit, spec_admit=spec_admit,
            max_queue=4 * slots if max_queue is None else max_queue,
        )
        self._cv = threading.Condition()
        self._results = {}           # rid -> (Audio, publish_time)
        self._errors = {}            # rid -> (Exception, publish_time)
        # rid -> streaming subscription (chunk hand-off to /tts-stream
        # waiters); created under the lock at submit time, removed by the
        # consuming generator
        self._streams = {}
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- request lifecycle ----------------------------------------------------

    def submit(self, text: str, voice: Optional[str] = None,
               params: Optional["api.Params"] = None) -> int:
        # tokenization / prefix assembly / noise draw: outside the lock
        req = self.batcher.prepare(text, voice=voice, params=params)
        with self._cv:
            rid = self.batcher.enqueue(req)
            self._cv.notify_all()
        return rid

    def wait(self, rid: int, timeout: Optional[float] = None) -> Audio:
        with self._cv:
            ok = self._cv.wait_for(lambda: rid in self._results or rid in self._errors,
                                   timeout=timeout)
            if not ok:
                # deadline: retire the request itself (queued -> dequeued, in
                # a slot -> slot freed), not just this waiter
                self.batcher.cancel(rid)
                self._results.pop(rid, None)
                self._errors.pop(rid, None)
                raise TimeoutError(f"request {rid} timed out")
            if rid in self._errors:
                raise self._errors.pop(rid)[0]
            return self._results.pop(rid)[0]

    def cancel(self, rid: int) -> bool:
        """Abandon a request: frees its queue entry / slot / unclaimed
        result in the batcher and drops any server-side result, error, or
        stream subscription. Idempotent; returns True if anything held
        state for the rid."""
        with self._cv:
            hit = self.batcher.cancel(rid)
            hit = self._results.pop(rid, None) is not None or hit
            hit = self._errors.pop(rid, None) is not None or hit
            st = self._streams.pop(rid, None)
            if st is not None:
                hit = True
                st["err"] = st["err"] or api.PttsError("request cancelled")
                self._cv.notify_all()  # wake any blocked consumer
        return hit

    def generate(self, text: str, voice: Optional[str] = None,
                 params: Optional["api.Params"] = None,
                 timeout: Optional[float] = None) -> Audio:
        return self.wait(self.submit(text, voice, params), timeout=timeout)

    # -- streaming request lifecycle -------------------------------------------

    def submit_stream(self, text: str, voice: Optional[str] = None,
                      params: Optional["api.Params"] = None) -> int:
        """Submit a request whose PCM is consumed incrementally through
        ``stream_chunks``. The subscription is registered in the same lock
        window as the enqueue, so the serving loop cannot finish the request
        before it exists."""
        req = self.batcher.prepare(text, voice=voice, params=params)
        with self._cv:
            rid = self.batcher.enqueue(req)
            self._streams[rid] = {
                "buf": [],        # landed-but-unconsumed int16 chunks
                "nsamples": 0,    # samples handed to buf so far
                "nparts": 0,      # batcher chunk parts drained so far
                "done": False,
                "err": None,
            }
            self._cv.notify_all()
        return rid

    def stream_chunks(self, rid: int, timeout: Optional[float] = None):
        """Yield int16 PCM chunks (one per collected frame) as the device
        produces them; returns when the stream finishes. Chunks are popped
        under the lock but yielded outside it, so a slow consumer (socket
        write) never blocks the serving loop."""
        st = self._streams[rid]
        try:
            while True:
                with self._cv:
                    ok = self._cv.wait_for(lambda: st["buf"] or st["done"] or st["err"],
                                           timeout=timeout)
                    if not ok:
                        raise TimeoutError(f"stream {rid} timed out")
                    chunks, st["buf"] = st["buf"], []
                    err, done = st["err"], st["done"]
                for c in chunks:
                    if c.size:
                        yield c
                if err is not None:
                    raise err
                if done:
                    return
        finally:
            with self._cv:
                self._streams.pop(rid, None)
                finished = st["done"] or st["err"] is not None
            if not finished:
                # leaving mid-stream (client disconnect -> GeneratorExit,
                # consumer timeout, ...) abandons the request: free its slot
                # so the next admission reuses it
                self.cancel(rid)

    def _drain_streams_locked(self, b: ContinuousBatcher) -> None:
        """Move newly collected chunks / final tails to stream subscribers.
        Caller holds self._cv."""
        woke = False
        for rid, st in self._streams.items():
            parts = b.chunks.get(rid)
            if parts is not None and len(parts) > st["nparts"]:
                for p in parts[st["nparts"]:]:
                    st["buf"].append(p)
                    st["nsamples"] += p.size
                st["nparts"] = len(parts)
                woke = True
        for rid in [r for r in b.finished if r in self._streams]:
            res = b.finished.pop(rid)
            st = self._streams[rid]
            tail = res.pcm_i16[st["nsamples"]:]
            if tail.size:
                st["buf"].append(tail)
            st["done"] = True
            woke = True
        if woke:
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    # -- serving loop ---------------------------------------------------------

    def _on_step_error(self, e: Exception) -> None:
        """Surface a failed step to every waiter and release batcher state:
        queued + in-flight requests error out, their chunk buffers are
        dropped, and their slots' host mirrors are marked done."""
        b = self.batcher
        now = time.monotonic()
        with self._cv:
            # streaming rids get the error via st['err'] below; putting them
            # in _errors too would leak (nothing pops _errors for streams)
            for req in list(b.queue):
                if req.rid not in self._streams:
                    self._errors[req.rid] = (e, now)
                b.chunks.pop(req.rid, None)
                b.first_chunk_t.pop(req.rid, None)
            b.queue.clear()
            for slot, req in enumerate(b.slot_req):
                if req is not None:
                    if req.rid not in self._streams:
                        self._errors[req.rid] = (e, now)
                    b.chunks.pop(req.rid, None)
                    b.first_chunk_t.pop(req.rid, None)
                    b.slot_req[slot] = None
                    b._done_np[slot] = True
                    b._max_frames[slot] = 0
            # speculative-admit receipts in flight: their requests are in
            # neither queue nor slots -- fail them too
            for rec in b._receipts:
                for req in rec[1]:
                    if req.rid not in self._streams:
                        self._errors[req.rid] = (e, now)
                    b.chunks.pop(req.rid, None)
                    b.first_chunk_t.pop(req.rid, None)
            b._receipts.clear()
            b._spec_inflight = 0
            b._spec_cancelled.clear()
            for st in self._streams.values():  # wake streaming consumers
                if not st["done"]:
                    st["err"] = e
            self._cv.notify_all()

    def _loop(self) -> None:
        b = self.batcher
        sr = api.Params().sample_rate
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._stop or b.queue
                                  or any(r is not None for r in b.slot_req))
                if self._stop:
                    return
            # device launches + readback run OUTSIDE the lock: enqueue only
            # appends to b.queue / b.chunks (GIL-atomic vs _admit's popleft),
            # and this thread is the batcher's only owner otherwise
            try:
                b.step()
            except Exception as e:  # the loop must keep serving: tell every waiter
                self._on_step_error(e)
                continue
            if self._streams:
                with self._cv:
                    self._drain_streams_locked(b)
            if b.finished:
                now = time.monotonic()
                with self._cv:
                    for rid, res in list(b.finished.items()):
                        del b.finished[rid]
                        self._results[rid] = (Audio(
                            sample_rate=sr, channels=1,
                            samples=res.audio,    # f32 view for API consumers
                            pcm_i16=res.pcm_i16,  # exact device WAV bytes
                        ), now)
                    # expire unclaimed results/errors (timed-out waiters
                    # never pop theirs)
                    for d in (self._results, self._errors):
                        for rid, (_, ts) in list(d.items()):
                            if now - ts > self.result_ttl:
                                del d[rid]
                    self._cv.notify_all()


def make_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for chunked transfer on /tts-stream; every non-chunked
        # response sets Content-Length so keep-alive stays correct
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _busy(self, e: Exception) -> None:
            # backpressure: the admission queue is at max_queue
            body = f"busy: {e}".encode()
            self.send_response(429)
            self.send_header("Retry-After", "1")
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                b = service.batcher
                stats = dict(service.ctx.engine.stats())
                stats["serving"] = {
                    "slots": b.slots,
                    "live_slots": sum(1 for r in b.slot_req if r is not None),
                    "queue_depth": len(b.queue),
                    "max_queue": b.max_queue,
                    "spec_inflight": b._spec_inflight,
                    "finish_per_step_ema": round(b._finish_ema, 3),
                    "steps": b.n_steps,
                    "phase_ms_per_step": {k: round(v / max(b.n_steps, 1) * 1e3, 2)
                                          for k, v in b.phase_s.items()},
                }
                self._send(200, json.dumps(stats).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def _parse_body(self):
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            text = req["text"]
            pkw = {k: req[k] for k in
                   ("num_frames", "num_steps", "temp", "seed", "eos_enabled",
                    "eos_threshold", "eos_min_frames", "eos_after", "noise_clamp") if k in req}
            return text, req.get("voice"), api.Params(**pkw)

        def do_POST(self):
            if self.path == "/tts":
                self._do_tts()
            elif self.path == "/tts-stream":
                self._do_tts_stream()
            else:
                self._send(404, b"not found", "text/plain")

        def _do_tts(self):
            try:
                text, voice, params = self._parse_body()
                audio = service.generate(text, voice=voice, params=params, timeout=300)
                self._send(200, wav_bytes(audio), "audio/wav")
            except (KeyError, json.JSONDecodeError, TypeError) as e:
                self._send(400, f"bad request: {e}".encode(), "text/plain")
            except QueueFull as e:
                self._busy(e)
            except api.PttsError as e:
                # over-budget prompt, bad params: the client's fault
                self._send(400, f"bad request: {e}".encode(), "text/plain")
            except TimeoutError as e:
                # wait() already retired the request (slot freed)
                self._send(504, f"deadline exceeded: {e}".encode(), "text/plain")
            except Exception as e:  # the handler must answer: report it as 500
                self._send(500, f"error: {e}".encode(), "text/plain")

        def _do_tts_stream(self):
            # s16le PCM, one HTTP chunk per collected 80 ms frame. Errors
            # before the first byte map to 400/429/500; an error after the
            # headers can only truncate (no terminating 0-chunk), which a
            # chunked-aware client sees as an incomplete response.
            try:
                text, voice, params = self._parse_body()
                rid = service.submit_stream(text, voice=voice, params=params)
            except QueueFull as e:
                self._busy(e)
                return
            except (KeyError, json.JSONDecodeError, TypeError, api.PttsError) as e:
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            except Exception as e:  # the handler must answer: report it as 500
                self._send(500, f"error: {e}".encode(), "text/plain")
                return
            # HTTP/1.0 clients cannot parse chunked framing: stream unframed
            # and delimit by connection close
            chunked = self.request_version >= "HTTP/1.1"
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-PTTS-Format", "s16le")
            self.send_header("X-PTTS-Sample-Rate", str(params.sample_rate))
            self.send_header("X-PTTS-Request-Id", str(rid))
            if chunked:
                self.send_header("Transfer-Encoding", "chunked")
            else:
                self.close_connection = True
            self.end_headers()
            try:
                for pcm in service.stream_chunks(rid, timeout=300):
                    data = pcm.astype("<i2").tobytes()
                    if chunked:
                        self.wfile.write(b"%X\r\n" % len(data))
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")
                    else:
                        self.wfile.write(data)
                if chunked:
                    self.wfile.write(b"0\r\n\r\n")
            except Exception:  # step error or client gone: drop the connection
                # the generator's finally already unsubscribed AND cancelled
                # the request (its slot is free for reuse)
                self.close_connection = True

    return Handler


def serve(ctx: "api.Context", host: str = "127.0.0.1", port: int = 8080,
          **service_kw) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .serve_forever())."""
    service = TTSService(ctx, **service_kw)

    class _Server(ThreadingHTTPServer):
        # handler threads wait on the batcher for whole utterances while
        # clients open a TCP connection per request; the stdlib listen
        # backlog of 5 overflows under concurrent load. The admission queue
        # is the backpressure bound (HTTP 429); the accept queue must not be.
        request_queue_size = 128
        daemon_threads = True

    httpd = _Server((host, port), make_handler(service))
    httpd.tts_service = service
    return httpd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ptts_torch HTTP TTS server")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine and the slot pool (default cuda)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=768)
    ap.add_argument("--frames-per-step", type=int, default=1,
                    help="frames per dispatch (K): >1 amortizes the per-step host "
                         "work; fresh streams' first chunks stay fast via split-admit")
    ap.add_argument("--pipeline", action=argparse.BooleanOptionalAction, default=True,
                    help="launch step N+1 before reading step N's chunks "
                         "(--no-pipeline for the serial loop)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound on queued-but-unserved requests (default 4x slots, "
                         "0=unbounded); past it /tts and /tts-stream return 429")
    ap.add_argument("--spec-admit", action="store_true",
                    help="speculative admission: the admission picks free slots on "
                         "the device, refilling rows the host has not yet seen finish")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up request served before accepting traffic")
    args = ap.parse_args(argv)

    ctx = api.load_dir(args.model_dir, device=args.device)
    httpd = serve(ctx, host=args.host, port=args.port, slots=args.slots,
                  max_len=args.max_len, frames_per_step=args.frames_per_step,
                  pipeline=args.pipeline, max_queue=args.max_queue,
                  spec_admit=args.spec_admit)
    if not args.no_warmup:
        # build the kernels and fill the allocators before the first client
        t0 = time.perf_counter()
        httpd.tts_service.generate(
            "Warm up.", params=api.Params(num_frames=2, num_steps=1, seed=0), timeout=1800)
        print(f"[ptts] warmup done in {time.perf_counter() - t0:.1f}s")
    print(f"[ptts] serving on http://{args.host}:{args.port} ({args.slots} slots, "
          f"{args.device})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.tts_service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
