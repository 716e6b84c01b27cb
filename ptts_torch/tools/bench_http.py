"""HTTP front-door bench: the serving numbers measured at the HTTP layer
(port of tools/bench_http.py).

Concurrent HTTP clients against the port's server (runtime/server.serve):
/tts-stream (first-byte latency: request sent -> first PCM chunk on the
socket) and /tts (whole-WAV completion and requests/s). An in-process
ThreadingHTTPServer over the bench's synthetic checkpoint
(ptts_torch.bench.bench_model_dir): real sockets, chunked framing and
handler threads; only the weights are synthetic.

    python -m ptts_torch.tools.bench_http      # on a machine with a CUDA card

Env: PTTS_HTTP_SLOTS (64), PTTS_HTTP_CLIENTS (24), PTTS_HTTP_REQS (240),
PTTS_HTTP_FPS (8), PTTS_HTTP_PIPELINE (0), PTTS_HTTP_SPEC (0). Prints one
JSON line of http_* keys; http_{stream,wav}_errors count the requests that
did not come back with 200, http_kernels the kernels' launches in this
process by shape (ptts_torch.bench.kernel_counts).
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time

import numpy as np

from .. import api
from ..bench import bench_context, kernel_counts, require_card
from ..runtime import server as srv


def _stream_once(addr, payload) -> tuple:
    """POST /tts-stream; return (first_byte_s, total_s, n_bytes), or
    (-1, -1, status) for a non-200 answer."""
    conn = http.client.HTTPConnection(*addr, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", "/tts-stream", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        resp.read()
        conn.close()
        return (-1.0, -1.0, resp.status)
    first = resp.read(2)  # chunked decode: blocks until the first PCM chunk
    t1 = time.perf_counter()
    rest = resp.read()
    t2 = time.perf_counter()
    conn.close()
    return (t1 - t0, t2 - t0, len(first) + len(rest))


def _wav_once(addr, payload) -> tuple:
    conn = http.client.HTTPConnection(*addr, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", "/tts", json.dumps(payload), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return (time.perf_counter() - t0, resp.status, len(body))


def run_http_bench_dual(ctx=None, *, device="cuda", flowlm_cfg=None, mimi_cfg=None) -> dict:
    """Both HTTP operating points over one engine: K = 8 pipelined + spec
    (the http_* keys) and K = 4 pipelined + spec (the http_lowlat_* keys)."""
    if ctx is None:
        ctx = bench_context(device, flowlm_cfg, mimi_cfg)
    out = run_http_bench(ctx, frames_per_step=8, pipeline=True, spec_admit=True)
    low = run_http_bench(ctx, frames_per_step=4, pipeline=True, spec_admit=True)
    out.update({k.replace("http_", "http_lowlat_", 1): v for k, v in low.items()})
    return out


def run_http_bench(ctx=None, slots: int = None, clients: int = None, reqs: int = None,
                   frames_per_step: int = None, pipeline: bool = None,
                   spec_admit: bool = None, verbose: bool = True, *, device="cuda",
                   flowlm_cfg=None, mimi_cfg=None) -> dict:
    """``clients`` closed-loop clients send ``reqs`` /tts-stream requests,
    then ``reqs`` /tts requests (3-8 words, 10-50 frames, EOS off, seed -1)
    to a server with ``slots`` slots; ``ctx`` defaults to
    ptts_torch.bench.bench_context(device, flowlm_cfg, mimi_cfg)."""
    slots = slots or int(os.environ.get("PTTS_HTTP_SLOTS", "64"))
    clients = clients or int(os.environ.get("PTTS_HTTP_CLIENTS", "24"))
    reqs = reqs or int(os.environ.get("PTTS_HTTP_REQS", "240"))
    fps = frames_per_step or int(os.environ.get("PTTS_HTTP_FPS", "8"))
    if pipeline is None:
        pipeline = os.environ.get("PTTS_HTTP_PIPELINE", "0") == "1"
    if spec_admit is None:
        spec_admit = os.environ.get("PTTS_HTTP_SPEC", "0") == "1"
    if ctx is None:
        ctx = bench_context(device, flowlm_cfg, mimi_cfg)
    frame_rate = ctx.mimi_cfg.frame_rate

    httpd = srv.serve(ctx, host="127.0.0.1", port=0, slots=slots, max_len=128,
                      prefix_budget=64, max_num_steps=1, frames_per_step=fps,
                      pipeline=pipeline, spec_admit=spec_admit)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    addr = httpd.server_address
    rng = np.random.default_rng(0)
    rng_lock = threading.Lock()
    words = ["hello", "world", "how", "low", "can", "you", "go", "today"]

    def payload():
        with rng_lock:
            return {"text": " ".join(rng.choice(words, size=int(rng.integers(3, 9)))),
                    "num_frames": int(rng.integers(10, 51)), "num_steps": 1,
                    "seed": -1, "temp": 0.7, "eos_enabled": False}

    out = {"http_cfg": (f"slots={slots},clients={clients},reqs={reqs},fps={fps},"
                        f"pipe={int(pipeline)},spec={int(spec_admit)}")}
    try:
        # warm-up: every serving shape once before the timed window, in
        # process with a long deadline (the first call builds the kernels)
        httpd.tts_service.generate(
            "warm up the serving programs",
            params=api.Params(num_frames=9, num_steps=1, seed=0, eos_enabled=False),
            timeout=1800)
        _stream_once(addr, payload())
        _wav_once(addr, payload())

        for mode, fn, fb_key in [("stream", _stream_once, "http_first_byte"),
                                 ("wav", _wav_once, None)]:
            lat_first, lat_total, statuses = [], [], []
            frames_total = [0]
            lock = threading.Lock()
            n_left = [reqs]
            t0 = time.perf_counter()

            def worker():
                while True:
                    with lock:
                        if n_left[0] <= 0:
                            return
                        n_left[0] -= 1
                    p = payload()
                    try:
                        if mode == "stream":
                            fb, tot, nb = _stream_once(addr, p)
                            with lock:
                                if fb >= 0:
                                    lat_first.append(fb * 1e3)
                                    lat_total.append(tot * 1e3)
                                    frames_total[0] += p["num_frames"]
                                else:
                                    statuses.append(nb)
                        else:
                            tot, status, nb = _wav_once(addr, p)
                            with lock:
                                statuses.append(status)
                                if status == 200:
                                    lat_total.append(tot * 1e3)
                                    frames_total[0] += p["num_frames"]
                    except OSError as e:
                        # a transport failure counts, and the client lives
                        # on: a dead client would shrink the measured load
                        with lock:
                            statuses.append(f"conn:{type(e).__name__}")

            ts = [threading.Thread(target=worker, daemon=True) for _ in range(clients)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            n_ok = len(lat_total)
            rps = n_ok / wall
            streams = frames_total[0] / frame_rate / wall
            if fb_key and lat_first:
                out[f"{fb_key}_p50_ms"] = float(np.percentile(lat_first, 50))
                out[f"{fb_key}_p95_ms"] = float(np.percentile(lat_first, 95))
            out[f"http_{mode}_reqs_per_s"] = rps
            if mode == "stream":
                out["http_reqs_per_s"] = rps  # headline alias
            out[f"http_{mode}_p95_ms"] = (float(np.percentile(lat_total, 95))
                                          if lat_total else -1.0)
            out[f"http_{mode}_streams"] = streams
            out[f"http_{mode}_errors"] = reqs - n_ok
            if verbose:
                extra = (f" first-byte p50 {out.get('http_first_byte_p50_ms'):.1f}"
                         f" p95 {out.get('http_first_byte_p95_ms'):.1f} ms"
                         if fb_key and lat_first else "")
                bad = [s for s in statuses if s != 200]
                print(f"[http:{mode}] {n_ok}/{reqs} ok ({clients} clients) {rps:.1f} req/s, "
                      f"{streams:.1f} concurrent streams, p95 "
                      f"{out[f'http_{mode}_p95_ms']:.1f} ms{extra}"
                      + (f", non-200: {bad[:5]}" if bad else ""), file=sys.stderr)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.tts_service.close()
        thread.join(timeout=30)
    return out


def main() -> int:
    if not require_card("ptts_torch.tools.bench_http"):
        return 2
    out = run_http_bench()
    out["http_kernels"] = kernel_counts()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
