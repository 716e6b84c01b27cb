"""The serving drive: the port's ContinuousBatcher on one thread, looping
``step()`` as the HTTP server's serving loop does, fed by a traffic kind
(traffic/open_loop_serve.py, traffic/closed_loop_serve.py) through
``enqueue``. The harness stamps each chunk's landing on the host when the
``step()`` that collected it returns. ``drive`` is a serving kind's whole
run: the system, the window, its metrics and the numbers ``correct`` reads.

A mix whose batcher gives ``cards`` serves from one pool split over that
many devices (parallel/mesh.make_mesh over cuda:0 .. cards - 1; on the CPU
the device repeated), one shard of slots / cards rows on each, every
shard's step launched by this one thread. Without it the pool is one shard
on the engine's device.

Requests carry token ids, a voice of the bank and their frame noise (the
host-noise path of a caller with a fixed seed), all made here from the
seed in the served dtype; EOS is off, so each request stops at its frame
budget.
"""

from __future__ import annotations

import collections
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, roofline, system as S
from .trace import SubWindow

FRAME_S = 1.0 / 12.5       # audio seconds of one frame's chunk


class Spec:
    """One request as the traffic made it."""

    __slots__ = ("rid", "frames", "ids", "voice", "noise", "due", "prompt_len")

    def __init__(self, frames, ids, voice, noise, prompt_len):
        self.frames, self.ids, self.voice = frames, ids, voice
        self.noise, self.prompt_len = noise, prompt_len
        self.rid = -1
        self.due = 0.0


def request_spec(mix: dict, cfg: dict, seed: int, stream: int, index: int, frames: int,
                 dtype: torch.dtype) -> Spec:
    """Ids (about frames x ids_per_frame of them, clipped), a voice and
    frame noise N(0, temp) rounded to the served dtype, from (seed,
    stream, index) alone."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, stream, index])
    n_ids = int(np.clip(round(frames * mix["ids_per_frame"]), mix["ids_min"], mix["ids_max"]))
    ids = rng.integers(1, cfg["flowlm"]["vocab"], size=n_ids).astype(np.int32)
    voice = int(rng.integers(0, mix["voices"]))
    z = rng.standard_normal((frames, cfg["flowlm"]["latent_dim"]), dtype=np.float32)
    z = z * np.float32(math.sqrt(mix["temp"]))
    noise = torch.from_numpy(z).to(dtype).float().numpy()
    plen = cfg["assumed"]["voice_frames"] + n_ids + 1
    return Spec(frames, ids, voice, noise, plen)


def stratified(n: int, seed: int, stream: int, inv) -> np.ndarray:
    """n values inv(u) at the midpoints u = (i + 0.5) / n, in an order drawn
    from (seed, stream): every seed gets the same values, reordered."""
    u = (np.arange(n) + 0.5) / n
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, stream])
    return np.asarray(inv(u))[rng.permutation(n)]


def frames_inv(mix: dict):
    lo, hi = mix["frames"]["lo"], mix["frames"]["hi"]
    if mix["frames"]["dist"] == "log_uniform":
        return lambda u: np.rint(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))).astype(int)
    return lambda u: np.rint(lo + u * (hi - lo)).astype(int)


class ServeRun:
    """One run of a serving cell. ``feeder`` (a traffic kind's object)
    decides when requests enter the queue; see run()."""

    def __init__(self, system, mix: dict, seed: int, seconds: float, trace: bool):
        from ptts_torch.runtime.batching import ContinuousBatcher, Request

        self.Request = Request
        self.system, self.mix, self.seed, self.seconds = system, mix, seed, seconds
        self.trace = trace
        bc = mix["batcher"]
        self.b = ContinuousBatcher(
            system.engine, slots=bc["slots"], max_len=bc["max_len"],
            admit_chunk=bc["admit_chunk"], prefix_budget=bc["prefix_budget"], max_num_steps=1,
            pipeline=bc["pipeline"], frames_per_step=bc["frames_per_step"],
            collect_pcm=True, noise_budget=bc["max_len"] - bc["prefix_budget"],
            mesh=pool_mesh(bc.get("cards"), system.device))
        # the devices the pool's shards live on, in shard order
        self.devices = list(dict.fromkeys(sh.device for sh in self.b.shards))
        self.vidx = [self.b.register_voice(f"voice{i}", system.voices[i].float().cpu().numpy())
                     for i in range(mix["voices"])]
        if min(self.vidx) < 0:
            raise RuntimeError("the batcher's voice bank refused a voice")
        self.tap = None                        # a FrameTap, installed before run()
        self._next_rid = 0
        self.specs: Dict[int, Spec] = {}       # rid -> spec
        self.fifo = collections.deque()        # rids in queue order
        self.seen: Dict[int, int] = {}         # rid -> chunks landed
        self.land: Dict[int, List[tuple]] = collections.defaultdict(list)  # rid -> [(t, n)]
        self.admit_t: Dict[int, float] = {}
        self.frames_out: Dict[int, int] = {}
        self.keep_pcm: set = set()
        self.pcm: Dict[int, np.ndarray] = {}
        self.outstanding = 0
        self.lateness: List[float] = []
        self.on_admit = None
        self.backlog: List[tuple] = []         # (t, requests outstanding) after each step

    # -- requests ---------------------------------------------------------------

    def enqueue(self, spec: Spec, due: float) -> None:
        spec.rid = rid = self._next_rid
        self._next_rid += 1
        spec.due = due
        req = self.Request(rid=rid, prefix=None, noise=spec.noise, max_frames=spec.frames,
                           eos_after=0, num_steps=1, eos_threshold=np.float32(1e30),
                           eos_min_frames=1, ids=spec.ids, voice_idx=self.vidx[spec.voice],
                           temp=float(self.mix["temp"]))
        self.b.enqueue(req)
        self.specs[rid] = spec
        self.fifo.append(rid)
        self.seen[rid] = 0
        self.outstanding += 1

    def watch(self, rid: int) -> None:
        """Record this queued request's frames for the check."""
        if self.tap is not None and not self.tap.watch_request(rid, self.specs[rid].noise):
            raise RuntimeError("the frame tap has no slot left for a sampled request")

    def step(self) -> None:
        """One batcher step with the harness's bookkeeping: admissions,
        chunk landings and finished requests, stamped when it returns."""
        b = self.b
        t0 = time.perf_counter()
        q0 = len(b.queue)
        b.step()
        now = time.perf_counter()
        for _ in range(q0 - len(b.queue)):
            rid = self.fifo.popleft()
            self.admit_t[rid] = t0
            if self.on_admit is not None:
                self.on_admit(rid)
        seen, land = self.seen, self.land
        for rid, parts in b.chunks.items():
            n = len(parts)
            if n != seen[rid]:
                land[rid].append((now, n))
                seen[rid] = n
        if b.finished:
            for rid, res in b.finished.items():
                if res.frames != seen[rid]:
                    land[rid].append((now, res.frames))
                    seen[rid] = res.frames
                self.frames_out[rid] = res.frames
                if rid in self.keep_pcm:
                    self.pcm[rid] = res.pcm_i16
                self.outstanding -= 1
            b.finished.clear()
        self.backlog.append((now, self.outstanding))

    # -- the run ----------------------------------------------------------------

    def run(self, feeder) -> dict:
        """Warm-up, the window of ``seconds``, the drain. The feeder's
        methods: warm(now) -> bool (feed warm-up load; False once warm),
        start(t0) (the window begins), feed(now) (enqueue what is due),
        close(now) (the window closed), next_due() (when the next request
        is due, or None); it marks the requests whose PCM the check needs
        in keep_pcm and has them watched (watch)."""
        from ptts_torch.runtime import graphs

        b = self.b
        while feeder.warm(time.perf_counter()):
            if self.outstanding:
                self.step()
            else:
                time.sleep(0.0005)
        captures = graphs.STATS["captures"]
        base = {"phase": dict(b.phase_s), "steps": b.n_steps}
        t_start = time.perf_counter()
        self.t_start, self.t_end = t_start, t_start + self.seconds
        feeder.start(t_start)
        cards = [d.index for d in self.devices] if self.devices[0].type == "cuda" else None
        sub = SubWindow(cards) if self.trace else None
        sub_at = t_start + self.mix["trace"]["start_frac"] * self.seconds
        sub_steps = 0
        host_cut = None            # host metrics of a traced run stop where the profiler starts
        drain_limit = self.t_end + self.mix["drain_s"]
        while True:
            now = time.perf_counter()
            if now < self.t_end:
                feeder.feed(now)
            elif not feeder.closed_flag:
                feeder.close(now)
            if not self.outstanding:
                if now >= self.t_end:
                    break
                nxt = feeder.next_due()
                time.sleep(min(max(nxt - now, 0.0), 0.001) if nxt is not None else 0.0005)
                continue
            if now > drain_limit:
                break
            if sub is not None and host_cut is None and now >= sub_at:
                host_cut = {"t": now, "phase": dict(b.phase_s), "steps": b.n_steps}
                launches = (_b1_launches(), b.n_admit_groups)
                sub.start()
            if sub is not None and sub.prof is not None:
                with torch.profiler.record_function("bench.step"):
                    self.step()
                sub_steps += 1
                if sub_steps >= self.mix["trace"]["steps"]:
                    sub.stop()
                    launches = (_b1_launches() - launches[0], b.n_admit_groups - launches[1])
            else:
                self.step()
        self.t_drained = time.perf_counter()
        captured_in_window = graphs.STATS["captures"] - captures
        end = host_cut or {"t": self.t_end, "phase": dict(b.phase_s), "steps": b.n_steps}
        phase = {k: end["phase"].get(k, 0.0) - base["phase"].get(k, 0.0) for k in end["phase"]}
        sub_info = {"steps": sub_steps, "frames": sub_steps * b.frames_per_step, "admitted": []}
        if sub is not None and sub.events is not None:
            # the prompts the profiled steps admitted, for B1's bound
            sub_info["admitted"] = [self.specs[r].prompt_len for r, t in self.admit_t.items()
                                    if host_cut["t"] <= t < sub.t1]
            sub_info["b1_launches"], sub_info["admit_groups"] = launches
        return {"sub": sub if sub is not None and sub.events is not None else None,
                "sub_info": sub_info, "host_phase_s": phase,
                "host_steps": end["steps"] - base["steps"], "host_t_end": end["t"],
                "captured_in_window": captured_in_window}

    def cancel_queued(self) -> None:
        """Drop the requests still queued (a closed loop's backlog at the
        close): they were never admitted."""
        while self.b.queue:
            req = self.b.queue.popleft()
            self.b.chunks.pop(req.rid, None)
            self.outstanding -= 1
            self.fifo.remove(req.rid)
            self.specs[req.rid].due = None

    # -- what the run measured ------------------------------------------------

    def landed_in(self, t0: float, t1: float):
        """(chunks landed in [t0, t1), gaps between successive landings of
        one stream that ended in it, (prompt_len, first frame, end frame) of
        each landing)."""
        chunks, gaps, delivered = 0, [], []
        for rid, ls in self.land.items():
            prev_t, prev_n = None, 0
            plen = self.specs[rid].prompt_len
            for t, n in ls:
                if t0 <= t < t1:
                    chunks += n - prev_n
                    delivered.append((plen, prev_n, n))
                    if prev_t is not None:
                        gaps.append(t - prev_t)
                prev_t, prev_n = t, n
        return chunks, gaps, delivered

    def first_audio(self, rids) -> List[float]:
        """Due time -> first landing, per request (inf when none landed)."""
        out = []
        for rid in rids:
            ls = self.land.get(rid)
            out.append(ls[0][0] - self.specs[rid].due if ls else math.inf)
        return out


def pool_mesh(cards: Optional[int], device: torch.device):
    """The mesh of a pool over ``cards`` devices: cuda:0 .. cards - 1 on the
    card, ``device`` repeated elsewhere; None without ``cards``."""
    if not cards:
        return None
    from ptts_torch.parallel.mesh import make_mesh
    devices = ([torch.device("cuda", i) for i in range(cards)] if device.type == "cuda"
               else [device] * cards)
    return make_mesh(devices)


def _b1_launches() -> int:
    """B1 launches so far (the kernel wrapper's counter)."""
    from ptts_torch.ops.cuda import fused_attention as fa
    return sum(fa.causal_attention_qkv.shapes.values())


def p95(values) -> Optional[float]:
    """The 95th percentile (numpy's linear interpolation); None if empty."""
    v = [x for x in values]
    if not v:
        return None
    return float(np.percentile(np.asarray(v, np.float64), 95))


def quantiles_ms(seconds) -> List[float]:
    """[p50, p90, p95, p99, max] of durations in seconds, in ms; for the run's
    info line, where a tail that moves shows whether its shape did."""
    v = np.asarray(list(seconds), np.float64)
    if not v.size:
        return []
    return [float(x) * 1e3 for x in np.percentile(v, [50, 90, 95, 99, 100])]


def drive(cell, feeder_cls) -> dict:
    """A serving kind's run (see traffic/__init__.py): the batcher over the
    system built from the seed, fed by ``feeder_cls``, the frame tap on the
    sampled requests, the window, and the numbers of the check."""
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    on_card = dev.type == "cuda"
    sysm = S.build(cfg, cell.seed, dev, mix["voices"])
    run = ServeRun(sysm, mix, cell.seed, cell.seconds, cell.trace)
    feeder = feeder_cls(run, mix, cfg, cell.seed, cell.seconds)
    bc = mix["batcher"]
    tap = S.FrameTap(cfg["flowlm"]["latent_dim"], feeder.watch_slots,
                     bc["max_len"] - bc["prefix_budget"])
    tap.bind(run.b.shards)
    run.tap = tap
    tap.install()
    try:
        res = run.run(feeder)
    finally:
        tap.uninstall()
    t_start, t_end = run.t_start, run.t_end
    peaks = [torch.cuda.max_memory_allocated(d) for d in run.devices] if on_card else [0]
    window = [r for r in feeder.window_rids if run.specs[r].due is not None]
    chunks, gaps, _ = run.landed_in(t_start, t_end)
    e2e = {"audio_s_per_s": chunks * FRAME_S / cell.seconds,
           "chunk_gap_p95_ms": (p95(gaps) or float("nan")) * 1e3,
           "first_audio_p95_ms": (p95(run.first_audio(window)) or float("nan")) * 1e3}
    h_end = res["host_t_end"]
    admitted = [r for r in window if r in run.admit_t and run.admit_t[r] < h_end]
    _, _, deliv = run.landed_in(t_start, h_end)
    obs = dict(sub=res["sub"], sub_info=res["sub_info"], host_phase_s=res["host_phase_s"],
               host_steps=res["host_steps"],
               queue_wait_s=[run.admit_t[r] - run.specs[r].due for r in admitted],
               admitted_lengths=[run.specs[r].prompt_len for r in admitted],
               delivered_flops=sum(roofline.stream_flops(cfg["flowlm"], cfg["mimi"], p, a, z)
                                   for p, a, z in deliv),
               flops_window_s=h_end - t_start)
    lat = run.lateness
    si = res["sub_info"]
    info = dict(requests=len(window), chunks=chunks,
                sub_b1_launches=si.get("b1_launches"), sub_admit_groups=si.get("admit_groups"),
                lateness_p99_ms=sorted(lat)[int(0.99 * (len(lat) - 1))] * 1e3 if lat else 0.0,
                captures_in_window=res["captured_in_window"], drained_s=run.t_drained - t_end,
                tap_bytes=tap.nbytes, gap_ms_q=quantiles_ms(gaps),
                step_ms_q=quantiles_ms(np.diff([t for t, _ in run.backlog
                                                if t_start <= t < t_end])),
                phase_ms_per_step={k: v * 1e3 / max(res["host_steps"], 1)
                                   for k, v in res["host_phase_s"].items()})
    sample = feeder.sample_rids()
    records = tap.find([{"key": r, "frames": run.specs[r].frames} for r in sample])
    info["sample_shards"] = sorted({rec["shard"] for rec in records.values()})
    failed = sum(1 for r in window if run.frames_out.get(r) != run.specs[r].frames)
    run.b = None
    sysm.engine = None
    del tap
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return dict(t_start=t_start, e2e=e2e, obs=obs, info=info, peaks=peaks,
                attempted=len(window), failed=failed,
                numbers=readings(run, feeder, sample, records, sysm, cell.controls))


def readings(run, feeder, sample, records: Dict[int, dict], system, controls=()) -> dict:
    """The serving cells' numbers (check.py). ``sample``: the rids the
    check judges; ``records``: rid -> the frame tap's records of them
    (FrameTap.find). A draw the feeder could not make (``unsampled``)
    counts as missing."""
    cfg = system.cfg
    fs = check.frame_samples(cfg)
    refs, out = check.references(system, cfg, controls)
    counts = {"missing": getattr(feeder, "unsampled", 0), "frames_bad": 0, "noise_bad": 0}
    window = [r for r in feeder.window_rids if run.specs[r].due is not None]
    counts["frames_bad"] = sum(1 for r in window if run.frames_out.get(r) != run.specs[r].frames)
    for rid in sample:
        spec, rec = run.specs[rid], records.get(rid)
        if rec is None or rid not in run.pcm:
            counts["missing"] += 1
            continue
        noise = torch.from_numpy(spec.noise)
        counts["noise_bad"] += int((rec["noise2"] != noise[:, :2]).any(dim=1).sum())
        ref = refs["f32"]
        prompt = ref.prompt(spec.ids.tolist(), system.voices[spec.voice])
        check.judge(refs, prompt, noise, rec["scaled"], rec["eos"], run.pcm[rid], fs, True, out)
    return check.numbers(out, counts)
