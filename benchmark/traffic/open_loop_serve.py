"""Open-loop serving traffic: Poisson arrivals at the mix's fixed rate,
independent of how fast the system answers.

Every seed gets the same set of request sizes and the same set of
inter-arrival gaps (stratified quantiles of the mix's distributions), in
an order drawn from the seed, so seeds change the order of the work and
not its amount. A burst of requests run to their end, then a warm-up
stretch at the same rate, of requests drawn apart, precede the window, so the window starts in steady state with
every graph captured. Each request is timed from the moment it was due.
"""

from __future__ import annotations

import numpy as np

from ..serving import drive as serve_drive, frames_inv, request_spec, stratified


def drive(cell) -> dict:
    return serve_drive(cell, Feeder)


class Feeder:
    def __init__(self, run, mix: dict, cfg: dict, seed: int, seconds: float):
        self.run, self.mix = run, mix
        rate = float(mix["rate_rps"])
        dtype = run.system.dtype

        def plan(n, stream):
            frames = stratified(n, seed, stream, frames_inv(mix))
            gaps = stratified(n, seed, stream + 1, lambda u: -np.log1p(-u) / rate)
            specs = [request_spec(mix, cfg, seed, stream + 2, i, int(frames[i]), dtype)
                     for i in range(n)]
            return np.cumsum(gaps), specs

        self.n = max(1, int(round(rate * seconds)))
        self.due, self.specs = plan(self.n, 1)
        self.warm_due, self.warm_specs = plan(max(1, int(round(rate * mix["warmup_s"]))), 11)
        self.prime = plan(mix["prime"], 21)[1]
        rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, 4])
        pick = set(rng.choice(self.n, size=min(mix["check"]["sample"], self.n), replace=False))
        pick.add(int(np.argmax([s.frames for s in self.specs])))
        self.pick = pick
        self.watch_slots = len(pick)
        self.window_rids = []
        self.closed_flag = False
        self.t0 = None
        self.i = 0
        self.w0 = None

    def warm(self, now: float) -> bool:
        """First a burst of requests run to their end (kernels built, the
        step graph captured), then the warm-up stretch at the mix's rate."""
        if self.prime:
            for spec in self.prime:
                self.run.enqueue(spec, now)
            self.prime = []
            return True
        if self.w0 is None:
            if self.run.outstanding:
                return True
            self.w0, self.i = now, 0
        while self.i < len(self.warm_specs) and self.w0 + self.warm_due[self.i] <= now:
            self.run.enqueue(self.warm_specs[self.i], self.w0 + self.warm_due[self.i])
            self.i += 1
        return now - self.w0 < self.mix["warmup_s"]

    def start(self, t0: float) -> None:
        self.t0, self.i = t0, 0

    def feed(self, now: float) -> None:
        while self.i < self.n and self.t0 + self.due[self.i] <= now:
            spec, due = self.specs[self.i], self.t0 + self.due[self.i]
            self.run.enqueue(spec, due)
            self.run.lateness.append(now - due)
            if self.i in self.pick:
                self.run.keep_pcm.add(spec.rid)
                self.run.watch(spec.rid)
            self.window_rids.append(spec.rid)
            self.i += 1

    def close(self, now: float) -> None:
        self.feed(now)
        self.closed_flag = True

    def sample_rids(self):
        return sorted(self.window_rids[i] for i in self.pick if i < len(self.window_rids))

    def next_due(self):
        if self.t0 is None:
            i, base, due = self.i, self.w0, self.warm_due
        else:
            i, base, due = self.i, self.t0, self.due
        return base + due[i] if i < len(due) else None
