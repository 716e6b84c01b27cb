"""Closed-loop serving traffic above the knee: the queue is topped up
before every step to the mix's backlog (at least the pool's slots plus an
admit group), so the pool never waits for work and the rate completed is
what is measured.

Request sizes cycle through one stratified set of the mix's distribution,
in an order drawn from the seed. The warm-up runs a fixed number of steps
of the same traffic, long enough that every k-frame step graph of the pool
(K, and 1 and K - 1 for admitting steps) is captured. The window's requests
are those admitted in it; at the close the backlog still queued is
dropped and the admitted requests run to their end. Admission is first in,
first out, so the window's first requests, among which the check draws
its sample, are known while they are queued: the frame tap watches them.
"""

from __future__ import annotations

import numpy as np

from ..serving import drive as serve_drive, frames_inv, request_spec, stratified


def drive(cell) -> dict:
    return serve_drive(cell, Feeder)


class Feeder:
    POOL = 512

    def __init__(self, run, mix: dict, cfg: dict, seed: int, seconds: float):
        self.run, self.mix, self.cfg, self.seed = run, mix, cfg, seed
        self.sizes = stratified(self.POOL, seed, 1, frames_inv(mix))
        self.k = 0
        self.warm_steps = 0
        self.window_rids = []
        rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, 4])
        self.P = mix["check"]["pool"]
        self.per_shard = mix["check"].get("per_shard")
        self.pick = (set() if self.per_shard else
                     set(rng.choice(self.P, size=min(mix["check"]["sample"], self.P),
                                    replace=False)))
        self.rng = rng
        self.n_shards = len(run.b.shards)
        self.unsampled = 0         # draws per shard that a shard had no request for
        self.watch_slots = self.P
        self.watched = None        # from start(): the window's first P requests, in order
        self.closed_flag = False

    def _enqueue_next(self, now: float) -> None:
        spec = request_spec(self.mix, self.cfg, self.seed, 3, self.k,
                            int(self.sizes[self.k % self.POOL]), self.run.system.dtype)
        self.k += 1
        self.run.enqueue(spec, now)
        self._watch(spec.rid)

    def _watch(self, rid: int) -> None:
        if self.watched is not None and len(self.watched) < self.P:
            self.watched.append(rid)
            self.run.watch(rid)

    def _top_up(self, now: float) -> None:
        while len(self.run.b.queue) < self.mix["backlog"]:
            self._enqueue_next(now)

    def warm(self, now: float) -> bool:
        self._top_up(now)
        self.warm_steps += 1
        return self.warm_steps <= self.mix["warmup_steps"]

    def start(self, t0: float) -> None:
        self.watched = []
        for rid in list(self.run.fifo):
            self._watch(rid)
        self.run.on_admit = self._admitted

    def _admitted(self, rid: int) -> None:
        """The window's requests are those admitted in it; the first P keep
        their PCM for the check."""
        if len(self.window_rids) < self.P:
            self.run.keep_pcm.add(rid)
        self.window_rids.append(rid)

    def feed(self, now: float) -> None:
        self._top_up(now)

    def close(self, now: float) -> None:
        self.closed_flag = True
        self.run.on_admit = None
        self.run.cancel_queued()

    def next_due(self):
        return None

    def sample_rids(self):
        """The drawn positions among the window's first requests that were
        admitted, or with ``per_shard`` the draws from each shard's among
        them (with those the frame tap found on no shard); and the longest
        of those requests. Called once, after the drain."""
        first = self.window_rids[:self.P]
        if self.per_shard:
            specs = self.run.specs
            found = self.run.tap.find([{"key": r, "frames": specs[r].frames} for r in first])
            out = {r for r in first if r not in found}
            for s in range(self.n_shards):
                on = [r for r in first if r in found and found[r]["shard"] == s]
                take = min(self.per_shard, len(on))
                self.unsampled += self.per_shard - take
                out.update(on[i] for i in self.rng.choice(len(on), size=take, replace=False))
        else:
            out = {first[i] for i in self.pick if i < len(first)}
        if first:
            out.add(max(first, key=lambda r: self.run.specs[r].frames))
        return sorted(out)
