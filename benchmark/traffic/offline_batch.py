"""Offline batch traffic: the engine's batch entry (``TTSEngine.
batch_generate``) run pass after pass in a closed loop, each pass a batch
of texts rendered whole, EOS off, each utterance at the engine's own frame
budget for its word count.

Every pass holds the same set of word counts (stratified over the mix's
range) and, per utterance, the same set of word lengths, in orders and
with letters drawn from the seed and the pass: so every pass, and every
seed, has the same prompt lengths and frame budgets, and the engine's
length groups the same shapes, which one warm-up pass covers. The window
runs whole passes: it ends with the first pass that ends at or after
``seconds``, and the rate is the audio of its passes over its length.
``drive`` is the kind's whole run, with the numbers ``correct`` reads.
"""

from __future__ import annotations

import gc
import shutil
import string
import tempfile
import time
from typing import List

import numpy as np
import torch

from .. import check, roofline, system as S
from ..reference import text as rtext
from ..serving import stratified
from ..trace import SubWindow
from ..weights import tokenizer_pieces


WARM_PASS = 10 ** 6   # the warm-up pass's index: its own texts and noise


def _mix_seed(seed: int, *k) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFFFFFF, *k])


class OfflineRun:
    def __init__(self, system, mix: dict, cfg: dict, seed: int, seconds: float, trace: bool,
                 tap):
        self.system, self.mix, self.cfg, self.seed = system, mix, cfg, seed
        self.seconds, self.trace, self.tap = seconds, trace, tap
        n = mix["texts"]
        lo, hi = mix["words"]["lo"], mix["words"]["hi"]
        self.words = lambda p: stratified(
            n, seed, 1000 + p, lambda u: np.floor(lo + u * (hi - lo + 1)).astype(int))
        self.passes: List[dict] = []

    def texts(self, p: int) -> List[str]:
        out = []
        for u, w in enumerate(self.words(p)):
            rng = _mix_seed(self.seed, 2, p, u)
            lens = rng.permutation([1 + j % self.mix["word_letters"] for j in range(w)])
            letters = string.ascii_lowercase
            out.append(" ".join("".join(letters[i] for i in rng.integers(0, 26, size=L))
                                for L in lens))
        return out

    def pass_seed(self, p: int) -> int:
        return int(_mix_seed(self.seed, 3, p).integers(1, 2 ** 31 - 1024))

    def one_pass(self, p: int):
        from ptts_torch.api import Params

        texts = self.texts(p)
        params = Params(seed=self.pass_seed(p), temp=float(self.mix["temp"]),
                        eos_enabled=False, num_steps=1)
        t0 = time.perf_counter()
        audio = self.system.engine.batch_generate(texts, params=params,
                                                  length_buckets=self.mix["length_buckets"])
        if self.system.device.type == "cuda":
            torch.cuda.synchronize()
        return texts, audio, t0, time.perf_counter()

    def run(self) -> dict:
        self.one_pass(WARM_PASS)                      # warm-up: every shape of a pass
        pick = set(_mix_seed(self.seed, 4).choice(self.mix["texts"],
                                                  size=self.mix["check"]["sample"],
                                                  replace=False).tolist())
        self.tap.keep = True
        t_start = time.perf_counter()
        self.t_start = t_start
        p = 0
        while True:
            self.tap.calls.clear()
            texts, audio, a, z = self.one_pass(p)
            words = self.words(p)
            keep = pick | {int(np.argmax(words))}
            self.passes.append({"p": p, "texts": texts, "t0": a, "t1": z,
                                "samples": [len(x.samples) for x in audio],
                                "audio": {u: audio[u].samples for u in keep},
                                "calls": list(self.tap.calls)})
            p += 1
            if z - t_start >= self.seconds:
                break
        self.tap.keep = False
        self.t_end = self.passes[-1]["t1"]
        sub = None
        if self.trace:
            sub = self._traced_group(p)
        return {"sub": sub}

    def _traced_group(self, p: int):
        """Profile one length group of one more pass: from its frame loop's
        call to the next group's."""
        from ptts_torch.ops.cuda import fused_attention as fa

        sub = SubWindow()
        state = {"calls": 0}
        orig = self.system.engine.generate_latents_batch
        before = {}

        def finish():
            sub.stop()
            after = fa.window_attention_qkv.shapes
            self.b2_shapes = {key[1:]: after[key] - before.get(key, 0)
                              for key in after if after[key] > before.get(key, 0)}

        def hooked(*a, **k):
            state["calls"] += 1
            if state["calls"] == 1:
                before.update(fa.window_attention_qkv.shapes)
                sub.start()
            elif state["calls"] == 2:
                finish()
            with torch.profiler.record_function("bench.frame_loop"):
                return orig(*a, **k)

        self.system.engine.generate_latents_batch = hooked
        try:
            self.one_pass(p)
        finally:
            self.system.engine.generate_latents_batch = orig
        if sub.prof is not None:
            finish()
        return sub

    def audio_seconds(self) -> float:
        fs = self.system.engine.mimi_cfg.sample_rate
        return sum(sum(ps["samples"]) for ps in self.passes) / fs


def drive(cell) -> dict:
    """The offline kind's run (see traffic/__init__.py): the engine over the
    system built from the seed, its text path's files written under TMPDIR,
    passes through the window, and the numbers of the check."""
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    on_card = dev.type == "cuda"
    text_dir = tempfile.mkdtemp(prefix="bench_text_")
    try:
        sysm = S.build(cfg, cell.seed, dev, 1, text_dir)
        tap = S.OfflineTap(sysm.engine)
        orun = OfflineRun(sysm, mix, cfg, cell.seed, cell.seconds, cell.trace, tap)
        res = orun.run()
        t_start, t_end = orun.t_start, orun.t_end
        peaks = [torch.cuda.max_memory_allocated()] if on_card else [0]
        for ps in orun.passes:
            for call in ps["calls"]:
                for k in ("latents", "eos", "frames"):
                    call[k] = call[k].cpu()
        audio_s = orun.audio_seconds()
        pieces = tokenizer_pieces()
        flops = 0
        for ps in orun.passes:
            for text in ps["texts"]:
                prepared, words = rtext.prepare_text(text)
                plen = cfg["assumed"]["voice_frames"] + len(rtext.tokenize(prepared, pieces)) + 1
                flops += roofline.stream_flops(cfg["flowlm"], cfg["mimi"], plen, 0,
                                               rtext.frame_budget(words))
        obs = dict(sub=res["sub"], b2_shapes=getattr(orun, "b2_shapes", None),
                   delivered_flops=flops, flops_window_s=t_end - t_start)
        info = dict(passes=len(orun.passes), audio_s=audio_s, window_s=t_end - t_start,
                    pass_s=[ps["t1"] - ps["t0"] for ps in orun.passes])
        sysm.engine = None
        del tap
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        numbers = readings(orun, sysm, cell.controls)
        return dict(t_start=t_start, e2e={"audio_s_per_s": audio_s / (t_end - t_start)},
                    obs=obs, info=info, peaks=peaks,
                    attempted=sum(len(ps["texts"]) for ps in orun.passes),
                    failed=numbers["program"]["frames_bad"], numbers=numbers)
    finally:
        shutil.rmtree(text_dir, ignore_errors=True)


def readings(orun, system, controls=()) -> dict:
    """The offline cell's numbers (check.py) over one pass of the window,
    drawn from the seed; frame counts over every pass."""
    cfg = system.cfg
    fs = check.frame_samples(cfg)
    pieces = tokenizer_pieces()
    counts = {"missing": 0, "frames_bad": 0, "noise_bad": 0}
    for ps in orun.passes:
        for u, text in enumerate(ps["texts"]):
            words = rtext.prepare_text(text)[1]
            if ps["samples"][u] != rtext.frame_budget(words) * fs:
                counts["frames_bad"] += 1
    refs, out = check.references(system, cfg, controls)
    rng = np.random.default_rng([orun.seed & 0xFFFFFFFFFFFF, 5])
    ps = orun.passes[int(rng.integers(len(orun.passes)))]
    seed0 = orun.pass_seed(ps["p"])
    voice = system.voices[0]
    for u, pcm_p in sorted(ps["audio"].items()):
        prepared, words = rtext.prepare_text(ps["texts"][u])
        F = rtext.frame_budget(words)
        noise = rtext.frame_noise([seed0 + u], F, cfg["flowlm"]["latent_dim"],
                                  float(orun.mix["temp"]))[0]
        hit = None
        for call in ps["calls"]:
            fp = call["noise"][:, 0, :4]
            rows = np.nonzero(np.all(np.isclose(fp, noise[0, :4], rtol=1e-5, atol=1e-6),
                                     axis=1))[0]
            if rows.size:
                hit = (call, int(rows[0]))
                break
        if hit is None:
            counts["missing"] += 1
            continue
        call, j = hit
        if int(call["frames"][j]) != F:
            counts["frames_bad"] += 1
            continue
        ref = refs["f32"]
        raw = call["latents"][j, :F].to(ref.device)
        prompt = ref.prompt(rtext.tokenize(prepared, pieces), voice)
        check.judge(refs, prompt, torch.from_numpy(noise), ref.scale(raw), call["eos"][j, :F],
                    pcm_p, fs, False, out)
    return check.numbers(out, counts)
