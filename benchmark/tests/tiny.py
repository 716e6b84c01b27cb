"""Tiny configurations and mixes: the cells' code paths at a size the CPU
runs in seconds (the tests only; the cells run at the published widths)."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

FLOWLM = dict(vocab=64, text_dim=16, d_model=16, num_heads=2, head_dim=8, num_layers=2,
              hidden=32, latent_dim=8, flow_dim=16, flow_depth=2, time_freqs=8,
              max_period=10000.0, ln_eps=1e-5, flow_ln_eps=1e-6, rms_eps=1e-5)
MIMI = dict(latent_dim=8, d_model=16, num_heads=2, head_dim=8, num_layers=1, hidden=32,
            context=8, max_period=10000.0, ln_eps=1e-5, upsample_kernel=4, upsample_stride=2,
            n_filters=4, ratios=[2, 2], kernel_size=3, last_kernel_size=3, residual_kernel=3,
            compress=2)


def cfg(dtype="f32"):
    c = json.load(open(os.path.join(BENCH, "configs", f"pocket-tts-{dtype}.json")))
    c.update(flowlm=dict(FLOWLM), mimi=dict(MIMI))
    c["assumed"] = dict(c["assumed"], weight_scale=0.3, voice_frames=4, voice_scale=0.3)
    return c


def mix(name):
    m = copy.deepcopy(json.load(open(os.path.join(BENCH, "traffic", f"{name}.json"))))
    if m["kind"] == "open_loop_serve":
        m.update(rate_rps=30.0, frames=dict(m["frames"], lo=3, hi=12), ids_min=1, ids_max=4,
                 warmup_s=0.3, drain_s=20.0, prime=4)
        m["batcher"].update(slots=4, admit_chunk=2, prefix_budget=16, max_len=32)
        m["check"] = {"sample": 3}
        m["trace"] = {"start_frac": 0.5, "steps": 3}
    elif m["kind"] == "closed_loop_serve":
        # a pool over cards keeps its 4 slots and its admit group per card
        cards = m["batcher"].get("cards", 1)
        m.update(frames=dict(m["frames"], lo=6, hi=20), ids_min=2, ids_max=5,
                 backlog=6 * cards, warmup_steps=6, drain_s=20.0)
        m["batcher"].update(slots=4 * cards, admit_chunk=2, prefix_budget=16, max_len=40,
                            frames_per_step=4)
        m["check"] = ({"per_shard": 1, "pool": 6 * cards} if "per_shard" in m["check"]
                      else {"sample": 2, "pool": 6})
        m["trace"] = {"start_frac": 0.5, "steps": 2}
    else:
        m.update(texts=8, words={"lo": 2, "hi": 5}, length_buckets=2)
        m["check"] = {"sample": 3}
    return m


LIMITS = {"lat_gap": 1e-3, "eos_gap": 1e-3, "pcm_gap": 1e-3, "missing": 0, "frames_bad": 0,
          "noise_bad": 0}
