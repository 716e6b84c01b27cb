"""The harness's arithmetic against hand counts: percentiles, gaps and
rates from chunk landings (a stall inside the window included), the busy
union, the roofline and FLOP counts."""

import collections
import math
import types

import numpy as np
import pytest
import torch

import tiny
from benchmark import roofline, serving, trace


def _run(land, due):
    r = serving.ServeRun.__new__(serving.ServeRun)
    r.land = collections.defaultdict(list, land)
    r.specs = {rid: serving.Spec(0, None, 0, None, 50) for rid in land}
    for rid, t in due.items():
        r.specs[rid].due = t
    return r


def test_gaps_rate_and_first_audio_with_a_stall():
    # stream 0 lands a chunk every 10 ms, then stalls 500 ms, then 2 more
    t = [0.01 * i for i in range(1, 11)] + [0.6, 0.61]
    run = _run({0: [(x, i + 1) for i, x in enumerate(t)], 1: [(0.2, 3), (0.7, 5)]},
               {0: 0.0, 1: 0.15})
    chunks, gaps, deliv = run.landed_in(0.0, 0.65)
    assert chunks == 12 + 3
    assert sorted(gaps) == pytest.approx(sorted([0.01] * 9 + [0.5, 0.01])) 
    assert deliv[0] == (50, 0, 1)
    assert serving.p95(gaps) == pytest.approx(np.percentile(gaps, 95))
    assert serving.p95(gaps) > 0.2          # the stall reaches the tail
    fa = run.first_audio([0, 1])
    assert fa == pytest.approx([0.01, 0.05])
    assert math.isinf(_run({2: []}, {2: 0.0}).first_audio([2])[0])


def test_busy_union_against_a_hand_count():
    assert trace.busy_union([(0, 10), (5, 12), (20, 25), (24, 26), (30, 31)]) == 12 + 6 + 1
    assert trace.busy_union([]) == 0


def test_pairs_against_brute_force():
    for T, ctx in [(7, 3), (20, 250), (300, 250)]:
        brute = sum(1 for q in range(T) for k in range(T) if 0 <= q - k < ctx)
        assert roofline.window_pairs(2, T, ctx) == 2 * brute
    assert roofline.causal_pairs([3, 5]) == 6 + 15


def test_attention_bound_hand_count():
    b = roofline.attention_bound("bf16", 1, 10, 2, 4, roofline.causal_pairs([10]), 2, 10)
    assert b["bytes"] == (10 * 4 + 10) * 2 * 4 * 2
    assert b["flops"] == 4 * 4 * 2 * 55
    assert b["bound_s"] == pytest.approx(b["bytes"] / 3.35e12)


def test_model_flops_against_a_hand_count():
    f, m = tiny.FLOWLM, tiny.MIMI
    d, h, L = f["d_model"], f["hidden"], f["num_layers"]
    per_pos = L * 2 * (4 * d * d + 2 * d * h)
    assert roofline.flowlm_prefill_flops(f, [3]) == 3 * per_pos + 4 * 8 * 2 * 6 * L
    fd, lat, tf = f["flow_dim"], f["latent_dim"], f["time_freqs"]
    flow = 2 * (lat * fd + d * fd + 2 * (2 * tf * fd + fd * fd) + 2 * 5 * fd * fd
                + 2 * fd * fd + fd * lat)
    assert roofline.flow_net_flops(f) == flow
    assert roofline.flowlm_frame_flops(f, 4) == 2 * lat * d + per_pos + 4 * 8 * 2 * 4 * L \
        + 2 * d + flow


def test_stream_flops_is_the_sum_of_frames():
    f, m = tiny.FLOWLM, tiny.MIMI
    for a, z in [(0, 1), (0, 9), (3, 20), (5, 5)]:
        assert roofline.stream_flops(f, m, 7, a, z) == sum(
            roofline.stream_frame_flops(f, m, 7, fr) for fr in range(a, z))


def test_b1_bound_counts_every_layer():
    # two prompts of 3 and 5 columns, 2 heads of 4, 3 layers, f32: per layer
    # and prompt q, k, v read and out, the rotated k written in n rows
    f = dict(num_heads=2, head_dim=4, num_layers=3)
    by_hand = 3 * sum(5 * n * 2 * 4 * 4 / 3.35e12 for n in (3, 5))
    assert roofline.b1_bound_s("f32", f, [3, 5]) == pytest.approx(by_hand)
    one = roofline.b1_bound_s("f32", dict(f, num_layers=1), [3, 5])
    assert roofline.b1_bound_s("f32", f, [3, 5]) == pytest.approx(3 * one)


def shard(rows, device="cpu", latent=4):
    """What FrameTap.bind reads of a pool shard: its KV cache, rows, device."""
    cache = types.SimpleNamespace(k=torch.zeros(1, rows, 2, latent))
    return types.SimpleNamespace(cache=cache, rows=rows, device=torch.device(device))


def test_frame_tap_finds_a_request_whose_first_noise_another_shares():
    from benchmark.system import FrameTap
    L, rows = 4, 3
    tap = FrameTap(L, 2, 8)
    sh = shard(rows)
    tap.bind([sh])
    # a and b share their first two noise values; c is not watched
    noise_a = np.array([[0.5, 0.25, 1, 0], [1.0, 2.0, 0, 0], [3.0, 4.0, 0, 0]], np.float32)
    noise_b = np.array([[0.5, 0.25, 2, 0], [7.0, 8.0, 0, 0]], np.float32)
    noise_c = np.array([[0.5, 0.25, 3, 0], [5.0, 6.0, 0, 0], [9.0, 9.0, 0, 0]], np.float32)
    assert tap.watch_request("a", noise_a) and tap.watch_request("b", noise_b)
    assert not tap.watch_request("d", noise_c)
    # rows: 0 serves b from the first frame, then c; 1 serves c, then a; 2 is idle
    plan = [{0: ("b", 0), 1: ("c", 0)}, {0: ("b", 1), 1: ("c", 1)},
            {0: ("c", 0), 1: ("c", 2)}, {0: ("c", 1), 1: ("a", 0)},
            {1: ("a", 1)}, {1: ("a", 2)}]
    noises = {"a": noise_a, "b": noise_b, "c": noise_c}
    for step in plan:
        fi = torch.zeros(rows, dtype=torch.long)
        done = torch.ones(rows, dtype=torch.bool)
        noise = torch.zeros(rows, L)
        scaled = torch.zeros(rows, L)
        for row, (name, f) in step.items():
            fi[row], done[row] = f, False
            noise[row] = torch.from_numpy(noises[name][f])
            scaled[row] = {"a": 20.0, "b": 10.0, "c": 30.0}[name] + f
        tap.record(sh.cache, scaled, torch.zeros(rows), fi, done, noise)
    got = tap.find([{"key": "a", "frames": 3}, {"key": "b", "frames": 2},
                    {"key": "b", "frames": 3}])
    assert got["a"]["scaled"][:, 0].tolist() == [20.0, 21.0, 22.0]
    assert got["b"]["scaled"][:, 0].tolist() == [10.0, 11.0]
    assert torch.equal(got["a"]["noise2"], torch.from_numpy(noise_a[:, :2]))
    assert tap.find([{"key": "b", "frames": 3}]) == {}     # frame 2 of b never ran


def test_frame_tap_keeps_a_row_map_per_shard_of_one_device():
    """Two shards on one device number their rows alike: row 0 of one
    serves a watched request while row 0 of the other serves another; each
    shard's frames go to its own request."""
    from benchmark.system import FrameTap
    L = 4
    tap = FrameTap(L, 2, 8)
    a, b = shard(2), shard(2)
    tap.bind([a, b])
    assert len(tap.buf) == 2 and len(tap.row_slot) == 2
    noise_a = np.array([[1.0, 0, 0, 0], [2.0, 0, 0, 0]], np.float32)
    noise_c = np.array([[3.0, 0, 0, 0], [4.0, 0, 0, 0], [5.0, 0, 0, 0]], np.float32)
    assert tap.watch_request("a", noise_a)
    for f in range(3):
        for sh, noise, base in ((a, noise_a, 10.0), (b, noise_c, 30.0)):
            live = f < noise.shape[0]
            row = torch.from_numpy(noise[min(f, noise.shape[0] - 1)])
            tap.record(sh.cache, torch.full((2, L), base + f), torch.zeros(2),
                       torch.tensor([f, 0]), torch.tensor([not live, True]),
                       torch.stack([row, torch.zeros(L)]))
    got = tap.find([{"key": "a", "frames": 2}])
    assert got["a"]["scaled"][:, 0].tolist() == [10.0, 11.0]
    assert got["a"]["shard"] == 0 and got["a"]["device"] == "cpu"
