"""Traffic made from a seed: the same seed gives the same requests, and
every seed the same set of sizes and gaps in another order."""

import numpy as np
import pytest
import torch

import tiny
from benchmark import serving
from benchmark.traffic import offline_batch, open_loop_serve


class _Run:
    def __init__(self):
        self.system = type("S", (), {"dtype": torch.bfloat16})()
        self.enqueued = []

    def enqueue(self, spec, due):
        self.enqueued.append(spec)


def _open(seed):
    mix = tiny.mix("serve-short-open")
    return open_loop_serve.Feeder(_Run(), mix, tiny.cfg("bf16"), seed, 2.0)


def test_open_loop_repeats_from_its_seed():
    a, b = _open(2**33 + 5), _open(2**33 + 5)
    assert np.array_equal(a.due, b.due)
    for x, y in zip(a.specs, b.specs):
        assert x.frames == y.frames and x.voice == y.voice
        assert np.array_equal(x.ids, y.ids) and np.array_equal(x.noise, y.noise)


def test_open_loop_seeds_reorder_the_same_work():
    a, b = _open(11), _open(12)
    assert sorted(s.frames for s in a.specs) == sorted(s.frames for s in b.specs)
    assert np.allclose(np.sort(np.diff(np.r_[0, a.due])), np.sort(np.diff(np.r_[0, b.due])))
    assert [s.frames for s in a.specs] != [s.frames for s in b.specs]


def test_request_noise_is_in_the_served_dtype():
    spec = serving.request_spec(tiny.mix("serve-short-open"), tiny.cfg("bf16"), 3, 1, 0, 9,
                                torch.bfloat16)
    assert np.array_equal(torch.from_numpy(spec.noise).to(torch.bfloat16).float().numpy(),
                          spec.noise)
    assert spec.noise.shape == (9, tiny.FLOWLM["latent_dim"])


@pytest.mark.parametrize("dist,lo,hi", [("log_uniform", 12, 62), ("uniform", 150, 375)])
def test_stratified_sizes_cover_the_range(dist, lo, hi):
    inv = serving.frames_inv({"frames": {"dist": dist, "lo": lo, "hi": hi}})
    v = serving.stratified(256, 7, 1, inv)
    assert v.min() >= lo and v.max() <= hi and v.max() - v.min() > (hi - lo) * 0.9


def test_offline_passes_share_shapes():
    mix = tiny.mix("offline-long-batch")
    run = offline_batch.OfflineRun(None, mix, tiny.cfg(), 99, 1.0, False, None)
    a, b = run.texts(0), run.texts(1)
    assert a != b
    assert sorted(len(t.split()) for t in a) == sorted(len(t.split()) for t in b)
    assert sorted(len(t) for t in a) == sorted(len(t) for t in b)
    assert run.texts(0) == offline_batch.OfflineRun(None, mix, tiny.cfg(), 99, 1.0, False,
                                                    None).texts(0)
