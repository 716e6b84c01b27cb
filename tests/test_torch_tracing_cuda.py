"""The tracer's part on the card: the marker kernels split every replayed
serving step in a profiled trace, and launches made inside a captured body
count at every replay.

Every test here needs a CUDA device and skips without one. The machine with
the card has no jax, so run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ptts_torch import api, synth  # noqa: E402
from ptts_torch.config import FlowLMConfig, MimiConfig  # noqa: E402
from ptts_torch.ops.cuda import fused_attention as fa  # noqa: E402
from ptts_torch.ops.cuda import markers  # noqa: E402
from ptts_torch.runtime import graphs  # noqa: E402
from ptts_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the marker kernels run only on the card")
    return torch.device("cuda")


def small_engine(tmp_path):
    fc = FlowLMConfig(vocab=60, text_dim=128, d_model=128, num_heads=2, head_dim=64,
                      num_layers=2, hidden=256, latent_dim=8, flow_dim=32, flow_depth=2,
                      time_freqs=8)
    mc = MimiConfig(latent_dim=8, d_model=128, num_heads=2, head_dim=64, num_layers=1,
                    hidden=256, n_filters=4, ratios=(3, 2))
    path = synth.write_model_dir(str(tmp_path / "model"), fc, mc, seed=2, scale=0.1)
    return api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cuda").engine


@pytest.mark.parametrize("k", [1, 4])
def test_markers_split_each_replayed_step(dev, tmp_path, monkeypatch, k):
    """In a profiled stretch of replayed batcher steps, the device runs
    ptts_mark_flowlm, ptts_mark_mimi, ptts_mark_end once per replay, in
    that order, with the step's kernels between them."""
    from ptts_torch.runtime.batching import ContinuousBatcher

    monkeypatch.setenv("PTTS_PROFILE_DIR", str(tmp_path / "prof"))
    eng = small_engine(tmp_path)
    b = ContinuousBatcher(eng, slots=4, admit_chunk=2, prefix_budget=64, max_len=120,
                          frames_per_step=k, split_admit=False)
    for i in range(4):
        b.submit(f"Request number {i}.", params=api.Params(seed=7, num_frames=40,
                                                           eos_enabled=False))
    for _ in range(4):               # warm-up, capture
        b.step()
    assert len(b._graphs) >= 1
    replays = graphs.STATS["replays"]
    with profiling.device_trace("markers", force=True) as d:
        for _ in range(3):
            b.step()
        torch.cuda.synchronize()
    n = graphs.STATS["replays"] - replays
    events = profiling.device_events(d)
    names = [str(e["name"]) for e in events]
    marks = [x for x in names if x.startswith("ptts_mark_")]
    assert n >= 3 and marks == list(markers.KERNELS) * n, marks
    first = names.index("ptts_mark_flowlm")
    mimi, end = names.index("ptts_mark_mimi", first), names.index("ptts_mark_end", first)
    assert first + 1 < mimi and mimi + 1 < end
    assert max(float(e["dur"]) for e in events if str(e["name"]).startswith("ptts_mark_")) < 50
    b.drain()


def test_captured_b2_counts_at_every_replay(dev):
    """A captured body that launches B2: its .launches and .shapes count
    one launch per call, eager, captured or replayed."""
    x = torch.randn(2, 64, 3 * 2 * 64, device=dev, dtype=torch.bfloat16)
    cache = graphs.GraphCache()
    w = fa.window_attention_qkv
    n0, s0 = w.launches, collections.Counter(w.shapes)

    def body():
        return w(x, num_heads=2, head_dim=64, context=16)

    outs = [cache.run("b2", dev, body).clone() for _ in range(graphs.WARMUP + 4)]
    torch.cuda.synchronize()
    calls = graphs.WARMUP + 4
    assert w.launches - n0 == calls
    assert w.shapes[("bf16", 2, 64)] - s0[("bf16", 2, 64)] == calls
    for o in outs[1:]:
        np.testing.assert_array_equal(o.float().cpu().numpy(), outs[0].float().cpu().numpy())


def test_marker_launches_on_the_card(dev):
    x = torch.zeros(1, device=dev)
    for which in (markers.FLOWLM, markers.MIMI, markers.END):
        markers.device_mark(which, x)
    torch.cuda.synchronize()
