"""The hybrid cell (granite4h-serve-long) driven end to end on the CPU at a
tiny size, with the cell's own limits: a sound run comes out correct and
reads the new counters; the fp8 control and each planted fault of the
hybrid's state come out not correct; its arithmetic counts what the
program holds. (The program keeps the SSM state in the served dtype, bf16:
on the card the check read a float32 state and a bf16 one alike, so a
bf16 state is no fault here.)"""

import json
import os
import time

import pytest
import torch

import tiny
from benchmark import check, hybrid as H
from benchmark.run import run_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "granite4h-serve-long"


def tiny_cfg(**over) -> dict:
    """The cell's configuration at tiny widths: three layers, Mamba,
    attention, Mamba, with the published multipliers and Mamba init."""
    c = json.load(open(os.path.join(BENCH, "configs", "pocket-tts-granite4h-bf16.json")))
    c.update(hidden_size=32, num_attention_heads=4, num_key_value_heads=2,
             shared_intermediate_size=48, intermediate_size=48, mamba_n_heads=4, mamba_d_head=16,
             mamba_d_state=8, mamba_chunk_size=8, vocab_size=64, num_hidden_layers=3,
             layer_types=["mamba", "attention", "mamba"], dtype="f32")
    c["flowlm"] = {k: tiny.FLOWLM[k] for k in c["flowlm"]}
    c["mimi"] = dict(tiny.MIMI)
    c["assumed"] = dict(c["assumed"], weight_scale=0.3, voice_frames=4, voice_scale=0.3)
    c.update(over)
    return c


def tiny_mix() -> dict:
    m = json.load(open(os.path.join(BENCH, "traffic", "serve-long-saturated-granite4h.json")))
    base = tiny.mix("serve-long-saturated")
    base["kind"] = m["kind"]
    return base


def _run(cfg=None, trace=False, controls=(), seed=20250):
    torch.set_num_threads(2)
    return run_cell(CELL, seed, 1.0, trace, device="cpu", cfg=cfg or tiny_cfg(), mix=tiny_mix(),
                    limits=check.limits(CELL), controls=controls, t_process=time.perf_counter())


def test_mix_is_cell_three_traffic_on_the_hybrid():
    m = json.load(open(os.path.join(BENCH, "traffic", "serve-long-saturated-granite4h.json")))
    base = json.load(open(os.path.join(BENCH, "traffic", "serve-long-saturated.json")))
    assert m["kind"] == "hybrid_closed_loop_serve"
    assert {k: v for k, v in m.items() if k not in ("kind", "why")} == {
        k: v for k, v in base.items() if k not in ("kind", "why")}


def test_sound_run_is_correct_and_the_fp8_control_is_not():
    out = _run(controls=("fp8",))
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    ok, rows = check.decide(dict(out["readings"]["program"], **out["readings"]["fp8"]),
                            check.limits(CELL))
    assert not ok, rows
    info = out["info"]
    assert info["ssm_state_bytes"] == info["ssm_state_bytes_counted"] > 0
    assert info["ssm_state_resets"] > 0
    assert set(out["metrics"]) == {"audio_s_per_s", "chunk_gap_p95_ms", "setup_s"}


def _skip_one_mamba_layer(monkeypatch):
    from ptts_torch.models import hybrid
    orig = hybrid.mamba_step

    def mamba_step(mw, j, u, *a, **k):
        out = orig(mw, j, u, *a, **k)
        return torch.zeros_like(out) if j == 1 else out
    monkeypatch.setattr(hybrid, "mamba_step", mamba_step)


def _state_not_overwritten(monkeypatch):
    from ptts_torch.models import hybrid
    orig = hybrid.write_state

    def write_state(cache, rows, state):
        if rows is None:                  # a whole-cache prefill still writes
            orig(cache, rows, state)
    monkeypatch.setattr(hybrid, "write_state", write_state)


def _conv_state_dropped(monkeypatch):
    from ptts_torch.models import hybrid
    orig = hybrid.mamba_step

    def mamba_step(mw, j, u, ssm, conv, *a, **k):
        conv.zero_()
        return orig(mw, j, u, ssm, conv, *a, **k)
    monkeypatch.setattr(hybrid, "mamba_step", mamba_step)


@pytest.mark.parametrize("fault", [_skip_one_mamba_layer, _state_not_overwritten,
                                   _conv_state_dropped],
                         ids=["mamba_layer_skipped", "state_not_overwritten",
                              "conv_state_dropped"])
def test_broken_hybrid_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["check"]


def test_traced_run_reads_the_host_metric():
    out = _run(trace=True)
    assert out["correct"]
    assert "model.hybrid_mfu_pct" in out["metrics"]
    # the marker metrics read the device trace, which the CPU has not
    assert set(out["info"]["per_layer_missing"]) == {"step.ssm_device_ms_per_frame",
                                                     "step.ssm_roofline_pct"}


def test_a_port_without_the_backbone_is_refused_before_any_weight(monkeypatch):
    from benchmark import hybrid

    made = []
    monkeypatch.setattr(hybrid, "make_weights", lambda *a, **k: made.append(1))
    from ptts_torch import config
    fields = {f for f in config.FlowLMConfig.__dataclass_fields__ if f != "layer_types"}

    def old_config(**kw):
        unknown = set(kw) - fields
        if unknown:
            raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
    monkeypatch.setattr(config, "FlowLMConfig", old_config)
    with pytest.raises(TypeError):
        _run()
    assert not made


def test_arithmetic_at_the_published_widths():
    cfg = H.expand(json.load(open(os.path.join(BENCH, "configs",
                                               "pocket-tts-granite4h-bf16.json"))))
    f = cfg["flowlm"]
    assert f["layer_types"] == ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
    backbone = H.n_params(cfg) - H.n_params(dict(cfg, flowlm=dict(f, layer_types=[])))
    assert 745e6 < backbone < 747e6
    # 257 pool rows: 9 layers of a [64, 64, 128] state and a 3 x 4352 window, all bf16
    assert H.state_bytes(f, 257, "bf16") == 9 * 257 * (64 * 64 * 128 + 3 * 4352) * 2
    io = (4096 + 4352 + 64 + 4096) * 2
    assert H.ssm_bytes_per_frame(f, 257, "bf16") == (2 * H.state_bytes(f, 257, "bf16")
                                                     + 9 * 257 * io)
    # 2 operations per matrix weight and conv tap, and per Mamba layer the
    # state's update and read-out (4 H P N)
    taps = backbone - 9 * (4352 + 3 * 64 + 4096) - 10 * 2 * 2048
    assert H.backbone_position_flops(f) == 2 * taps + 9 * (4 * 64 * 64 * 128)


def test_spec_names_are_the_loaders():
    """Every name the spec makes is one the program's loader reads."""
    from ptts_torch.models import flowlm
    cfg = H.expand(tiny_cfg())
    w = H.make_weights(cfg, 7, "cpu")
    fcfg, _ = H.model_configs(cfg)
    read = set()

    class Ckpt:
        tensors = []

        def find(self, name):
            read.add(name)
            return name if name in w else None

        def get_f32(self, t):
            return w[t].numpy()

    flowlm.load_weights(Ckpt(), fcfg)
    flow_names = {n for n, _, _ in H.flowlm_spec(cfg["flowlm"])}
    assert flow_names <= read
