"""The port's tools (ptts_torch/tools/{sanitize,flowlm_parity,hello_world_test,
bench_batcher_sweep,bench_batch_sweep}.py) against the JAX package's
(tools/*.py), CPU.

- sanitize: phases 2-4 pass at the tiny configs; phases 3-4 give the JAX
  tool's verdicts on the same directory; the NaN trap names the operation
  that made a NaN planted in an activation (and passes without the plant)
  and ignores ``empty``; phase 1's slab check catches a stand-in kernel
  that writes one element past ``out`` or before ``sin``, or reads the
  element before ``qkv``, and passes a correct one; every band keeps 256-byte alignment.
- flowlm_parity: the port's run_ours against the JAX tool's on one tiny
  directory at temp 0, within 1e-4 of the largest value (f32 summation
  order, as in test_torch_slice.py); a self-compare reads 0; exit codes 0,
  1 and 77.
- committed data (tests/data/jax_golden/, the JAX package's full-width
  --flow-test dumps of ``ptts_torch.synth.write_model_dir(dir, seed=0)``):
  the checkpoint hashes to meta.json; the port on the CPU matches the
  dumps at the card's gates (latents 1e-3, cond and flow 1e-4 of max, the
  WAV within 33 LSB); the JAX package regenerates them bit for bit. The
  dumps are written by ``write_jax_golden`` below:

      python tests/test_torch_tools.py --write-golden

- hello_world_test: compare/gates_pass equal the JAX tool's to 1e-12; exit
  77 without assets in a process where neither ptts_tpu nor jax imports.
- the sweeps: grid, rows and best with the bench functions stubbed; a
  failing point fails the run.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import helpers  # noqa: E402
from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch import bench, synth  # noqa: E402
from ptts_torch import cli as tcli  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.ops import attention as tattn  # noqa: E402
from ptts_torch.ops.cuda import build  # noqa: E402
from ptts_torch.ops.cuda import fused_attention as fa  # noqa: E402
from ptts_torch.runtime.engine import TTSEngine  # noqa: E402
from ptts_torch.tools import bench_batch_sweep, bench_batcher_sweep  # noqa: E402
from ptts_torch.tools import flowlm_parity as tpar  # noqa: E402
from ptts_torch.tools import hello_world_test as thw  # noqa: E402
from ptts_torch.tools import sanitize as tsan  # noqa: E402
from ptts_tpu import api as japi  # noqa: E402
from ptts_tpu import cli as jcli  # noqa: E402
from ptts_tpu.models import flowlm as jfl  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "data", "jax_golden")
GOLDEN_FILES = ("latents.f32", "cond.f32", "flow.f32", "mimi.wav")
GOLDEN_RUN = dict(prompt="Hello world!", frames=4, seed=123, temp=0)
KW = dict(flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI)


def jax_tool(name: str):
    """tools/<name>.py of the JAX package, loaded under a private name."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsan, jpar, jhw = jax_tool("sanitize"), jax_tool("flowlm_parity"), jax_tool("hello_world_test")


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("toolmodel"), seed=3)
    return path


@pytest.fixture
def tiny_clis(monkeypatch):
    """Both CLIs load the tiny configs (the port's on the CPU)."""
    monkeypatch.setattr(jcli.api, "load_dir", lambda d: japi.Context(d, **KW))
    monkeypatch.setattr(tcli.api, "load_dir",
                        lambda d, device="cuda": tapi.Context(d, device="cpu", **KW))


# -- sanitize ------------------------------------------------------------------------


def test_sanitize_tiny_configs_are_the_tests():
    # the port's FlowLMConfig also describes the hybrid backbone, which the
    # tests' (the JAX package's) config has not: the fields in common agree
    want = dataclasses.asdict(TINY_FLOWLM)
    got = dataclasses.asdict(tsan.TINY_FLOWLM)
    assert {k: v for k, v in got.items() if k in want} == want
    assert not tsan.TINY_FLOWLM.layer_types
    assert dataclasses.asdict(tsan.TINY_MIMI) == dataclasses.asdict(TINY_MIMI)


def test_sanitize_cpu_tiny_phases_2_to_4_pass(capsys):
    assert tsan.main(["--device", "cpu", "--tiny"]) == 0
    out = capsys.readouterr().out
    assert f"[sanitize] NOT RUN: {tsan.PHASES[0]}" in out
    for name in tsan.PHASES[1:]:
        assert f"[sanitize] PASS: {name}" in out
    assert "[sanitize] ALL PASS" in out


def test_sanitize_has_no_cpu_path_of_its_own(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tsan.main([]) != 0
    cap = capsys.readouterr()
    assert "no CUDA card is visible" in cap.err and "PASS" not in cap.out


def verdicts(out: str, names) -> dict:
    found = {}
    for line in out.splitlines():
        for name in names:
            for verdict in ("PASS", "FAIL"):
                if line.startswith(f"[sanitize] {verdict}: {name}"):
                    found[name] = verdict
    return found


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan_weight"])
def test_sanitize_verdicts_match_the_jax_tool(tmp_path, monkeypatch, capsys, poison):
    """Phases 3-4 of both tools on one directory: all pass on a clean
    checkpoint; with a NaN in out_norm_w, phase 3 fails in both and phase
    4 still names the weight."""
    fw = jfl.random_weights(TINY_FLOWLM, seed=3, scale=0.3)
    if poison:
        fw = dict(fw)
        fw["out_norm_w"] = np.array(fw["out_norm_w"], np.float32)
        fw["out_norm_w"][1] = np.nan
    path, _, _ = write_model_dir(tmp_path / "m", fw=fw, seed=3)
    names = tsan.PHASES[2:]
    monkeypatch.setattr(helpers, "write_model_dir", lambda p, seed: (path, None, None))
    jrc = jsan.main()
    jax_v = verdicts(capsys.readouterr().out, names)
    failures, _ = tsan.run_phases(path, "cpu", **KW)
    port_v = verdicts(capsys.readouterr().out, names)
    want = {names[0]: "FAIL" if poison else "PASS", names[1]: "PASS"}
    assert jax_v == port_v == want
    assert (jrc != 0) == bool(failures) == poison


@pytest.fixture
def tiny_engine(tiny_dir):
    ctx = tapi.Context(tiny_dir, device="cpu", **KW)
    yield TTSEngine(ctx, graphs=False)
    ctx.close()


@pytest.mark.parametrize("plant", [False, True], ids=["clean", "planted"])
def test_nan_trap_names_the_operation(tiny_engine, monkeypatch, plant):
    """A NaN planted in FlowLM's output norm (sqrt of a negative) is
    caught at the aten op that makes it, in a ptts_torch frame; the same
    run without the plant passes."""
    if plant:
        orig = tfl.layernorm
        monkeypatch.setattr(tfl, "layernorm",
                            lambda *a, **k: torch.sqrt(-orig(*a, **k).abs() - 1.0))
    p = tapi.Params(num_frames=3, seed=7, num_steps=1)
    if not plant:
        out = tsan.trapped_generate(tiny_engine, "Hello world", p)
        assert out["ops"] > 500
        return
    with pytest.raises(tsan.SanitizeError) as e:
        tsan.trapped_generate(tiny_engine, "Hello world", p)
    assert "aten.sqrt" in str(e.value)
    assert "ptts_torch/models/flowlm.py:" in str(e.value)


class NanAllocations(torch.utils._python_dispatch.TorchDispatchMode):
    """Every empty* allocation comes back filled with NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in tsan.UNINITIALISED:
            out.fill_(float("nan"))
        return out


def test_nan_trap_ignores_empty():
    ref = torch.ones(3)
    with NanAllocations(), tsan.NanTrap() as trap:
        xs = [torch.empty(4), torch.empty_like(ref), torch.empty_strided((2, 2), (2, 1)),
              ref.new_empty(5)]
        assert trap.ops == 0
        with pytest.raises(tsan.SanitizeError, match="aten.add"):
            torch.empty(4) + 1.0
    assert all(bool(torch.isnan(x).all()) for x in xs)


def test_nan_trap_checks_the_kernel_wrappers(monkeypatch):
    """The wrappers' ctypes launch is no aten op: their output is checked
    by the wrapper's name."""
    monkeypatch.setattr(fa, "causal_attention_qkv_plain",
                        lambda *a, **k: (torch.full((1,), float("nan")), torch.zeros(1)))
    qkv, lengths = torch.zeros(1, 2, 3 * 64), torch.full((1,), 2, dtype=torch.int32)
    with tsan.checked_wrappers() as calls:
        with pytest.raises(tsan.SanitizeError, match="kernel wrapper 'causal_attention_qkv'"):
            fa.causal_attention_qkv(qkv, lengths, num_heads=1, head_dim=64)
    assert calls["causal_attention_qkv"] == 1
    assert build.CHECK is None                                       # restored
    assert fa.causal_attention_qkv(qkv, lengths, num_heads=1, head_dim=64)[0].isnan().all()


def test_checked_wrappers_cover_every_registered_kernel():
    """checked_wrappers lists no wrapper: it covers every one registered in
    ops/cuda/build, the hybrid's Mamba-2 frame step included, and names a
    NaN in ssm_step's plain output (a NaN D skip weight)."""
    from ptts_torch.ops.cuda import ssm_step as tss

    B, H, P, N = 2, 2, 4, 3
    C = H * P + 2 * N
    g = torch.Generator().manual_seed(0)
    xbc, dt = torch.randn(B, C, generator=g), torch.randn(B, H, generator=g)
    ssm, conv = torch.randn(B, H, P, N, generator=g), torch.randn(B, 3, C, generator=g)
    params = [torch.randn(C, 4, generator=g), torch.randn(C, generator=g),
              torch.zeros(H), torch.zeros(H), torch.tensor([1.0, float("nan")])]
    with tsan.checked_wrappers() as calls:
        assert set(calls) == set(build.WRAPPERS) >= {
            "causal_attention_qkv", "window_attention_qkv", "decode_attention", "ssm_step"}
        with pytest.raises(tsan.SanitizeError, match="NaN produced by kernel wrapper 'ssm_step'"):
            tss.ssm_step(xbc, dt, ssm, conv, *params)
        params[-1] = torch.ones(H)
        assert torch.isfinite(tss.ssm_step(xbc, dt, ssm, conv, *params)).all()
    assert calls["ssm_step"] == 2 and sum(calls.values()) == 2


def plain_launch(views, B, T, H, context):
    """A correct stand-in for a kernel's C entry point: the plain version,
    written into the guarded outputs."""
    kw = dict(num_heads=H, head_dim=tsan.HEAD_DIM)
    if "k_rot" in views:
        out, k_rot = fa.causal_attention_qkv_plain(views["qkv"], views["lengths"], **kw)
        views["out"].copy_(out)
        views["k_rot"].copy_(k_rot)
    else:
        views["out"].copy_(fa.window_attention_qkv_plain(views["qkv"], context=context, **kw))


def write_past_out(views, B, T, H, context):
    plain_launch(views, B, T, H, context)
    out = views["out"]
    torch.as_strided(out, (out.numel() + 1,), (1,), out.storage_offset())[-1] = 0.0


def write_before_sin(views, B, T, H, context):
    plain_launch(views, B, T, H, context)
    sin = views["sin"]
    torch.as_strided(sin, (1,), (1,), sin.storage_offset() - 1)[0] = 0.0


def read_before_qkv(views, B, T, H, context):
    plain_launch(views, B, T, H, context)
    qkv = views["qkv"]
    views["out"].view(-1)[0] += torch.as_strided(qkv, (1,), (1,), qkv.storage_offset() - 1)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,context", [("causal_attention_qkv", 0),
                                          ("window_attention_qkv", 5)])
@pytest.mark.parametrize("launch,caught", [(plain_launch, None),
                                           (write_past_out, "a write landed outside 'out'"),
                                           (write_before_sin, "a write landed in input 'sin'"),
                                           (read_before_qkv, "'out' is not finite")])
def test_guarded_slabs_catch_stand_in_kernels(name, context, dtype, launch, caught):
    args = (name, dtype, 3, 13, 2, launch, "cpu")
    if caught is None:
        assert tsan.guarded_case(*args, context=context)["rel"] == 0.0
    else:
        with pytest.raises(tsan.SanitizeError, match=caught):
            tsan.guarded_case(*args, context=context)


def plain_decode_launch(views, B, Tmax, H, splits):
    """A correct stand-in for the decode attention's C entry point: the
    plain version on the cache with the masked columns zeroed (but in a row
    with no valid column, which takes them all), written into the output."""
    mask = views["mask"]
    skip = (~mask & mask.any(dim=1, keepdim=True))[:, :, None, None]
    k, v = (views[key].masked_fill(skip, 0.0) for key in ("k", "v"))
    views["out"].copy_(tattn.decode_attention_masked(views["q"], k, v, mask))


def decode_reads_masked(views, B, Tmax, H, splits):
    views["out"].copy_(tattn.decode_attention_masked(views["q"], views["k"], views["v"],
                                                     views["mask"]))


def decode_writes_past_part(views, B, Tmax, H, splits):
    plain_decode_launch(views, B, Tmax, H, splits)
    part = views["part"]
    torch.as_strided(part, (1,), (1,), part.storage_offset() + part.numel())[0] = 0.0


def decode_writes_mask(views, B, Tmax, H, splits):
    plain_decode_launch(views, B, Tmax, H, splits)
    views["mask"][0, 0] = ~views["mask"][0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("launch,caught", [
    (plain_decode_launch, None),
    (decode_reads_masked, "'out' is not finite"),
    (decode_writes_past_part, "a write landed outside 'part'"),
    (decode_writes_mask, "a write landed in input 'mask'")])
def test_guarded_decode_slabs_catch_stand_in_kernels(dtype, launch, caught):
    args = (dtype, 4, 37, 2, launch, "cpu")
    if caught is None:
        assert tsan.guarded_decode_case(*args)["rel"] == 0.0
    else:
        with pytest.raises(tsan.SanitizeError, match=caught):
            tsan.guarded_decode_case(*args)


def test_guarded_phase_runs_every_case_with_a_correct_stand_in():
    launches = dict.fromkeys(("causal_attention_qkv", "window_attention_qkv"), plain_launch)
    res = tsan.phase_guarded("cpu", {**launches, "decode_attention": plain_decode_launch})
    n = 2 * (len(tsan.B1_T) * len(tsan.B1_B) + len(tsan.B2_T) * len(tsan.B2_CONTEXTS)
             + len(tsan.DECODE_CASES))
    assert res["cases"] == n == 56 and res["max_rel"] == {"f32": 0.0, "bf16": 0.0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("shape", [(1,), (3, 13, 384), (2, 1023, 1536), (7, 5)])
def test_guard_bands_keep_256_byte_alignment(dtype, shape):
    if not dtype.is_floating_point:
        shape = (shape[0],)   # the lengths' layout; bands of int tensors are never NaN
    fill = "nan" if dtype.is_floating_point else "sentinel"
    g = tsan.guarded(shape, dtype, "cpu", fill)
    esize = g.view.element_size()
    assert tsan.BAND_BYTES % tsan.ALIGN == 0 and g.band * esize == tsan.BAND_BYTES
    assert g.slab.data_ptr() % tsan.ALIGN == 0 and g.view.data_ptr() % tsan.ALIGN == 0
    lead, tail = g.bands()
    assert lead.numel() == tail.numel() == g.band
    assert tail.data_ptr() == g.view.data_ptr() + g.view.numel() * esize
    assert g.view.shape == torch.Size(shape) and g.view.is_contiguous()


def test_planted_nan_weight_is_named(tiny_dir):
    assert "out_norm_w" in tsan.phase_planted_nan(tiny_dir, KW, "cpu")
    assert tfl.load_weights.__name__ == "load_weights"   # restored


# -- flowlm_parity -------------------------------------------------------------------


def test_run_ours_matches_the_jax_tool(tiny_dir, tiny_clis, tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    want = jpar.run_ours(tiny_dir, "Hello world!", 4, 123, str(a))
    got = tpar.run_ours(tiny_dir, "Hello world!", 4, 123, str(b), device="cpu")
    for tap in tpar.TAPS:
        assert got[tap].shape == want[tap].shape and got[tap].size > 0
        assert np.abs(got[tap] - want[tap]).max() <= 1e-4 * np.abs(want[tap]).max(), tap


def write_dumps(outdir, taps: dict) -> str:
    os.makedirs(outdir, exist_ok=True)
    for tap in tpar.TAPS:
        taps[tap].astype("<f4").tofile(os.path.join(outdir, f"{tap}.f32"))
    return str(outdir)


@pytest.fixture
def own_dumps(tiny_dir, tiny_clis, tmp_path):
    ours = tpar.run_ours(tiny_dir, "Hello world!", 4, 123, str(tmp_path), device="cpu")
    return ours


def test_self_compare_reads_zero(tiny_dir, own_dumps, tmp_path, capsys):
    d = write_dumps(tmp_path / "self", own_dumps)
    assert tpar.main(["--model-dir", tiny_dir, "--other-dumps", d, "--device", "cpu",
                      "--tolerance", "0"]) == 0
    out = capsys.readouterr().out
    for tap in tpar.TAPS:
        assert f"{tap}: max=0.000000e+00 mean=0.000000e+00 rms=0.000000e+00" in out
    assert "PARITY OK" in out


@pytest.mark.parametrize("case,rc", [("within", 0), ("beyond", 1), ("beyond_rel", 1),
                                     ("meta_mismatch", 1), ("no_model_dir", 77),
                                     ("no_source", 77)])
def test_parity_exit_codes(tiny_dir, own_dumps, tmp_path, capsys, case, rc):
    taps = {k: v.copy() for k, v in own_dumps.items()}
    argv = ["--model-dir", tiny_dir, "--device", "cpu"]
    if case == "within":   # 1e-6 of max off, gated per tap at the card's gates
        taps["cond"] = taps["cond"] * np.float32(1 + 1e-6)
        argv += ["--tolerance-rel", "latents=1e-3,cond=1e-4,flow=1e-4"]
    elif case == "beyond":
        taps["latents"][0] += 1.0
    elif case == "beyond_rel":   # 1e-3 of max off, gated at 1e-4 of max
        taps["flow"] = taps["flow"] * np.float32(1 + 1e-3)
        argv += ["--tolerance-rel", "1e-4"]
    d = write_dumps(tmp_path / "dumps", taps)
    if case == "meta_mismatch":
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump({"sha256": {synth.WEIGHTS_NAME: "0" * 64}}, f)
    if case == "no_model_dir":
        argv[1] = str(tmp_path / "nope")
    if case != "no_source":
        argv += ["--other-dumps", d]
    assert tpar.main(argv) == rc
    cap = capsys.readouterr()
    if case == "meta_mismatch":
        assert "does not match" in cap.err and "latents:" not in cap.out
    if rc == 77:
        assert "SKIP" in cap.err


def test_parse_rel_gates():
    assert tpar.parse_rel_gates("1e-4") == dict.fromkeys(tpar.TAPS, 1e-4)
    assert tpar.parse_rel_gates("latents=1e-3,cond=1e-4,flow=1e-4") == tpar.CARD_GATES
    with pytest.raises(ValueError, match="unknown tap"):
        tpar.parse_rel_gates("pcm=1e-3")


def test_torch_oracle_without_pocket_tts_is_no_source(tiny_dir, capsys):
    assert tpar.main(["--model-dir", tiny_dir, "--torch", "--device", "cpu"]) == 77
    assert "no comparison source" in capsys.readouterr().err


# -- committed data: the JAX package's full-width dumps ------------------------------


def write_jax_golden(model_dir: str, out_dir: str) -> dict:
    """The JAX package's --flow-test dumps of ``model_dir`` (latents, cond,
    flow and the --mimi-wave WAV of one run at GOLDEN_RUN) and meta.json
    into ``out_dir``; returns the meta."""
    import jax
    import jaxlib

    os.makedirs(out_dir, exist_ok=True)
    p = GOLDEN_RUN
    run = ["-p", p["prompt"], "--flow-test", "--frames", str(p["frames"]), "-S",
           str(p["seed"]), "-t", str(p["temp"])]
    paths = [os.path.join(out_dir, n) for n in GOLDEN_FILES]
    rc = jcli.main(["-d", model_dir] + run + ["--latent-out", paths[0], "--cond-out", paths[1],
                                               "--flow-out", paths[2], "--mimi-wave", paths[3]])
    assert rc == 0, f"ptts_tpu.cli exited {rc}"
    meta = {"source": "python -m ptts_tpu.cli -d DIR " + " ".join(
                f"'{a}'" if " " in a else a for a in run)
            + " --latent-out latents.f32 --cond-out cond.f32 --flow-out flow.f32"
              " --mimi-wave mimi.wav (CPU, tests/conftest.py's JAX settings)",
            "model_dir": "ptts_torch.synth.write_model_dir(dir, seed=0)",
            "sha256": tpar.checkpoint_sha256(model_dir),
            **GOLDEN_RUN,
            "versions": {"jax": jax.__version__, "jaxlib": jaxlib.__version__,
                         "numpy": np.__version__}}
    with open(os.path.join(out_dir, "meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return meta


@pytest.fixture(scope="module")
def full_dir(tmp_path_factory):
    """The full-width synthetic checkpoint the dumps were made from."""
    return synth.write_model_dir(str(tmp_path_factory.mktemp("full")), seed=0)


def read_meta() -> dict:
    with open(os.path.join(GOLDEN, "meta.json"), encoding="utf-8") as f:
        return json.load(f)


def test_golden_checkpoint_hashes_to_meta(full_dir):
    meta = read_meta()
    assert meta["sha256"] == tpar.checkpoint_sha256(full_dir)
    assert set(meta["sha256"]) == {synth.WEIGHTS_NAME, "embeddings/alba.safetensors"}
    assert tpar.meta_mismatch(GOLDEN, full_dir) is None


def test_port_on_cpu_matches_the_jax_golden_at_full_width(full_dir, tmp_path, capsys):
    """The first full-width comparison of the port with the JAX package:
    at the card's gates (chip_smoke phase 14 (b))."""
    ours = tpar.run_ours(full_dir, GOLDEN_RUN["prompt"], GOLDEN_RUN["frames"],
                         GOLDEN_RUN["seed"], str(tmp_path), device="cpu", wave=True)
    res = tpar.compare(ours, tpar.load_dumps(GOLDEN), 0.0, tpar.CARD_GATES)
    for tap, gate in tpar.CARD_GATES.items():
        assert res["rel"][tap] <= gate, (tap, res["rel"][tap])
    assert res["wave_lsb"] <= tpar.WAVE_LSB and 0.0 < res["clipped"] < 1.0
    assert res["ok"]
    assert tpar.main(["--model-dir", full_dir, "--other-dumps", GOLDEN, "--device", "cpu",
                      "--tolerance-rel", "latents=1e-3,cond=1e-4,flow=1e-4"]) == 0
    assert "PARITY OK" in capsys.readouterr().out


def test_jax_package_regenerates_the_golden_bit_for_bit(full_dir, tmp_path):
    meta = write_jax_golden(full_dir, str(tmp_path))
    for name in GOLDEN_FILES:
        with open(os.path.join(GOLDEN, name), "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name
    assert meta["sha256"] == read_meta()["sha256"]


# -- hello_world_test ----------------------------------------------------------------


def signals():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 24000).astype(np.float32)
    tone = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    noise = (rng.standard_normal(30000) * 0.1).astype(np.float32)
    shifted = np.concatenate([np.zeros(500, np.float32), noise])[:30000]
    speechish = (tone * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    return [(tone, tone.copy()), (noise, shifted), (np.zeros(24000, np.float32) + 1e-5,
                                                    speechish),
            (noise[:20000], (rng.standard_normal(26000) * 0.2).astype(np.float32))]


@pytest.mark.parametrize("i", range(4))
def test_hello_world_metrics_equal_the_jax_tool(i):
    gen, ref = signals()[i]
    got, want = thw.compare(gen, ref), jhw.compare(gen, ref)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert thw.gates_pass(got) == jhw.gates_pass(want)


BLOCK_JAX = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("ptts_tpu", "jax", "jaxlib"):
            raise ImportError(f"{name} is not importable here")
sys.meta_path.insert(0, Block())
sys.argv = ["hello_world_test"] + sys.argv[1:]
runpy.run_module("ptts_torch.tools.hello_world_test", run_name="__main__")
"""


@pytest.mark.parametrize("case", ["no_ref", "no_model_dir"])
def test_hello_world_exits_77_without_assets(tmp_path, case):
    ref = tmp_path / "ref.wav"
    if case == "no_model_dir":
        from ptts_torch.io.wav import Audio, save_wav
        save_wav(Audio(24000, 1, np.zeros(2400, np.float32)), str(ref))
    env = {k: v for k, v in os.environ.items() if k not in ("PTTS_MODEL_DIR", "PTTS_HELLO_REF")}
    proc = subprocess.run([sys.executable, "-c", BLOCK_JAX, "--ref", str(ref), "--model-dir",
                           str(tmp_path / "nope"), "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 77, proc.stderr[-2000:]
    assert "SKIP" in proc.stderr
    assert "ImportError" not in proc.stderr


# -- the sweeps ----------------------------------------------------------------------


DEVICE = {"name": "card", "power_limit_w": 700.0, "count": 1}


@pytest.fixture
def pretend_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "device_info", lambda: DEVICE)
    monkeypatch.setattr(bench, "device_weights", lambda *a: ("fw", "mw"))


def test_batcher_sweep_grid_rows_and_best(pretend_card, monkeypatch, capsys):
    calls = []

    def fake(slots, dtype_name, target, max_seconds, frames_per_step, collect_pcm, pipeline,
             label, warmup_steps, weights):
        calls.append((slots, frames_per_step, pipeline, target, collect_pcm, weights))
        return slots * frames_per_step * (2 if pipeline else 1) / 10, 20.0, target, 1.25
    monkeypatch.setattr(bench, "run_batcher_bench", fake)
    assert bench_batcher_sweep.main(["--slots", "64,512", "--k", "1,8", "--reqs", "400",
                                     "--max-seconds", "5"]) == 0
    assert [c[:3] for c in calls] == [(s, k, p) for s in (64, 512) for k in (1, 8)
                                      for p in (False, True)]
    assert {c[3] for c in calls if c[0] == 64} == {200}    # max(400 * 64 / 256, 200)
    assert {c[3] for c in calls if c[0] == 512} == {800}
    assert all(not c[4] and c[5] == ("fw", "mw") for c in calls)
    cap = capsys.readouterr()
    rows = [json.loads(line) for line in cap.out.splitlines()]
    assert len(rows) == 8 and all(r["device"] == DEVICE for r in rows)
    assert rows[-1] == {"slots": 512, "k": 8, "mode": "pipe", "streams": 819.2,
                        "first_chunk_p50_ms": 20.0, "finished": 800, "wall_s": 1.2,
                        "device": DEVICE}
    star = [line for line in cap.err.splitlines() if line.endswith(" *")]
    assert star == ["[sweep]   512  8  pipe      819.2    20.0 *"]


def test_batch_sweep_rows_and_best(pretend_card, monkeypatch, capsys):
    seen = []

    def fake(b, frames, dtype_name, repeats, modes):
        seen.append((b, frames, dtype_name, repeats, modes))
        return {"value": 1000.0 - (b - 384) ** 2 / 100, "detail": {
            "ragged_eos_streams": b / 2, "wall_s": 0.5, "compile_s": 1.0}}
    monkeypatch.setattr(bench, "run_bench", fake)
    monkeypatch.setenv("PTTS_BENCH_FRAMES", "10")
    monkeypatch.setenv("PTTS_BENCH_REPEATS", "1")
    assert bench_batch_sweep.main(["256", "384", "512"]) == 0
    assert seen == [(b, 10, "bf16", 1, ("on", "ragged")) for b in (256, 384, 512)]
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["batch"] for r in lines[:3]] == [256, 384, 512]
    assert lines[-1]["best"] == lines[1] and lines[-1]["sweep"] == lines[:3]
    assert lines[1] == {"batch": 384, "streams_on": 1000.0, "ragged": 192.0, "wall_s": 0.5,
                        "compile_s": 1.0, "device": DEVICE}


@pytest.mark.parametrize("sweep", ["batcher", "batch"])
def test_a_failing_point_fails_the_sweep(pretend_card, monkeypatch, capsys, sweep):
    calls = []

    def boom(*a, **k):
        calls.append(a)
        if len(calls) == 2:
            raise RuntimeError("point failed")
        if sweep == "batch":
            return {"value": 1.0, "detail": {"ragged_eos_streams": 1.0, "wall_s": 1.0,
                                             "compile_s": 1.0}}
        return 1.0, 1.0, 1, 1.0
    monkeypatch.setattr(bench, "run_batcher_bench" if sweep == "batcher" else "run_bench", boom)
    with pytest.raises(RuntimeError, match="point failed"):
        if sweep == "batcher":
            bench_batcher_sweep.main(["--slots", "64", "--k", "1,8", "--modes", "serial"])
        else:
            bench_batch_sweep.main(["16", "32", "64"])
    assert len(calls) == 2   # no point after the failed one
    assert "best" not in capsys.readouterr().out


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_tools.py --write-golden")
    import tempfile

    import conftest  # noqa: F401 -- the tests' JAX settings (CPU, 8 devices, highest matmul)

    with tempfile.TemporaryDirectory() as tmp:
        model = synth.write_model_dir(os.path.join(tmp, "model"), seed=0)
        if os.path.isdir(GOLDEN):
            shutil.rmtree(GOLDEN)
        print(json.dumps(write_jax_golden(model, GOLDEN), indent=1))
