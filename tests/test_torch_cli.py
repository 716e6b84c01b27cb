"""The port's CLI against ptts_tpu.cli on one tiny synthetic model (CPU):
introspection output identical, the debug taps and WAVs within 1e-3 of
max, the same exit codes, and the JAX command lines accepted unchanged.
Each CLI module's ``api.load_dir`` is patched to pass the tiny configs (and,
for the port, the CPU device)."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch import cli as tcli  # noqa: E402
from ptts_tpu import api as japi  # noqa: E402
from ptts_tpu import cli as jcli  # noqa: E402
from ptts_tpu.io.wav import load_wav  # noqa: E402

TOL = 1e-3
KW = dict(flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI)


def rel_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("climodel"), seed=2)
    return path


@pytest.fixture(autouse=True)
def tiny_configs(monkeypatch):
    devices = []

    def port_load_dir(model_dir, device="cuda"):
        devices.append(device)
        return tapi.Context(model_dir, device="cpu", **KW)

    monkeypatch.setattr(jcli.api, "load_dir", lambda d: japi.Context(d, **KW))
    monkeypatch.setattr(tcli.api, "load_dir", port_load_dir)
    return devices


def run_both(capsys, argv):
    """(rc, stdout, stderr) of the JAX CLI, then of the port's."""
    out = []
    for cli in (jcli, tcli):
        rc = cli.main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


@pytest.mark.parametrize("argv", [
    ["--info"],
    ["--list"],
    ["--find", "flow_net"],
    ["--verify"],
    ["--tokens", "-p", "hello world"],
    ["-v", "--tokens", "-p", "Hello, world!"],
    ["--info", "--list", "--find", "out_", "--verify", "--tokens", "-p", "hi"],
])
def test_introspection_output_identical(model_dir, capsys, argv):
    (jrc, jout, jerr), (trc, tout, terr) = run_both(capsys, ["-d", model_dir] + argv)
    assert jrc == trc == 0
    assert tout == jout
    assert tout or argv == ["--verify"]  # a passing --verify prints nothing
    assert terr == jerr


def _stats(line: str):
    return [float(v) for v in re.findall(r"=(-?[\d.]+)", line)]


def test_flow_test_taps_match_jax(model_dir, tmp_path, capsys):
    outs = []
    for tag, cli in (("j", jcli), ("t", tcli)):
        paths = [str(tmp_path / f"{tag}_{n}.f32") for n in ("lat", "cond", "flow")]
        rc = cli.main(["-d", model_dir, "-p", "hello world", "--flow-test", "--frames", "3",
                       "-S", "3", "-t", "0.5", "-s", "2", "--latent-out", paths[0],
                       "--cond-out", paths[1], "--flow-out", paths[2]])
        assert rc == 0
        line = capsys.readouterr().out.strip()
        assert line.startswith("FlowLM step: eos_logit=")
        outs.append((_stats(line), [np.fromfile(p, dtype="<f4") for p in paths]))
    (jstats, jtaps), (tstats, ttaps) = outs
    np.testing.assert_allclose(tstats, jstats, atol=2e-4)
    assert ttaps[0].size % TINY_FLOWLM.latent_dim == 0 and ttaps[0].size > 0
    assert ttaps[1].size == TINY_FLOWLM.d_model and ttaps[2].size == TINY_FLOWLM.latent_dim
    for got, want in zip(ttaps, jtaps):
        rel_close(got, want)


def test_mimi_test_and_wave_match_jax(model_dir, tmp_path, capsys):
    waves, stats = [], []
    for tag, cli in (("j", jcli), ("t", tcli)):
        path = str(tmp_path / f"{tag}_mimi.wav")
        rc = cli.main(["-d", model_dir, "-p", "hello", "--mimi-test", "--mimi-wave", path,
                       "--frames", "2", "-S", "3", "-v"])
        assert rc == 0
        cap = capsys.readouterr()
        line = [ln for ln in cap.out.splitlines() if ln.startswith("Mimi decode")]
        assert len(line) == 1 and "Wrote Mimi WAV" in cap.err
        stats.append(_stats(line[0]))
        waves.append(load_wav(path))
    np.testing.assert_allclose(stats[1], stats[0], atol=2e-4)
    assert waves[1].num_samples == waves[0].num_samples == 2 * TINY_MIMI.frame_samples
    rel_close(waves[1].samples, waves[0].samples)


@pytest.mark.parametrize("argv", [
    [],
    ["-o", "x.wav"],
    ["-p", "hi"],
    ["-p", "hi", "-o", "x.wav"],                       # no --dir and no --dummy
    ["--info"],                                        # introspection without --dir
    ["--tokens", "-d", "{dir}"],                       # --tokens without --prompt
    ["--flow-test", "-d", "{dir}"],                    # debug mode without --prompt
    ["--mimi-wave", "m.wav", "-d", "{dir}"],
    ["--verify", "-d", "{missing}"],                   # no weights file
    ["-d", "{missing}", "-p", "hi", "-o", "x.wav"],
])
def test_error_exits_match_jax(model_dir, tmp_path, capsys, argv):
    argv = [a.format(dir=model_dir, missing=str(tmp_path / "missing")) for a in argv]
    (jrc, jout, jerr), (trc, tout, terr) = run_both(capsys, argv)
    assert jrc == trc == 1
    assert terr == jerr and terr.startswith("Error: ")


def test_generate_flags_accepted_unchanged(model_dir, tmp_path, capsys, tiny_configs):
    """The JAX generate-mode command line, flag for flag, through the port:
    the same WAV within 1e-3 and the same messages."""
    waves = []
    for tag, cli in (("j", jcli), ("t", tcli)):
        out = str(tmp_path / f"{tag}.wav")
        rc = cli.main(["-d", model_dir, "-p", "hello world", "-o", out, "--voice", "alba",
                       "-S", "7", "-t", "0.6", "--noise-clamp", "2.5",
                       "--eos-threshold", "-1e9", "--eos-min-frames", "2", "--eos-after", "1",
                       "-r", "24000", "-s", "2", "--frames", "6", "-v"])
        assert rc == 0
        assert capsys.readouterr().err == f"Saved {out}\n"
        waves.append(load_wav(out))
    assert tiny_configs == ["cuda"]  # the port's default device
    assert waves[1].num_samples == waves[0].num_samples == 3 * TINY_MIMI.frame_samples
    rel_close(waves[1].samples, waves[0].samples)


def test_dummy_is_identical(tmp_path, capsys):
    outs = []
    for tag, cli in (("j", jcli), ("t", tcli)):
        path = tmp_path / f"{tag}.wav"
        assert cli.main(["--dummy", "-p", "hi there", "-o", str(path), "-r", "16000"]) == 0
        assert capsys.readouterr().err.startswith("Generating dummy audio...")
        outs.append(path.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 44


def test_device_flag_reaches_load_dir(model_dir, capsys, tiny_configs):
    assert tcli.main(["-d", model_dir, "--info", "--device", "cpu"]) == 0
    assert tiny_configs == ["cpu"]
    assert "Pocket-TTS model info" in capsys.readouterr().out
