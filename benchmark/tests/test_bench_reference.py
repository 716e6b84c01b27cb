"""The benchmark's plain reference against the repository's NumPy oracle
(tests/refimpl.py) at a tiny size, and its text front end and noise
against the port's on the CPU."""

import os
import sys
import types

import numpy as np
import pytest
import torch

import tiny
from benchmark import weights as W
from benchmark.reference import text as rtext
from benchmark.reference.model import Reference

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(REPO, "tests"))
import refimpl  # noqa: E402


def _np(t):
    return t.float().numpy()


def _oracle_weights(w, f, m):
    L, D = f["num_layers"], f["flow_depth"]
    st = lambda fmt, n: np.stack([_np(w[fmt.format(i)]) for i in range(n)])  # noqa: E731
    tl, te, rb = "transformer.layers.{}.", "flow_net.time_embed.{}.", "flow_net.res_blocks.{}."
    fw = {"embed": _np(w["conditioner.embed.weight"]), "emb_std": _np(w["emb_std"]),
          "emb_mean": _np(w["emb_mean"]), "bos_emb": _np(w["bos_emb"]),
          "input_linear": _np(w["input_linear.weight"]), "out_norm_w": _np(w["out_norm.weight"]),
          "out_norm_b": _np(w["out_norm.bias"]), "out_eos_w": _np(w["out_eos.weight"])[0],
          "out_eos_b": _np(w["out_eos.bias"])[0]}
    for k, n in [("in_proj", "self_attn.in_proj.weight"), ("out_proj", "self_attn.out_proj.weight"),
                 ("norm1_w", "norm1.weight"), ("norm1_b", "norm1.bias"), ("norm2_w", "norm2.weight"),
                 ("norm2_b", "norm2.bias"), ("linear1", "linear1.weight"),
                 ("linear2", "linear2.weight")]:
        fw[k] = st(tl + n, L)
    g = lambda n: _np(w["flow_net." + n])  # noqa: E731
    fw["flow"] = {
        "input_w": g("input_proj.weight"), "input_b": g("input_proj.bias"),
        "cond_w": g("cond_embed.weight"), "cond_b": g("cond_embed.bias"),
        "time": {"lin0_w": st(te + "mlp.0.weight", 2), "lin0_b": st(te + "mlp.0.bias", 2),
                 "lin2_w": st(te + "mlp.2.weight", 2), "lin2_b": st(te + "mlp.2.bias", 2),
                 "rms_alpha": st(te + "mlp.3.alpha", 2), "freqs": st(te + "freqs", 2)},
        "res": {k: st(rb + n, D) for k, n in [
            ("in_ln_w", "in_ln.weight"), ("in_ln_b", "in_ln.bias"), ("mlp0_w", "mlp.0.weight"),
            ("mlp0_b", "mlp.0.bias"), ("mlp2_w", "mlp.2.weight"), ("mlp2_b", "mlp.2.bias"),
            ("ada_w", "adaLN_modulation.1.weight"), ("ada_b", "adaLN_modulation.1.bias")]},
        "final_ada_w": g("final_layer.adaLN_modulation.1.weight"),
        "final_ada_b": g("final_layer.adaLN_modulation.1.bias"),
        "final_linear_w": g("final_layer.linear.weight"),
        "final_linear_b": g("final_layer.linear.bias")}
    ml = "decoder_transformer.transformer.layers.{}."
    tr = {k: st(ml + n, m["num_layers"]) for k, n in [
        ("in_proj", "self_attn.in_proj.weight"), ("out_proj", "self_attn.out_proj.weight"),
        ("norm1_w", "norm1.weight"), ("norm1_b", "norm1.bias"), ("norm2_w", "norm2.weight"),
        ("norm2_b", "norm2.bias"), ("linear1", "linear1.weight"), ("linear2", "linear2.weight"),
        ("ls1", "layer_scale_1.scale"), ("ls2", "layer_scale_2.scale")]}
    stages, idx = [], 2
    for r in m["ratios"]:
        d = f"decoder.model.{idx}."
        stages.append({"up_w": _np(w[d + "convtr.weight"]), "up_b": _np(w[d + "convtr.bias"]),
                       "stride": r,
                       "res1_w": _np(w[f"decoder.model.{idx + 1}.block.1.conv.weight"]),
                       "res1_b": _np(w[f"decoder.model.{idx + 1}.block.1.conv.bias"]),
                       "res2_w": _np(w[f"decoder.model.{idx + 1}.block.3.conv.weight"]),
                       "res2_b": _np(w[f"decoder.model.{idx + 1}.block.3.conv.bias"])})
        idx += 3
    qw = _np(w["quantizer.output_proj.weight"])
    mw = {"quant_w": qw.reshape(qw.shape[0], qw.shape[1]),
          "upsample_w": _np(w["upsample.convtr.convtr.weight"]), "transformer": tr,
          "dec_in_w": _np(w["decoder.model.0.conv.weight"]),
          "dec_in_b": _np(w["decoder.model.0.conv.bias"]), "stages": stages,
          "dec_out_w": _np(w[f"decoder.model.{idx}.conv.weight"]),
          "dec_out_b": _np(w[f"decoder.model.{idx}.conv.bias"])}
    return fw, mw


@pytest.fixture(scope="module")
def model():
    cfg = tiny.cfg()
    w = W.make_weights(cfg, 4242, "cpu")
    fw, mw = _oracle_weights(w, cfg["flowlm"], cfg["mimi"])
    return cfg, w, fw, mw


def test_teacher_forced_flowlm_matches_the_oracle(model):
    cfg, w, fw, _ = model
    fcfg = types.SimpleNamespace(**cfg["flowlm"])
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((3, fcfg.d_model)).astype(np.float32) * 0.3
    ids = [5, 9, 70, 2]                       # 70 is outside the table: row 0
    noise = rng.standard_normal((6, fcfg.latent_dim)).astype(np.float32)
    want = refimpl.flowlm_generate_latents(fw, np.array(ids), cond, 6, 1, noise, fcfg,
                                           eos_enabled=False)
    ref = Reference(w, cfg)
    lat, eos = ref.teacher_forced(ref.prompt(ids, torch.from_numpy(cond)),
                                  torch.from_numpy(noise), torch.from_numpy(want["latents"]))
    np.testing.assert_allclose(lat.numpy(), want["latents"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eos.numpy(), want["eos_logits"], rtol=1e-4, atol=1e-5)


def test_mimi_decode_matches_the_oracle(model):
    cfg, w, _, mw = model
    mcfg = types.SimpleNamespace(**cfg["mimi"])
    lat = np.random.default_rng(1).standard_normal((5, mcfg.latent_dim)).astype(np.float32)
    want = refimpl.mimi_decode(mw, lat, mcfg)
    got = Reference(w, cfg).decode(torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("precision", ["tf32", "fp8"])
def test_lower_precisions_move_the_reference(model, precision):
    cfg, w, _, _ = model
    lat = torch.randn(4, cfg["mimi"]["latent_dim"], generator=torch.Generator().manual_seed(2))
    a = Reference(w, cfg).decode(lat)
    b = Reference(w, cfg, precision).decode(lat)
    rel = float((a - b).norm() / a.norm())
    assert (1e-5 if precision == "tf32" else 1e-2) < rel < 0.5


@pytest.mark.parametrize("text", ["hello world", "a bc def gh i jk lm n op q rs",
                                  "  two\twords  ", "Ends with a mark!"])
def test_text_front_end_matches_the_port(text):
    from ptts_torch import text as ptext
    from ptts_torch.tokenizer.spm import SentencePieceModel

    prepared, words, _ = ptext.prepare_text(text)
    assert rtext.prepare_text(text) == (prepared, words)
    assert rtext.frame_budget(words) == ptext.estimate_frames(words)
    tok = SentencePieceModel.from_bytes(W.tokenizer_model_bytes()) if hasattr(
        SentencePieceModel, "from_bytes") else None
    if tok is None:
        import tempfile
        with tempfile.NamedTemporaryFile(suffix=".model") as f:
            f.write(W.tokenizer_model_bytes())
            f.flush()
            tok = SentencePieceModel.load(f.name)
    assert rtext.tokenize(prepared, W.tokenizer_pieces()) == tok.encode(prepared)


def test_frame_noise_matches_the_port():
    from ptts_torch.rng import frame_noise
    seeds = [7, 2**31 + 11, 123456789]
    got = rtext.frame_noise(seeds, 5, 32, 0.7)
    for s, g in zip(seeds, got):
        np.testing.assert_allclose(g, frame_noise(s, 5, 32, temp=0.7), rtol=2e-6, atol=2e-6)
