"""Sanitizer sweep of the port (port of tools/sanitize.py, the counterpart of
the reference's ``make cuda-sanitize``: compute-sanitizer memcheck over a
full generate).

    python -m ptts_torch.tools.sanitize                    # on a CUDA card, full width
    python -m ptts_torch.tools.sanitize --device cpu --tiny

Four phases over a seeded synthetic checkpoint (ptts_torch.synth; full
width, or the tiny configs of the CPU tests with ``--tiny``), each printed
as ``[sanitize] PASS/FAIL: <phase>``; the exit code is 0 only when all four
pass:

  1. **Guarded kernel launches** (the card's counterpart of the JAX tool's
     interpret-mode Pallas sweep, which checks every block index against
     the array's bounds). The C entry points of B1 and B2
     (ops/cuda/fused_attention.py's library) are launched directly on
     views into the middle of larger slabs: the bands around the inputs
     (qkv, cos, sin) hold NaN, the bands around the outputs (out, k_rot) a
     sentinel byte pattern. Every band is a multiple of 256 bytes and every
     view starts 256-byte aligned, so the kernels' 16-byte cp.async, float4
     and uint4 accesses keep the alignment the wrapper gives them. After
     each launch the output bands must be bit-identical to the sentinel and
     the outputs finite and within the kernel-against-plain gates (1e-4 f32,
     5e-2 bf16, of the largest reference value; the decode attention's
     DECODE_GATES), at ragged T and lengths.
     The inputs and their bands must come back unchanged too. What this
     proves: no out-of-bounds read reaches a result (a NaN read from a band
     would), and no write lands outside an output, within 4 KiB of the
     tensors. It is weaker than memcheck: an out-of-bounds read whose value
     a mask discards stays unseen, and so does a write past a band. The decode attention
     kernel (ops/cuda/decode_attention.py) gets the same treatment on q,
     the K/V cache, the mask (its bands hold the sentinel, which reads as a
     valid column, so a read past a mask row pulls a NaN band into the
     sums), the output and the split scratch, at ragged masks (rows with
     no valid column and with one) and at one and several splits; the K/V
     columns the mask leaves out hold NaN, which must not reach the
     output. The kernels' widths are fixed (head dim 64; FlowLM's 16 heads
     for B1 and the decode attention, Mimi's 8 for B2), whatever the
     model's. On the CPU the phase is reported as not run.
  2. **Per-operation NaN trap** (the counterpart of ``jax_debug_nans``): a
     TorchDispatchMode checks the floating outputs of every aten operation
     of one eager ``generate`` for NaN and raises SanitizeError naming the
     operation and the innermost ptts_torch frame. ``empty``,
     ``empty_like``, ``empty_strided`` and ``new_empty`` are skipped: their
     memory is uninitialised by contract. The kernel wrappers launch
     through ctypes, not aten, so their outputs are checked under the
     wrapper's name (every wrapper in ops/cuda/build.WRAPPERS). The engine
     is built with ``graphs=False``: a replayed CUDA graph shows no
     operation to the mode. Like jax_debug_nans it
     traps NaN, not Inf (masked scores are -1e30, finite).
  3. **Stage-boundary guards** (PTTS_SANITIZE, utils/sanitize) over a clean
     generate: they must stay silent.
  4. **Detection self-test**: one weight (``out_norm_w``) set to NaN; the
     guards must raise SanitizeError naming it.

The tool has no CPU path of its own: with no card it exits non-zero unless
``--device cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .. import api, synth
from ..config import FlowLMConfig, MimiConfig
from ..models import flowlm
from ..ops.attention import _scale, decode_attention_masked
from ..ops.cuda import build
from ..ops.cuda import fused_attention as fa
from ..runtime.engine import TTSEngine
from ..utils import sanitize
from ..utils.sanitize import SanitizeError

# the tiny configs of the CPU tests (tests/helpers.py)
TINY_FLOWLM = FlowLMConfig(vocab=11, text_dim=16, d_model=16, num_heads=2, head_dim=8,
                           num_layers=2, hidden=32, latent_dim=8, flow_dim=16, flow_depth=2,
                           time_freqs=4)
TINY_MIMI = MimiConfig(latent_dim=8, d_model=8, num_heads=2, head_dim=4, num_layers=1,
                       hidden=16, context=5, upsample_kernel=4, upsample_stride=2, n_filters=4,
                       ratios=(3, 2), kernel_size=5, last_kernel_size=3, residual_kernel=3,
                       compress=2)

PHASES = ("guarded kernel launches (out-of-bounds reads and writes)",
          "per-operation NaN trap generate",
          "stage-boundary guards, clean generate",
          "detection self-test (planted NaN weight)")
GATES = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the decode attention against its plain version: max |error| over max
# |plain| by dtype, and in bf16 ||error|| / ||plain|| too. Each bf16 gate
# lies between the kernel's worst reading at the main path's shapes (max
# 7.4e-3, one bf16 step of the largest output; norm 3.0e-3, the plain
# version's own rounding of p) and the lowest of two wrong kernels' (K/V
# rounded to fp8: 4.1e-2 and 3.8e-2), which chip_smoke phase 3d holds
DECODE_GATES = {torch.float32: 1e-4, torch.bfloat16: 1.5e-2}
DECODE_RMS_GATE = 1e-2
ALIGN = 256                # bytes: the alignment every guarded view keeps
BAND_BYTES = 4096          # each guard band, a multiple of ALIGN
SENTINEL = 0xA5            # the byte every output band holds
B1_HEADS, B2_HEADS, HEAD_DIM = 16, 8, fa.KERNEL_HEAD_DIM
B1_T, B1_B = (1, 13, 61, 127, 129, 250), (1, 3)
B2_T, B2_B, B2_CONTEXTS = (1, 13, 250, 251, 1023), 2, (250, 1)
DECODE_HEADS = 16
# (B, Tmax, splits): one split and several, a share of one column, the
# serving pool's 544 columns, a share of 750 columns
DECODE_CASES = ((1, 1, 1), (3, 37, 1), (3, 37, 2), (2, 544, 17), (5, 129, 3), (2, 1500, 2))


# -- phase 1: guarded launches ---------------------------------------------------


@dataclasses.dataclass
class Guarded:
    """A view of ``shape`` inside a slab that holds ``band`` elements before
    and after it; the slab and the view start ALIGN-byte aligned."""
    slab: torch.Tensor
    view: torch.Tensor
    band: int

    def bands(self) -> tuple:
        n = self.view.numel()
        return self.slab[:self.band], self.slab[self.band + n:]


def guarded(shape, dtype: torch.dtype, device, fill: str) -> Guarded:
    """A Guarded view, its bands NaN (``fill="nan"``) or SENTINEL bytes
    (``fill="sentinel"``); the view itself is left to the caller."""
    esize = torch.empty((), dtype=dtype).element_size()
    if BAND_BYTES % ALIGN or ALIGN % esize:
        raise ValueError(f"band {BAND_BYTES} B must be a multiple of {ALIGN} B")
    n, band = int(np.prod(shape)), BAND_BYTES // esize
    raw = torch.empty(n + 2 * band + ALIGN // esize, dtype=dtype, device=device)
    start = (-raw.data_ptr() % ALIGN) // esize
    slab = raw[start:start + n + 2 * band]
    g = Guarded(slab, slab[band:band + n].view(shape), band)
    for b in g.bands():
        if fill == "nan":
            b.fill_(float("nan"))
        else:
            b.view(torch.uint8).fill_(SENTINEL)
    return g


def band_intact(g: Guarded) -> bool:
    """True iff both bands still hold SENTINEL bytes, bit for bit."""
    return all(bool((b.view(torch.uint8) == SENTINEL).all()) for b in g.bands())


def check_guards(tag: str, ins: dict, outs: dict) -> None:
    """Raise SanitizeError if an input (``ins``: {key: (Guarded, its
    value)}) or its bands changed -- NaN bands, or SENTINEL bands for a bool
    input -- or an output's (``outs``: {key: Guarded}) SENTINEL bands did."""
    for key, (g, value) in ins.items():
        bands_ok = (band_intact(g) if g.view.dtype == torch.bool
                    else all(bool(torch.isnan(b).all()) for b in g.bands()))
        if not (bands_ok and torch.equal(g.view.view(torch.uint8), value.view(torch.uint8))):
            raise SanitizeError(f"[sanitize] {tag}: a write landed in input '{key}' or its bands")
    for key, g in outs.items():
        if not band_intact(g):
            raise SanitizeError(f"[sanitize] {tag}: a write landed outside '{key}'")


def b1_lengths(B: int, T: int) -> list:
    """Ragged lengths with 1 and T among them."""
    return [T] if B == 1 else [1, T, T // 2 + 1][:B]


def kernel_launch(name: str, device) -> Callable:
    """launch(*views, B, T, H, context) of a kernel's C entry point on
    ``device``'s current stream; raises on a CUDA error."""
    fn = build.entry(build.WRAPPERS[name].symbol)

    def launch(views: dict, B: int, T: int, H: int, context: int) -> None:
        bf16 = int(views["qkv"].dtype == torch.bfloat16)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            if name == "causal_attention_qkv":
                rc = fn(*(views[k].data_ptr() for k in ("qkv", "lengths", "cos", "sin", "out",
                                                        "k_rot")), B, T, H, bf16, stream)
            else:
                rc = fn(*(views[k].data_ptr() for k in ("qkv", "cos", "sin", "out")), B, T, H,
                        context, bf16, stream)
        build.raise_on(rc, name)
    return launch


def guarded_case(name: str, dtype: torch.dtype, B: int, T: int, H: int, launch: Callable,
                 device, context: int = 0, seed: int = 0) -> dict:
    """One launch of ``name`` (causal_attention_qkv or window_attention_qkv)
    through ``launch(views, B, T, H, context)`` on guarded views; raises
    SanitizeError if an input or its NaN bands changed, an output band
    changed, an output is not finite (outputs start as NaN, so an element
    left unwritten counts) or the result is past the gate of the plain
    version. Returns the case's relative error."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, 3 * H * HEAD_DIM)).astype(np.float32))
    cos_t, sin_t = fa._rope_tables(T, HEAD_DIM, 10000.0, dev)
    ins, views = {}, {}
    for key, value in (("qkv", x.to(dev, dtype)), ("cos", cos_t), ("sin", sin_t)):
        ins[key] = (guarded(value.shape, value.dtype, dev, "nan"), value)
        ins[key][0].view.copy_(value)
        views[key] = ins[key][0].view
    qkv = ins["qkv"][0]
    outs = {}
    for key in ("out", "k_rot") if name == "causal_attention_qkv" else ("out",):
        outs[key] = guarded((B, T, H * HEAD_DIM), dtype, dev, "sentinel")
        outs[key].view.fill_(float("nan"))  # an element left unwritten stays NaN
        views[key] = outs[key].view
    kw = dict(num_heads=H, head_dim=HEAD_DIM)
    tag = f"{name} {'bf16' if dtype == torch.bfloat16 else 'f32'} B={B} T={T}"
    if name == "causal_attention_qkv":
        lens = b1_lengths(B, T)
        views["lengths"] = torch.tensor(lens, dtype=torch.int32, device=dev)
        launch(views, B, T, H, 0)
        want, want_k = fa.causal_attention_qkv_plain(qkv.view.clone(), views["lengths"], **kw)
        pairs = [(torch.cat([views["out"][b, :n] for b, n in enumerate(lens)]),
                  torch.cat([want[b, :n] for b, n in enumerate(lens)])),
                 (views["k_rot"], want_k)]
    else:
        tag += f" context={context}"
        launch(views, B, T, H, context)
        want = fa.window_attention_qkv_plain(qkv.view.clone(), context=context, **kw)
        pairs = [(views["out"], want)]
    check_guards(tag, ins, outs)
    for key, g in outs.items():
        if not bool(torch.isfinite(g.view).all()):
            raise SanitizeError(f"[sanitize] {tag}: '{key}' is not finite (an out-of-bounds "
                                f"read of a NaN band, or an element left unwritten)")
    rel = 0.0
    for got, ref in pairs:
        err = (got.float() - ref.float()).abs().max().item()
        rel = max(rel, err / max(ref.float().abs().max().item(), 1e-30))
    if rel > GATES[dtype]:
        raise SanitizeError(f"[sanitize] {tag}: {rel:.3e} of max from the plain version "
                            f"(gate {GATES[dtype]})")
    return {"case": tag, "rel": rel}


def decode_launch(device) -> Callable:
    """launch(views, B, Tmax, H, splits) of the decode attention's C entry
    point on ``device``'s current stream; raises on a CUDA error."""
    fn = build.entry(build.WRAPPERS["decode_attention"].symbol)

    def launch(views: dict, B: int, Tmax: int, H: int, splits: int) -> None:
        with torch.cuda.device(device):
            rc = fn(*(views[k].data_ptr() for k in ("q", "k", "v", "mask", "out", "part")), B,
                    Tmax, H, 1, splits, _scale(HEAD_DIM), int(views["q"].dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
        build.raise_on(rc, "decode_attention")
    return launch


def decode_mask(B: int, Tmax: int, rng) -> torch.Tensor:
    """[B, Tmax] bool: row 0 has no valid column, row 1 one (its last), the
    rest a random prefix and a random run that wraps past the end."""
    mask = torch.zeros(B, Tmax, dtype=torch.bool)
    for b in range(B):
        if b == 1:
            mask[b, -1] = True
        elif b > 1:
            mask[b, :int(rng.integers(0, Tmax + 1))] = True
            cols = (int(rng.integers(0, Tmax)) + np.arange(int(rng.integers(1, Tmax + 1)))) % Tmax
            mask[b, torch.from_numpy(cols)] = True
    return mask


def guarded_decode_case(dtype: torch.dtype, B: int, Tmax: int, splits: int, launch: Callable,
                        device, seed: int = 0) -> dict:
    """One launch of the decode attention through ``launch(views, B, Tmax,
    H, splits)`` on guarded views, its masked K/V columns NaN (but in a row
    with no valid column, which takes them all); the same checks as
    guarded_case, against decode_attention_masked on the clean cache."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    H = DECODE_HEADS
    mask = decode_mask(B, Tmax, rng).to(dev)
    clean = {key: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
             for key, shape in (("q", (B, H, HEAD_DIM)), ("k", (B, Tmax, H, HEAD_DIM)),
                                ("v", (B, Tmax, H, HEAD_DIM)))}
    poisoned = (~mask & mask.any(dim=1, keepdim=True))[:, :, None, None]
    ins, views = {}, {}
    for key, value in (*clean.items(), ("mask", mask)):
        if key in ("k", "v"):
            value = value.masked_fill(poisoned, float("nan"))
        ins[key] = (guarded(value.shape, value.dtype, dev,
                            "sentinel" if key == "mask" else "nan"), value)
        ins[key][0].view.copy_(value)
        views[key] = ins[key][0].view
    outs = {"out": guarded((B, H, HEAD_DIM), dtype, dev, "sentinel"),
            "part": guarded((B * splits * H * (2 + HEAD_DIM),), torch.float32, dev, "sentinel")}
    for key, g in outs.items():
        g.view.fill_(float("nan"))  # an element left unwritten stays NaN
        views[key] = g.view
    tag = (f"decode_attention {'bf16' if dtype == torch.bfloat16 else 'f32'} B={B} T={Tmax} "
           f"splits={splits}")
    launch(views, B, Tmax, H, splits)
    want = decode_attention_masked(clean["q"], clean["k"], clean["v"], mask)
    check_guards(tag, ins, outs)
    got = outs["out"].view
    if not bool(torch.isfinite(got).all()):
        raise SanitizeError(f"[sanitize] {tag}: 'out' is not finite (a read of a masked "
                            f"column or of a NaN band, or an element left unwritten)")
    err, want = got.float() - want.float(), want.float()
    rel = (err.abs().max() / want.abs().max().clamp(min=1e-30)).item()
    rms = (err.norm() / want.norm().clamp(min=1e-30)).item()
    if rel > DECODE_GATES[dtype] or (dtype == torch.bfloat16 and rms > DECODE_RMS_GATE):
        raise SanitizeError(f"[sanitize] {tag}: {rel:.3e} of max, {rms:.3e} of the norm from "
                            f"the plain version (gates {DECODE_GATES[dtype]}, bf16 norm "
                            f"{DECODE_RMS_GATE})")
    return {"case": tag, "rel": rel, "rms": rms}


def phase_guarded(device="cuda", launches: Optional[dict] = None) -> dict:
    """Phase 1 over every case (B1 at B1_T x B1_B, B2 at B2_T x B2_CONTEXTS,
    the decode attention at DECODE_CASES, f32 and bf16). ``launches`` maps
    each kernel name to its launch function (default: the C entry points).
    Returns {cases, max_rel, seconds}."""
    t0 = time.perf_counter()
    launches = launches or {**{n: kernel_launch(n, device)
                               for n in ("causal_attention_qkv", "window_attention_qkv")},
                            "decode_attention": decode_launch(device)}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for T in B1_T:
            for B in B1_B:
                cases.append(guarded_case("causal_attention_qkv", dtype, B, T, B1_HEADS,
                                          launches["causal_attention_qkv"], device,
                                          seed=B * 1000 + T))
        for T in B2_T:
            for ctx in B2_CONTEXTS:
                cases.append(guarded_case("window_attention_qkv", dtype, B2_B, T, B2_HEADS,
                                          launches["window_attention_qkv"], device,
                                          context=ctx, seed=T + ctx))
        for B, T, splits in DECODE_CASES:
            cases.append(guarded_decode_case(dtype, B, T, splits, launches["decode_attention"],
                                             device, seed=B * 10000 + T + splits))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"cases": len(cases),
            "max_rel": {tag: max(c["rel"] for c in cases if f" {tag} " in c["case"])
                        for tag in ("f32", "bf16")},
            "seconds": time.perf_counter() - t0}


# -- phase 2: the per-operation NaN trap --------------------------------------------


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_aten = torch.ops.aten
UNINITIALISED = (_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty)


def port_frame() -> str:
    """``file:line in function`` of the innermost ptts_torch frame outside
    this module and the kernel registry."""
    skip = {os.path.abspath(__file__), os.path.abspath(build.__file__)}
    for fr in reversed(traceback.extract_stack()):
        path = os.path.abspath(fr.filename)
        if path.startswith(_PKG + os.sep) and path not in skip:
            return f"{os.path.relpath(path, os.path.dirname(_PKG))}:{fr.lineno} in {fr.name}"
    return "(no ptts_torch frame)"


def has_nan(out) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
               and bool(torch.isnan(t).any()) for t in _pytree.tree_leaves(out))


class NanTrap(TorchDispatchMode):
    """Checks the floating outputs of every aten operation for NaN (the
    UNINITIALISED allocations excepted) and raises SanitizeError naming the
    operation and port_frame(). ``ops`` counts the operations checked."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in UNINITIALISED:
            return out
        self.ops += 1
        if has_nan(out):
            raise SanitizeError(f"[sanitize] NaN produced by aten op '{func}' at "
                                f"{port_frame()}")
        return out


@contextlib.contextmanager
def checked_wrappers():
    """The outputs of every registered kernel wrapper (ops/cuda/build.
    WRAPPERS) checked for NaN under the wrapper's name, a ctypes launch
    being no aten operation; yields {wrapper name: calls checked}."""
    calls = dict.fromkeys(build.WRAPPERS, 0)

    def check(name, out):
        calls[name] = calls.get(name, 0) + 1
        if has_nan(out):
            raise SanitizeError(f"[sanitize] NaN produced by kernel wrapper '{name}' at "
                                f"{port_frame()}")

    saved, build.CHECK = build.CHECK, check
    try:
        yield calls
    finally:
        build.CHECK = saved


def trapped_generate(engine: TTSEngine, text: str, params: api.Params) -> dict:
    """engine.generate(text) under the NaN trap and the checked wrappers:
    {ops, kernel_calls, seconds}."""
    dev = engine.device
    t0 = time.perf_counter()
    with checked_wrappers() as calls, NanTrap() as trap:
        engine.generate(text, params=params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"ops": trap.ops, "kernel_calls": dict(calls), "seconds": time.perf_counter() - t0}


def phase_nan_trap(ctx: api.Context, dtype: torch.dtype = torch.float32,
                   verbose: bool = True) -> dict:
    """Phase 2: eager generates on a graphs=False engine: a warm-up, a
    timed one without the trap (``plain_seconds``), then two under it (the
    first's figures, and the second's seconds as ``seconds_warm``)."""
    engine = TTSEngine(ctx, dtype=dtype, graphs=False)
    if verbose:
        print(f"[sanitize] NaN trap: engine on {engine.device} with graphs=False (a replayed "
              f"CUDA graph shows no operation to the mode)")
    params = api.Params(num_frames=4, seed=7, num_steps=1)
    plain_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        engine.generate("Hello world", params=params)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        plain_s.append(time.perf_counter() - t0)
    out = trapped_generate(engine, "Hello world", params)
    out.update(seconds_warm=trapped_generate(engine, "Hello world", params)["seconds"],
               plain_seconds=plain_s[1], dtype="bf16" if dtype == torch.bfloat16 else "f32")
    return out


# -- phases 3 and 4: the stage-boundary guards --------------------------------------


def phase_stage_guards(ctx: api.Context) -> None:
    """Phase 3: PTTS_SANITIZE's guards over a clean generate raise nothing."""
    sanitize.set_enabled(True)
    try:
        TTSEngine(ctx).generate("Quiet please", params=api.Params(num_frames=4, seed=9,
                                                                   num_steps=1))
    finally:
        sanitize.set_enabled(None)


def phase_planted_nan(model_dir: str, cfgs: dict, device) -> str:
    """Phase 4: an engine whose ``out_norm_w`` holds a NaN must fail to
    build with a SanitizeError naming it; returns the error's text."""
    orig = flowlm.load_weights

    def poisoned(st, cfg, **kw):
        w = dict(orig(st, cfg, **kw))
        w["out_norm_w"] = np.array(w["out_norm_w"], np.float32)
        w["out_norm_w"][0] = np.nan
        return w

    bad = api.Context(model_dir, device=device, **cfgs)
    sanitize.set_enabled(True)
    flowlm.load_weights = poisoned
    try:
        TTSEngine(bad)
    except SanitizeError as e:
        if "out_norm_w" not in str(e):
            raise SanitizeError(f"the guard fired without naming out_norm_w: {e}") from e
        return str(e)
    finally:
        flowlm.load_weights = orig
        sanitize.set_enabled(None)
        bad.close()
    raise SanitizeError("the engine was built despite a NaN in out_norm_w")


# -- the sweep -----------------------------------------------------------------------


def run_phases(model_dir: str, device="cuda", flowlm_cfg: Optional[FlowLMConfig] = None,
               mimi_cfg: Optional[MimiConfig] = None):
    """The four phases on ``model_dir``; prints one line per phase and
    returns (failures, {phase number: its result}). Phase 1 runs only on a
    card; elsewhere it is reported as not run and is no failure."""
    cfgs = {k: v for k, v in (("flowlm_cfg", flowlm_cfg), ("mimi_cfg", mimi_cfg)) if v}
    failures, results = [], {}

    def phase(i: int, fn, *args):
        name = PHASES[i]
        try:
            results[i + 1] = fn(*args)
        except Exception as e:  # noqa: BLE001 -- every phase is reported, then the run fails
            print(f"[sanitize] FAIL: {name} -- {type(e).__name__}: {e}")
            failures.append(name)
            return
        detail = results[i + 1]
        print(f"[sanitize] PASS: {name}" + (f" -- {detail}" if detail else ""))

    if torch.device(device).type == "cuda":
        phase(0, phase_guarded, device)
    else:
        print(f"[sanitize] NOT RUN: {PHASES[0]} -- the kernels run only on a CUDA card")
    ctx = api.Context(model_dir, device=device, **cfgs)
    try:
        phase(1, phase_nan_trap, ctx)
        phase(2, phase_stage_guards, ctx)
    finally:
        ctx.close()
    phase(3, phase_planted_nan, model_dir, cfgs, device)
    print(f"[sanitize] {'ALL PASS' if not failures else 'FAILURES: ' + ', '.join(failures)}")
    return failures, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny configs of the CPU tests instead of full width")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("ptts_torch.tools.sanitize: no CUDA card is visible; pass --device cpu to run "
              "phases 2-4 on the CPU", file=sys.stderr)
        return 2
    cfgs = dict(flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI) if args.tiny else {}
    with tempfile.TemporaryDirectory(prefix="ptts_sanitize_") as d:
        path = synth.write_model_dir(d, seed=3, scale=0.3 if args.tiny else 0.05, **cfgs)
        failures, _ = run_phases(path, args.device, **cfgs)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
