"""FlowLM's decode attention wrapper (ptts_torch/ops/cuda/decode_attention) on
the CPU.

On a CPU tensor the wrapper computes the plain version,
ops/attention.decode_attention_masked, bit for bit; on any other device it
launches the kernel or raises, with no fallback. The kernel itself is held
to the plain version on the card, with NaN in the masked columns:
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import TINY_FLOWLM  # noqa: E402
from ptts_torch import convert  # noqa: E402
from ptts_torch.config import KernelFlags  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.ops import attention as tattn  # noqa: E402
from ptts_torch.ops.cuda import build  # noqa: E402
from ptts_torch.ops.cuda import decode_attention as tda  # noqa: E402
from ptts_tpu.models import flowlm as jfl  # noqa: E402

H, D = 2, 64
T0, RING = 8, 16          # prefix columns, then a 16-column decode ring
CURSOR = T0 + 2 * RING + 5  # the ring has wrapped twice


def ring_mask(prefix_len, start) -> torch.Tensor:
    """KVCache.valid_mask of a [1, B, T0 + RING, H, D] cache at CURSOR."""
    B = len(prefix_len)
    k = torch.zeros(1, B, T0 + RING, H, D)
    cache = tfl.KVCache(k=k, v=k, prefix_len=torch.tensor(prefix_len, dtype=torch.int32),
                        start=torch.tensor(start, dtype=torch.int32),
                        cursor=torch.tensor(CURSOR, dtype=torch.int32), t0=T0)
    return cache.valid_mask(through_cursor=True)


# (prefix_len, start) per row: the cursor's column is valid from start <= CURSOR on
MASKS = {
    "wrapped_ring": ([8, 3], [CURSOR - 40, CURSOR - 6]),
    "prefix_only": ([5, 8], [CURSOR + 1, CURSOR + 1]),
    "one_column": ([0, 1], [CURSOR, CURSOR + 1]),
    "no_column": ([0], [CURSOR + 1]),
    "mixed": ([8, 3, 5, 0, 0, 1], [CURSOR - 40, CURSOR - 6, CURSOR + 1, CURSOR, CURSOR + 1,
                                   CURSOR + 1]),
}


def inputs(case: str, dtype, seed: int = 0):
    mask = ring_mask(*MASKS[case])
    B, Tmax = mask.shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               for s in ((B, H, D), (B, Tmax, H, D), (B, Tmax, H, D)))
    return q, k, v, mask


def test_masks_hold_the_rows_they_name():
    counts = {case: ring_mask(*MASKS[case]).sum(dim=1).tolist() for case in MASKS}
    assert counts["wrapped_ring"] == [T0 + RING, 3 + 7]
    assert counts["prefix_only"] == [5, 8]
    assert counts["one_column"] == [1, 1]
    assert counts["no_column"] == [0]
    # the wrapped row's decode columns straddle the ring's end
    row = ring_mask(*MASKS["wrapped_ring"])[1, T0:]
    assert row[0] and row[-1] and not row.all()


@pytest.mark.parametrize("case", list(MASKS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrapper_on_cpu_is_the_plain_version_bit_for_bit(case, dtype):
    q, k, v, mask = inputs(case, dtype)
    launches = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, mask)
    want = tattn.decode_attention_masked(q, k, v, mask)
    assert got.dtype == dtype and torch.equal(got, want)
    assert tda.decode_attention.launches == launches   # the plain version is no launch


@pytest.mark.parametrize("batch,tmax,splits", [
    (256, 544, 3),     # bf16-serve-long's pool
    (256, 128, 3),     # bf16-serve-short's pool
    (16, 528, 17),     # f32-offline-long's length groups
    (1, 100, 4),       # Context.stream
    (1, 5000, 157),    # a long single stream: no split narrower than 32 columns
    (600, 20000, 20),  # enough splits that each share fits the kernel's list
])
def test_split_count_follows_the_shapes(batch, tmax, splits):
    assert tda.splits_for(batch, tmax, 132) == splits
    assert -(-tmax // splits) <= tda.MAX_SPLIT_COLS


@pytest.mark.parametrize("impl,called", [("auto", "kernel"), ("einsum", "plain")])
def test_decode_impl_on_the_cpu_takes_the_plain_version(monkeypatch, impl, called):
    """"auto" goes through the kernel's wrapper (which computes the plain
    version on a CPU tensor), "einsum" straight to the plain version."""
    calls = []

    def spy(name, fn):
        def wrapped(*a):
            calls.append(name)
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tfl, "decode_attention", spy("kernel", tda.decode_attention))
    monkeypatch.setattr(tfl, "decode_attention_masked",
                        spy("plain", tattn.decode_attention_masked))
    q, k, v, mask = inputs("mixed", torch.float32)
    got = tfl._decode_attention_dispatch(q, k, v, mask, None, KernelFlags(decode_impl=impl))
    assert calls == [called]
    assert torch.equal(got, tattn.decode_attention_masked(q, k, v, mask))


@pytest.mark.parametrize("value", ["kernel", "cuda", "masked"])
def test_unknown_decode_impl_raises(value):
    with pytest.raises(ValueError, match="decode_impl"):
        KernelFlags(decode_impl=value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_step_auto_equals_einsum_on_the_cpu(dtype):
    """A tiny FlowLM's decode steps past a ring wrap: "auto" and "einsum"
    give the same outputs and caches, bit for bit."""
    cfg = TINY_FLOWLM
    rng = np.random.default_rng(5)
    w = convert.flowlm_weights(jfl.random_weights(cfg, seed=3, scale=0.3), cfg, dtype)
    x = torch.from_numpy((rng.standard_normal((2, 4, cfg.d_model)) * 0.5).astype(np.float32))
    lens = torch.tensor([4, 2], dtype=torch.int32)
    runs = []
    for impl in ("auto", "einsum"):
        cache, _ = tfl.prefill_init(w, x.to(dtype), lens, cfg, 4 + 3, attn_impl="plain")
        outs = []
        for step in range(7):
            inp = torch.from_numpy((np.random.default_rng(step).standard_normal(
                (2, cfg.d_model)) * 0.5).astype(np.float32)).to(dtype)
            cache, out = tfl.decode_step(w, cache, inp, cfg, KernelFlags(decode_impl=impl))
            outs.append(out)
        runs.append((torch.stack(outs), cache.k.clone(), cache.v.clone()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def meta_inputs(B=4, T=40, H=16, D=64, dtype=torch.bfloat16, mask_dtype=torch.bool,
                k_dtype=None, mask_t=None, q_b=None, strided=False):
    """Meta stand-ins for CUDA tensors: q, k_cache, v_cache, mask."""
    k = (meta((B, 2 * T, H, D), k_dtype or dtype)[:, ::2] if strided
         else meta((B, T, H, D), k_dtype or dtype))
    return (meta((q_b or B, H, D), dtype), k, meta((B, T, H, D), dtype),
            meta((B, mask_t or T), mask_dtype))


REFUSED = {
    "head_dim_32": (dict(D=32), "head_dim 64"),
    "float16": (dict(dtype=torch.float16), "float32 or bfloat16"),
    "f32_32_heads": (dict(H=32, dtype=torch.float32), "must divide"),
    "mixed_dtypes": (dict(k_dtype=torch.float32), "share a dtype"),
    "int_mask": (dict(mask_dtype=torch.int32), "mask must be bool"),
    "mask_width": (dict(mask_t=41), "do not agree"),
    "q_batch": (dict(q_b=5), "do not agree"),
    "strided_cache": (dict(strided=True), "contiguous"),
    "no_cpu_or_cuda": (dict(), "CUDA device"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_off_cpu_inputs_the_kernel_refuses_raise_without_fallback(monkeypatch, case):
    """Off the CPU (a meta tensor stands in for a CUDA one here) the wrapper
    raises on what the kernel does not take: it neither computes the plain
    version nor reaches the library."""
    def refuse(*a, **k):
        raise AssertionError("fell back")

    monkeypatch.setattr(tda, "decode_attention_masked", refuse)
    monkeypatch.setattr(build, "library", refuse)
    kw, match = REFUSED[case]
    with pytest.raises((ValueError, TypeError), match=match):
        tda.decode_attention(*meta_inputs(**kw))
