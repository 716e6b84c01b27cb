"""ptts_torch ops against their ptts_tpu counterparts on the same seeded
numpy inputs (f32 on the CPU; both sides compute in f32, so 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ptts_torch.ops import activations as t_act  # noqa: E402
from ptts_torch.ops import attention as t_attn  # noqa: E402
from ptts_torch.ops import conv as t_conv  # noqa: E402
from ptts_torch.ops import norms as t_norms  # noqa: E402
from ptts_torch.ops import rope as t_rope  # noqa: E402
from ptts_tpu.ops import activations as j_act  # noqa: E402
from ptts_tpu.ops import attention as j_attn  # noqa: E402
from ptts_tpu.ops import conv as j_conv  # noqa: E402
from ptts_tpu.ops import norms as j_norms  # noqa: E402
from ptts_tpu.ops import rope as j_rope  # noqa: E402

TOL = 1e-5


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("affine", [True, False])
def test_layernorm(affine):
    rng = np.random.default_rng(0)
    x = randn(rng, 4, 7, 16, scale=2.0) + 0.5
    w, b = (randn(rng, 16), randn(rng, 16)) if affine else (None, None)
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    close(t_norms.layernorm(T(x), T(w), T(b), 1e-5), j_norms.layernorm(J(x), J(w), J(b), 1e-5))


def test_kyutai_rmsnorm():
    rng = np.random.default_rng(1)
    x, alpha = randn(rng, 5, 16), 1.0 + randn(rng, 16, scale=0.1)
    close(t_norms.kyutai_rmsnorm(torch.from_numpy(x), torch.from_numpy(alpha), 1e-5),
          j_norms.kyutai_rmsnorm(jnp.asarray(x), jnp.asarray(alpha), 1e-5))


@pytest.mark.parametrize("name", ["gelu_erf", "gelu_tanh", "silu"])
def test_activations(name):
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    close(getattr(t_act, name)(torch.from_numpy(x)), getattr(j_act, name)(jnp.asarray(x)))


def test_rope_rotate_halves_and_permutation():
    rng = np.random.default_rng(2)
    B, T, H, D = 2, 9, 3, 8
    q, k = randn(rng, B, T, H, D), randn(rng, B, T, H, D)
    pos = np.arange(3, 3 + T)[None, :]
    tq, tk = t_rope.rope_rotate_halves(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(pos), 500.0)
    jq, jk = j_rope.rope_rotate_halves(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), 500.0)
    close(tq, jq)
    close(tk, jk)
    w = randn(rng, 2, 3 * H * D, 5)
    np.testing.assert_array_equal(t_rope.permute_qk_rows_for_rope(w, H, D),
                                  j_rope.permute_qk_rows_for_rope(w, H, D))
    np.testing.assert_array_equal(t_rope.rope_freqs(D, 500.0), j_rope.rope_freqs(D, 500.0))


@pytest.mark.parametrize("context,lengths", [(0, None), (4, None), (0, [3, 9])])
def test_causal_attention(context, lengths):
    rng = np.random.default_rng(3)
    q, k, v = (randn(rng, 2, 9, 2, 8) for _ in range(3))
    tl = None if lengths is None else torch.tensor(lengths)
    jl = None if lengths is None else jnp.asarray(lengths)
    got = t_attn.causal_attention(*map(torch.from_numpy, (q, k, v)), context=context, lengths=tl)
    want = j_attn.causal_attention(*map(jnp.asarray, (q, k, v)), context=context, lengths=jl)
    close(got, want)


@pytest.mark.parametrize("T,context,block", [(37, 9, 16), (40, 5, 8)])
def test_windowed_attention_local(T, context, block):
    rng = np.random.default_rng(4)
    q, k, v = (randn(rng, 2, T, 2, 8) for _ in range(3))
    got = t_attn.windowed_attention_local(*map(torch.from_numpy, (q, k, v)),
                                          context=context, block=block)
    want = j_attn.windowed_attention_local(*map(jnp.asarray, (q, k, v)),
                                           context=context, block=block)
    close(got, want)
    close(got, t_attn.causal_attention(*map(torch.from_numpy, (q, k, v)), context=context))


def test_decode_attention_masked():
    rng = np.random.default_rng(5)
    q, kc, vc = randn(rng, 3, 2, 8), randn(rng, 3, 11, 2, 8), randn(rng, 3, 11, 2, 8)
    mask = rng.random((3, 11)) < 0.6
    mask[:, 0] = True
    close(t_attn.decode_attention_masked(*map(torch.from_numpy, (q, kc, vc, mask))),
          j_attn.decode_attention_masked(*map(jnp.asarray, (q, kc, vc, mask))))


@pytest.mark.parametrize("k,stride,groups", [(5, 1, 1), (4, 2, 1), (3, 1, 4)])
def test_conv1d_causal(k, stride, groups):
    rng = np.random.default_rng(6)
    cin, cout = 8, 12
    x = randn(rng, 2, 10, cin)
    w_torch = randn(rng, cout, cin // groups, k)
    w = t_conv.prepare_conv_kernel(w_torch)
    np.testing.assert_array_equal(w, j_conv.prepare_conv_kernel(w_torch))
    b = randn(rng, cout)
    got = t_conv.conv1d_causal(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               stride=stride, groups=groups)
    want = j_conv.conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                stride=stride, groups=groups)
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("depthwise", [False, True])
def test_convtr1d_2s(depthwise):
    rng = np.random.default_rng(7)
    C, cout, s = 6, 4, 3
    x = randn(rng, 2, 5, C)
    w_torch = randn(rng, C, 1 if depthwise else cout, 2 * s)
    groups = C if depthwise else 1
    w1, w2 = t_conv.prepare_convtr_halves(w_torch, groups)
    for a, b in zip((w1, w2), j_conv.prepare_convtr_halves(w_torch, groups)):
        np.testing.assert_array_equal(a, b)
    bias = randn(rng, C if depthwise else cout)
    got = t_conv.convtr1d_2s(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2),
                             torch.from_numpy(bias), stride=s, depthwise=depthwise)
    want = j_conv.convtr1d_2s(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                              jnp.asarray(bias), stride=s, depthwise=depthwise)
    close(got, want)


def test_elu():
    x = np.linspace(-30, 5, 701, dtype=np.float32)
    close(t_conv.elu(torch.from_numpy(x)), j_conv.elu(jnp.asarray(x)))
