"""The port's bf16 cold start against the JAX package (tiny configs, CPU):
SafetensorsFile.get_bf16, utils/packing.tree_to_device, flowlm/mimi
to_device, the bf16 load_weights, and the bf16 engine.

Gates: bit equality wherever both packages round the same values the same
way (compared as uint16/uint32 bits); every packed leaf starts at a
256-byte-aligned address; bf16 generation within 8% of max, the gate of
tests/test_bf16.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch.io.safetensors import SafetensorsFile as TFile  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.models import mimi as tmi  # noqa: E402
from ptts_torch.runtime.engine import TTSEngine  # noqa: E402
from ptts_torch.utils.packing import ALIGN, tree_to_device  # noqa: E402
from ptts_tpu import api as japi  # noqa: E402
from ptts_tpu.io.safetensors import SafetensorsFile as JFile  # noqa: E402
from ptts_tpu.io.safetensors import save_safetensors  # noqa: E402
from ptts_tpu.models import flowlm as jfl  # noqa: E402
from ptts_tpu.models import mimi as jmi  # noqa: E402
from ptts_tpu.runtime.engine import TTSEngine as JEngine  # noqa: E402
from ptts_tpu.utils import packing as jpacking  # noqa: E402

FC, MC = TINY_FLOWLM, TINY_MIMI
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def bits(x) -> np.ndarray:
    """The raw bits of a torch tensor, a jax array or a numpy array (bf16 as
    uint16, f32 as uint32), for bit-equality checks."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def leaves(tree, path=""):
    """(path, leaf) of nested dicts/lists, None included."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}.{i}")
    else:
        yield path, tree


def module_leaves(module):
    """(path, buffer) of a convert.TensorTree in the host dict's order."""
    for name, buf in module.named_buffers():
        yield name, buf


def mixed_tree():
    rng = np.random.default_rng(3)
    return {
        "w": rng.standard_normal((7, 33), dtype=np.float32),
        "nested": {
            "b": rng.standard_normal(129, dtype=np.float32) * 1e-3,
            "idx": np.arange(5, dtype=np.int32),   # non-float: copied as is
            "flag": True,                          # Python scalar: passes through
            "none": None,
        },
        "f64": rng.standard_normal((4, 4)),        # float64 leaf
        "odd": rng.standard_normal((1, 1, 3), dtype=np.float32),
        "scalar": np.float32(0.125).reshape(()),   # 0-d leaf
        "list": [rng.standard_normal(3, dtype=np.float32), None],
    }


@pytest.mark.parametrize("storage", ["BF16", "F16", "F32"])
def test_get_bf16_bits_match_jax(tmp_path, storage):
    """get_bf16 on BF16-, F16- and F32-stored tensors: the bits of the JAX
    package's get_bf16 (ml_dtypes round to nearest even), ties, subnormals,
    infinities and large values included."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((5, 67)) * 3).astype(np.float32)
    x[0, :6] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -(1.0 + 2 ** -8), 1e-40, np.inf, 3e38]
    if storage == "F16":
        x[0, 5] = 65504.0  # f16's largest finite value
        x = x.astype(np.float16)
    path = str(tmp_path / "t.safetensors")
    save_safetensors(path, {"x": x, "s": np.float32(2.5).reshape(())},
                     bf16=("x", "s") if storage == "BF16" else ())
    for name in ("x", "s"):
        got, want = read_bits(TFile, path, name), read_bits(JFile, path, name)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)


def read_bits(file_cls, path, name):
    """The uint16 bits of one tensor's get_bf16, copied out, so no view of
    the mmap outlives the file (closing it with views alive raises)."""
    with file_cls(path) as f:
        t = f.get_bf16(f.find(name))
        if isinstance(t, torch.Tensor):
            assert t.dtype == torch.bfloat16
        out = bits(t).copy()
        del t
    return out


def test_get_bf16_is_a_zero_copy_view_of_bf16_storage(tmp_path, recwarn):
    path = str(tmp_path / "t.safetensors")
    save_safetensors(path, {"x": np.ones((3, 8), np.float32)}, bf16=("x",))
    with TFile(path) as tf:
        entry = tf.find("x")
        got = tf.get_bf16(entry)
        assert got.data_ptr() == np.frombuffer(tf.raw(entry), np.uint8).ctypes.data
        assert not [w for w in recwarn.list if "not writable" in str(w.message)]
        del got


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tree_to_device_matches_jax_bit_for_bit(dtype):
    tdt, jdt = DTYPES[dtype]
    tree = mixed_tree()
    shapes = {path: np.shape(x) for path, x in leaves(tree)}
    got = dict(leaves(tree_to_device(tree, tdt, "cpu")))
    want = dict(leaves(jpacking.tree_to_device(tree, jdt)))
    assert got.keys() == want.keys()
    flats = set()
    for path, w in want.items():
        g = got[path]
        if w is None or isinstance(w, bool):
            assert g is w, path
            continue
        # the JAX pack turns a 0-d leaf into [1] (np.ascontiguousarray); the
        # port keeps the host shape
        assert isinstance(g, torch.Tensor) and tuple(g.shape) == shapes[path], path
        if path.endswith("idx"):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            continue
        assert g.dtype == tdt, path
        assert g.data_ptr() % ALIGN == 0, path
        np.testing.assert_array_equal(bits(g).ravel(), bits(np.asarray(w)).ravel(), err_msg=path)
        flats.add(g.untyped_storage().data_ptr())
    assert len(flats) == 1  # every float leaf is a view of one flat buffer


def test_tree_to_device_stats_and_empty_trees():
    stats = {}
    out = tree_to_device({"a": np.ones(3, np.float32)}, torch.float32, "cpu", stats)
    assert set(stats) == {"pack", "copy"} and all(v >= 0 for v in stats.values())
    assert out["a"].tolist() == [1.0, 1.0, 1.0]
    assert tree_to_device({"n": None, "k": 3}, torch.float32) == {"n": None, "k": 3}


@pytest.fixture(scope="module")
def bf16_dir(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("bf16model"), seed=6, bf16=True)
    return path


@pytest.fixture(scope="module")
def f32_dir(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("f32model"), seed=6)
    return path


@pytest.mark.parametrize("storage", ["bf16", "f32"])
def test_bf16_load_weights_match_jax_leaf_for_leaf(bf16_dir, f32_dir, storage):
    """flowlm.load_weights(dtype=bfloat16): the JAX bf16 load's bits; a
    BF16-stored single tensor is a view of the checkpoint mmap."""
    path = f"{bf16_dir if storage == 'bf16' else f32_dir}/tts_b6369a24.safetensors"
    tf, jf = TFile(path), JFile(path)  # left open: the loads are views of them
    got = dict(leaves(tfl.load_weights(tf, FC, dtype=torch.bfloat16)))
    want = dict(leaves(jfl.load_weights(jf, FC, dtype=ml_dtypes.bfloat16)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        if w is None:
            assert got[name] is None, name
            continue
        assert got[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(bits(got[name]), bits(w), err_msg=name)
    if storage == "bf16":
        entry = tf.find("conditioner.embed.weight")
        assert got[".embed"].data_ptr() == np.frombuffer(tf.raw(entry), np.uint8).ctypes.data


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_to_device_matches_jax_bit_for_bit(dtype):
    """flowlm/mimi.to_device (permutation + one packed copy) == the JAX
    to_device, leaf for leaf, each leaf 256-byte aligned."""
    tdt, jdt = DTYPES[dtype]
    fhost, mhost = jfl.random_weights(FC, seed=0), jmi.random_weights(MC, seed=1)
    for got, want in ((tfl.to_device(fhost, tdt, FC, "cpu"), jfl.to_device(fhost, jdt, FC)),
                      (tmi.to_device(mhost, tdt, MC, "cpu"), jmi.to_device(mhost, jdt, MC))):
        got = dict(module_leaves(got))
        want = {p[1:]: w for p, w in leaves(want) if w is not None and not isinstance(w, int)}
        assert got.keys() == want.keys()
        for name, w in want.items():
            assert got[name].dtype == tdt and got[name].data_ptr() % ALIGN == 0, name
            # JAX packs the 0-d out_eos_b as [1]; compare the bits flat
            np.testing.assert_array_equal(bits(got[name]).ravel(), bits(np.asarray(w)).ravel(),
                                          err_msg=name)


def test_bf16_to_device_takes_a_bf16_host_tree(bf16_dir):
    """The Q/K permutation works on a bf16 host tree (torch tensors): the
    device in_proj equals the f32 route's rounded to bf16."""
    with TFile(f"{bf16_dir}/tts_b6369a24.safetensors") as tf:
        w16 = tfl.to_device(tfl.load_weights(tf, FC, dtype=torch.bfloat16), torch.bfloat16, FC)
        w32 = tfl.to_device(tfl.load_weights(tf, FC), torch.bfloat16, FC)
        # the packed weights are copies: the file closes with no view left
    for (n16, a), (n32, b) in zip(module_leaves(w16), module_leaves(w32)):
        assert n16 == n32
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=n16)


@pytest.fixture(scope="module")
def engines(bf16_dir):
    kw = dict(flowlm_cfg=FC, mimi_cfg=MC)
    tctx, jctx = tapi.Context(bf16_dir, device="cpu", **kw), japi.Context(bf16_dir, **kw)
    return (TTSEngine(tctx, dtype=torch.bfloat16), JEngine(jctx, dtype=jnp.bfloat16),
            JEngine(jctx, dtype=jnp.float32))


def test_bf16_engine_host_copies_match_jax(engines):
    """The prompt tables (embed, input_linear, bos_emb) are the bf16 load
    widened to f32, bit for bit the JAX bf16 engine's."""
    tb, jb, _ = engines
    for name in ("_embed", "_input_linear", "_bos_emb"):
        got, want = getattr(tb, name), getattr(jb, name)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=name)
    assert set(tb.weights_s) == {"read", "pack", "copy"}
    assert tb.fw.in_proj.dtype == tb.mw.transformer.in_proj.dtype == torch.bfloat16


@pytest.mark.parametrize("ref", ["jax_bf16", "jax_f32"])
def test_bf16_generate_full_within_the_bf16_gate(engines, ref):
    """bf16 generate_full against the JAX engine: latents (3 frames, as
    tests/test_bf16.py) and PCM within 8% of max."""
    tb, jb, jf = engines
    p = japi.Params(seed=2, num_frames=3, eos_enabled=False)
    got = tb.generate_full("Hello world!", params=p)
    want = (jb if ref == "jax_bf16" else jf).generate_full("Hello world!", params=p)
    assert got.frames_used == want.frames_used == 3
    for a, b in ((got.latents, want.latents), (got.audio.samples, want.audio.samples)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a - b).max() <= 0.08 * np.abs(b).max()
