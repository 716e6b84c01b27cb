"""The registry of the port's hand-written kernels (ops/cuda/build) on the
CPU: every C entry point of ptts_torch/csrc is declared once, by the module
that calls it, with as many arguments as its C definition takes; every
registered wrapper's symbol is one of them; shape keys of both arities
print and parse back.
"""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from ptts_torch.models import flowlm  # noqa: E402,F401  (imports every kernel module)
from ptts_torch.ops.cuda import build, markers  # noqa: E402,F401

PKG = Path(build.__file__).resolve().parents[2]


def entry_points() -> dict:
    """{symbol: number of parameters} of the functions inside the
    ``extern "C" { ... }`` blocks of ptts_torch/csrc/*.cu."""
    out = {}
    for src in sorted((PKG / "csrc").glob("*.cu")):
        for block in re.findall(r'^extern "C" \{\n(.*?)^\}  // extern "C"', src.read_text(),
                                re.S | re.M):
            for name, params in re.findall(r"^[\w ]+\*? ?(ptts_\w+)\(([^)]*)\)", block, re.M):
                out[name] = 0 if params.strip() in ("", "void") else params.count(",") + 1
    return out


ENTRY_POINTS = entry_points()


def test_every_entry_point_is_found():
    assert {"ptts_causal_attn_qkv", "ptts_window_attn_qkv", "ptts_decode_attn",
            "ptts_ssm_step", "ptts_mark", "ptts_error_string",
            "ptts_attr_calls"} <= set(ENTRY_POINTS)


@pytest.mark.parametrize("symbol", sorted(ENTRY_POINTS))
def test_entry_point_declared_once(symbol):
    """One declaration in the package (build.declare or @build.kernel),
    its argtypes as long as the C parameter list."""
    decl = re.compile(r'\b(?:declare|kernel)\(\s*"%s"' % symbol)
    found = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
             for _ in decl.finditer(p.read_text())]
    assert len(found) == 1, found
    argtypes, _ = build.SIGNATURES[symbol]
    assert len(argtypes) == ENTRY_POINTS[symbol]


def test_registered_wrappers_launch_declared_entry_points():
    assert {"causal_attention_qkv", "window_attention_qkv", "decode_attention",
            "ssm_step"} <= set(build.WRAPPERS)
    for name, fn in build.WRAPPERS.items():
        assert fn.__name__ == name and fn.symbol in ENTRY_POINTS
        assert isinstance(fn.launches, int) and hasattr(fn.shapes, "update")
    assert set(build.SIGNATURES) == set(ENTRY_POINTS)


@pytest.mark.parametrize("key,label", [
    (("bf16", 256, 544), "bf16 B=256 T=544"),
    (("f32", 257, 544, 32, 8), "f32 B=257 T=544 H=32 Hkv=8"),
], ids=["three_fields", "five_fields"])
def test_shape_label(key, label):
    """Kernel shape keys (dtype, B, T) and the grouped decode attention's
    (dtype, B, Tmax, H, Hkv) print as one label and parse back."""
    assert build.shape_label(key) == label
    assert build.parse_shape_label(label) == key
