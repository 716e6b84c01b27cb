"""B1 (fused RoPE + causal prefill attention) against its roofline: the
least time the admitted prompts' own lengths need in all the stack's
layers (bytes at 3.35 TB/s or FLOPs at the dtype's peak, the launch's
padding rows not counted), over the device time of B1's kernel events in
the profiled stretch."""

import re

from benchmark import roofline

B1 = re.compile(r"attn_(f32|bf16)_kernel<\d+,\s*false>|attn_(f32|bf16)_kernel\w*Lb0E")


def read(obs):
    sub, info = obs.get("sub"), obs.get("sub_info") or {}
    lengths = info.get("admitted")
    if sub is None or not lengths:
        return None
    t = sub.kernel_time_s(lambda n: B1.search(n) is not None)
    if t <= 0:
        return None
    return roofline.b1_bound_s(obs["dtype"], obs["cfg"]["flowlm"], lengths) / t * 100.0
