"""B2 (fused RoPE + windowed attention of the Mimi decoder) against its
roofline at the shapes it was launched at in the profiled stretch (the
kernel wrapper's launch counter), over the device time of B2's kernel
events there."""

import re

from benchmark import roofline

B2 = re.compile(r"attn_(f32|bf16)_kernel<\d+,\s*true>|attn_(f32|bf16)_kernel\w*Lb1E")


def read(obs):
    sub, shapes = obs.get("sub"), obs.get("b2_shapes")
    if sub is None or not shapes:
        return None
    t = sub.kernel_time_s(lambda n: B2.search(n) is not None)
    if t <= 0:
        return None
    return roofline.b2_bound_s(obs["dtype"], obs["cfg"]["mimi"], shapes) / t * 100.0
