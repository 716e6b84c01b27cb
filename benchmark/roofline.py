"""The yardstick's arithmetic: the chip's published peaks, the kernels'
operations and bytes, and the model's operations per frame and per prompt
column, from the configuration's widths.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no sparsity,
at its 700 W limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
float32 outside them, 3.35 TB/s HBM3. A matmul counts 2 operations per
multiply-add; norms, activations, RoPE and softmax are left out, so a share
of the peak is a lower bound of the work done.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ESIZE = {"bf16": 2, "f32": 4}


def causal_pairs(lengths) -> int:
    """Query-key pairs of a causal prefill over prompts of these lengths:
    query q of a prompt of n columns sees keys 0..q."""
    return sum(n * (n + 1) // 2 for n in lengths)


def window_pairs(B: int, T: int, context: int) -> int:
    """Query-key pairs of B2: query q sees keys with 0 <= q - k < context."""
    c = min(T, context)
    return B * (c * (c + 1) // 2 + (T - c) * context)


def attention_bound(dtype: str, B: int, T: int, H: int, D: int, pairs: int, outputs: int,
                    v_rows: int) -> dict:
    """The fused attention kernels' least time (a copy of chip_smoke's
    attention_bound). Bytes: q and k of the [B, T, 3HD] projection read
    once, v only in the ``v_rows`` rows some query may see, ``outputs``
    [B, T, HD] tensors written once. FLOPs: 2 * D for q.k and 2 * D for p.v
    per (query, key, head) pair the mask lets through (``pairs`` counts
    them over the batch for one head); RoPE and the softmax left out."""
    nbytes = (B * T * (2 + outputs) + v_rows) * H * D * ESIZE[dtype]
    flops = 4 * D * H * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return dict(bytes=nbytes, flops=flops, bound_s=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def b1_bound_s(dtype: str, f: dict, lengths) -> float:
    """B1 over the admitted prompts' own lengths, in every layer of the
    stack (the prefill runs B1 once per layer): each prompt of n columns
    as its own [1, n] launch (q, k, v read in n rows; out and the rotated k
    written in n rows), the launch's padding rows not counted. The count
    is of the work, so it holds however the layers' launches are grouped."""
    H, D = f["num_heads"], f["head_dim"]
    return f["num_layers"] * sum(
        attention_bound(dtype, 1, n, H, D, causal_pairs([n]), 2, n)["bound_s"] for n in lengths)


def b2_bound_s(dtype: str, m: dict, shapes) -> float:
    """B2 at its launched shapes: {(B, T): launches}."""
    H, D, ctx = m["num_heads"], m["head_dim"], m["context"]
    return sum(k * attention_bound(dtype, B, T, H, D, window_pairs(B, T, ctx), 1, B * T)["bound_s"]
               for (B, T), k in shapes.items())


def _transformer_flops(d: int, hidden: int, layers: int) -> int:
    """Matmul operations of one position through the layer stack's
    projections (q, k, v, out, the two feed-forward matrices)."""
    return layers * 2 * (3 * d * d + d * d + 2 * d * hidden)


def flow_net_flops(f: dict, num_steps: int = 1) -> int:
    """One frame's flow-matching sampler: per step the input, condition and
    two time-embedding projections, each residual block's modulation and
    two-layer MLP, the final modulation and projection."""
    fd, lat, d, tf = f["flow_dim"], f["latent_dim"], f["d_model"], f["time_freqs"]
    per_step = (lat * fd + d * fd + 2 * (2 * tf * fd + fd * fd)
                + f["flow_depth"] * (3 * fd * fd + 2 * fd * fd)
                + 2 * fd * fd + fd * lat)
    return 2 * num_steps * per_step


def flowlm_prefill_flops(f: dict, lengths) -> int:
    """A prefill of prompts of these lengths: every column through the
    stack, causal attention over its predecessors."""
    cols = sum(lengths)
    attn = 4 * f["head_dim"] * f["num_heads"] * causal_pairs(lengths) * f["num_layers"]
    return cols * _transformer_flops(f["d_model"], f["hidden"], f["num_layers"]) + attn


def flowlm_frame_flops(f: dict, keys: int, num_steps: int = 1) -> int:
    """One stream's AR frame with ``keys`` cached columns in view: the
    latent's input projection, one position through the stack, attention
    over the keys, the EOS head and the sampler."""
    d = f["d_model"]
    attn = 4 * f["head_dim"] * f["num_heads"] * keys * f["num_layers"]
    return (2 * f["latent_dim"] * d + _transformer_flops(d, f["hidden"], f["num_layers"])
            + attn + 2 * d + flow_net_flops(f, num_steps))


def mimi_frame_flops(m: dict, frame: int) -> int:
    """One frame's Mimi decode (frame index ``frame`` of its utterance):
    the quantizer projection, the depthwise upsample, upsample_stride
    transformer positions with windowed attention, the SEANet stack."""
    d, s = m["d_model"], m["upsample_stride"]
    flops = 2 * m["latent_dim"] * d + 2 * 2 * s * d  # depthwise: 2 taps per output
    keys = sum(min(p + 1, m["context"]) for p in range(frame * s, frame * s + s))
    flops += s * _transformer_flops(d, m["hidden"], m["num_layers"])
    flops += 4 * m["head_dim"] * m["num_heads"] * keys * m["num_layers"]
    mult = 2 ** len(m["ratios"])
    nf = m["n_filters"]
    t = s                                    # samples of this frame at each stage
    flops += 2 * t * d * mult * nf * m["kernel_size"]
    for r in m["ratios"]:
        cin, cout = mult * nf, mult * nf // 2
        hid = cout // m["compress"]
        t *= r
        flops += 2 * t * cin * cout * 2      # transposed conv: 2 taps per output
        flops += 2 * t * (cout * hid * m["residual_kernel"] + hid * cout)
        mult //= 2
    flops += 2 * t * nf * m["last_kernel_size"]
    return flops


def stream_frame_flops(f: dict, m: dict, prompt_len: int, frame: int,
                       num_steps: int = 1) -> int:
    """Everything one delivered 80 ms chunk costs: its FlowLM frame (the
    prompt and the frames before it in view) and its Mimi decode."""
    return (flowlm_frame_flops(f, prompt_len + frame + 1, num_steps)
            + mimi_frame_flops(m, frame))


def stream_flops(f: dict, m: dict, prompt_len: int, f0: int, f1: int,
                 num_steps: int = 1) -> int:
    """stream_frame_flops summed over frames f0 .. f1 - 1 of one stream."""
    n = f1 - f0
    if n <= 0:
        return 0
    attn = 4 * f["head_dim"] * f["num_heads"] * f["num_layers"]
    keys = n * (prompt_len + 1) + (f0 + f1 - 1) * n // 2
    total = n * flowlm_frame_flops(f, 0, num_steps) + attn * keys
    # Mimi's windowed attention saturates once a frame's positions all
    # see the whole window; before that, frame by frame
    sat = -(-m["context"] // m["upsample_stride"])
    early = range(f0, min(f1, sat))
    total += sum(mimi_frame_flops(m, fr) for fr in early)
    total += max(0, f1 - max(f0, sat)) * mimi_frame_flops(m, sat)
    return total
