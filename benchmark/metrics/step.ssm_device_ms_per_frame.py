"""The hybrid's Mamba mixers' device time per pool frame: the busy union of
the profiled stretch's device events from each ptts_mark_ssm_in marker
kernel to the next ptts_mark_ssm_out (each Mamba layer's core, from its
input projection's output to its gated norm's: the conv, the state update
and its read-out), summed over a frame's layers, over the frames the pool
stepped in it. A program without these markers reads None."""

from benchmark import spans


def read(obs):
    return spans.marker_ms_per_frame(obs, "ptts_mark_ssm_in", "ptts_mark_ssm_out")
