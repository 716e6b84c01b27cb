"""FlowLM's device time per pool frame: the busy union of the profiled
stretch's device events from each ptts_mark_flowlm marker kernel to the
next ptts_mark_mimi (the FlowLM frames of a replayed step, the harness's
frame tap among them), over the frames the pool stepped in it."""

from benchmark import spans


def read(obs):
    return spans.marker_ms_per_frame(obs, "ptts_mark_flowlm", "ptts_mark_mimi")
