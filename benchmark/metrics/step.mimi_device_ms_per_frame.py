"""The streaming Mimi decode's device time per pool frame: the busy union
of the profiled stretch's device events from each ptts_mark_mimi marker
kernel to the next ptts_mark_end, over the frames the pool stepped in it."""

from benchmark import spans


def read(obs):
    return spans.marker_ms_per_frame(obs, "ptts_mark_mimi", "ptts_mark_end")
