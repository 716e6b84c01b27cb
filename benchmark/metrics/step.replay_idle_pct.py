"""The device's idle share while the host replays a graph: the idle gaps of
the profiled stretch whose midpoint falls inside a ptts.graph.replay range
(the host in cudaGraphLaunch with nothing queued), over the stretch's
wall time."""

from benchmark import spans


def read(obs):
    sub = obs.get("sub")
    idle = spans.idle_inside(sub, "ptts.graph.replay")
    if idle is None or sub.window_s <= 0:
        return None
    return idle / sub.window_s * 100.0
