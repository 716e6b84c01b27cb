"""From admission to first audio inside the batcher: per request, the start
of the ptts.admit_group span that admitted it to its ptts.first_chunk event
(the program's own stamps), p95 over the first chunks that landed in the
traced run's window before its profiled stretch."""

import numpy as np

from benchmark import spans


def read(obs):
    recs = spans.tracer_records() if obs.get("sub") is not None else None
    win = spans.host_window(obs, recs)
    if win is None:
        return None
    a, z = win
    admitted, waits = {}, []
    for kind, name, t0, _, _, _, data in recs:    # in order: a rid's newest admission
        if kind == "span" and name == "ptts.admit_group" and data:
            for rid in data["rids"]:
                admitted[rid] = t0
        elif kind == "event" and name == "ptts.first_chunk" and a <= t0 < z:
            t_admit = admitted.get(data["rid"])
            if t_admit is not None:
                waits.append(t0 - t_admit)
    if not waits:
        return None
    return float(np.percentile(np.asarray(waits, np.float64), 95)) * 1e3
