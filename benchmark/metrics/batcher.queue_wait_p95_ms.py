"""Queue wait: from the moment a request was due to the start of the
batcher step that admitted it (harness clock), p95 over the requests
admitted in the traced run's window before its profiled stretch."""

import numpy as np


def read(obs):
    w = obs.get("queue_wait_s")
    if not w:
        return None
    return float(np.percentile(np.asarray(w, np.float64), 95)) * 1e3
