"""The Mimi decode's share of an offline pass: the time of the
ptts.mimi_decode spans (the decode and its readback) inside the
ptts.batch_generate spans of the window's passes (those that end in the
traced run's window before its profiled stretch, so not the warm-up pass),
over the time of those batch_generate spans."""

from benchmark import spans


def read(obs):
    recs = spans.tracer_records() if obs.get("sub") is not None else None
    win = spans.host_window(obs, recs)
    if win is None:
        return None
    a, z = win
    parent = {r[4]: r[5] for r in recs if r[0] == "span"}
    passes = {r[4]: r[3] - r[2] for r in recs
              if r[0] == "span" and r[1] == "ptts.batch_generate" and a <= r[3] < z}
    if not passes:
        return None
    mimi = 0.0
    for kind, name, t0, t1, sid, up, _ in recs:
        if kind != "span" or name != "ptts.mimi_decode":
            continue
        while up and up not in passes:
            up = parent.get(up, 0)
        if up:
            mimi += t1 - t0
    return mimi / sum(passes.values()) * 100.0
