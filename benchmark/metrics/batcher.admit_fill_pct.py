"""How much of the launched admission is prompt: the batcher's counters
admit.positions (the admitted prompts' positions, voice frames + ids + 1)
over admit.launched_positions (admit_chunk x prefix_budget per launch), in
the traced run's window before its profiled stretch."""

from benchmark import spans


def read(obs):
    recs = spans.window_records(obs)
    if recs is None:
        return None
    used = sum(r[6] for r in recs if r[0] == "count" and r[1] == "admit.positions")
    launched = sum(r[6] for r in recs if r[0] == "count" and r[1] == "admit.launched_positions")
    return used / launched * 100.0 if launched else None
