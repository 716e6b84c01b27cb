"""The launching thread's time per batcher step: the batcher's own phase_s
"dispatch" (the ptts.dispatch span: every shard's step launched in turn and
its readback started), over its steps, in the traced run's window before
its profiled stretch."""


def read(obs):
    ph, n = obs.get("host_phase_s"), obs.get("host_steps")
    if not ph or not n or "dispatch" not in ph:
        return None
    return ph["dispatch"] / n * 1e3
