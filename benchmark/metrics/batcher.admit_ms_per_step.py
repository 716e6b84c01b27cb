"""Admission's host time per batcher step: the batcher's own phase_s
"admit" (group assembly and launches) plus "admit_wait" (the rest of the
admission window), over its steps, in the traced run's window before its
profiled stretch."""


def read(obs):
    ph, n = obs.get("host_phase_s"), obs.get("host_steps")
    if not ph or not n:
        return None
    return (ph.get("admit", 0.0) + ph.get("admit_wait", 0.0)) / n * 1e3
