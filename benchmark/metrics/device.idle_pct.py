"""The device's idle share of the profiled stretch: one minus the union of
its kernel, copy and set intervals over the stretch's wall time."""


def read(obs):
    s = obs.get("sub_summary")
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return (1.0 - s["busy_s"] / s["window_s"]) * 100.0
