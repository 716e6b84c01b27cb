"""Device time per pool frame: the union of the device's kernel, copy and
set intervals in the profiled stretch, over the frames the pool stepped in
it (steps times frames per step)."""


def read(obs):
    sub, info = obs.get("sub"), obs.get("sub_info") or {}
    if sub is None or not info.get("frames"):
        return None
    busy = obs["sub_summary"]["busy_s"]
    return busy / info["frames"] * 1e3 if busy > 0 else None
