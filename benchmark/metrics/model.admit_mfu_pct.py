"""The whole admission step's share of the chip's peak: the FlowLM prefill
FLOPs of the prompts admitted (at their own lengths), over the batcher's
admission host time (phase_s admit + admit_wait) times the peak of the
configuration's dtype, in the traced run's window before its profiled
stretch."""

from benchmark import roofline


def read(obs):
    lengths, ph = obs.get("admitted_lengths"), obs.get("host_phase_s")
    if not lengths or not ph:
        return None
    wall = ph.get("admit", 0.0) + ph.get("admit_wait", 0.0)
    if wall <= 0:
        return None
    flops = roofline.flowlm_prefill_flops(obs["cfg"]["flowlm"], lengths)
    return flops / (wall * roofline.PEAK_FLOPS[obs["dtype"]]) * 100.0
