"""The whole model's share of the chip's peak: FLOPs of the audio
delivered in the window (each chunk's FlowLM frame with its keys in view
and its Mimi decode, roofline.stream_flops), over the window times the
peak of the configuration's dtype."""

from benchmark import roofline


def read(obs):
    flops, window = obs.get("delivered_flops"), obs.get("flops_window_s")
    if not flops or not window:
        return None
    return flops / (window * roofline.PEAK_FLOPS[obs["dtype"]]) * 100.0
