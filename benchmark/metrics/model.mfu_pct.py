"""The whole model's share of the peak of the cards it runs on: FLOPs of
the audio delivered in the window (each chunk's FlowLM frame with its keys
in view and its Mimi decode, roofline.stream_flops), over the window times
the cell's chips times one chip's peak in the configuration's dtype."""

from benchmark import roofline


def read(obs):
    flops, window = obs.get("delivered_flops"), obs.get("flops_window_s")
    if not flops or not window:
        return None
    chips = obs.get("chips", 1)
    return flops / (window * chips * roofline.PEAK_FLOPS[obs["dtype"]]) * 100.0
