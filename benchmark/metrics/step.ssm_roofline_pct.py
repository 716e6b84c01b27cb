"""The Mamba mixers' cores against their byte bound: the bytes they must
move in one pool frame (benchmark/hybrid.ssm_bytes_per_frame: each
layer's SSM and conv state read and written once in its dtype, z, xBC and
dt read, y written, for every row of the pool) at 3.35 TB/s, over their
device time per frame (as step.ssm_device_ms_per_frame reads it), in
percent."""

from benchmark import roofline, spans


def read(obs):
    nbytes = obs.get("ssm_bytes_per_frame")
    ms = spans.marker_ms_per_frame(obs, "ptts_mark_ssm_in", "ptts_mark_ssm_out")
    if not nbytes or not ms:
        return None
    return nbytes / roofline.HBM_BYTES_PER_S / (ms * 1e-3) * 100.0
