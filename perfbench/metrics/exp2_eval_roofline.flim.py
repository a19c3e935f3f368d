"""exp2_eval_roofline.flim: the p = 2 exp-sum kernel's share of its bound
over the traced slice, in %: the launches of ``varpro_exp2_eval`` in the
device trace times each launch's least time, the frame's observations Y
(B, m) read once at the HBM peak (B m element bytes over
harness/roofline.HBM_BYTES_PER_MS: 0.0200 ms at B = 65536, m = 256 in
float32), over the kernel's device time. Every launch reads the whole
frame, so this bound holds for any implementation and the share cannot
pass 100; operations are left out, so that no count of them can go
stale. None where the trace holds no such launch."""

import torch

from harness import roofline

KERNEL = "varpro_exp2_eval"


def read(run):
    if run.trace is None:
        return None
    launches = [end - start for name, start, end in run.trace.events if KERNEL in name]
    device_ms = sum(launches) / 1e6
    if not launches or device_ms <= 0:
        return None
    config = run.cell.config
    frame_bytes = config["batch"] * config["points"] * getattr(torch, config["dtype"]).itemsize
    return 100.0 * len(launches) * (frame_bytes / roofline.HBM_BYTES_PER_MS) / device_ms
