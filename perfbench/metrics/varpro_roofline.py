"""varpro_roofline: kernel_varpro's share of its roofline over the traced
launches: the sum of each launch's least time (bytes at the HBM peak or
operations at the float32 peak, the larger; harness/roofline.py) over
the sum of the kernel's device time, in %. The operations count the
fit-iterations each launch ran on these inputs."""

from harness import roofline

KERNEL = "varpro_lm_p1"


def read(run):
    if run.trace is None:
        return None
    device_ms = run.trace.seconds_where(lambda name: KERNEL in name) * 1e3
    bound_ms = sum(roofline.varpro_bound_ms(r["fits"], r["points"], n, r["element_size"],
                                            run.cell.config["model"])
                   for r in run.records for n in r.get("fit_iterations", []))
    if device_ms <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / device_ms
