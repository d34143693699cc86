"""kernels: the call's least time over the device time of the Ozaki
strip route's wgmma kernel (csrc/ozaki_strip.cu: ozaki_wgmma_kernel, in
an anonymous namespace there), found by name among the traced run's
device_ops, in %. The kernel alone: the K-major copy it launches before
it (transpose_kernel) is left out, since device_ops keeps only the ten
largest names and the copy can fall outside them, and that would cut the
time the metric reads. The least time is kernels_roofline's: the larger
of the problem's minimal bytes over 3.35 TB/s and its useful flops over
495 TFLOP/s (yardstick.py). None where no such kernel ran."""

import re

from perfbench import yardstick

NAME = re.compile(r"^(void )?(\(anonymous namespace\)::)?ozaki_wgmma_kernel<")


def read(run):
    tr = run.trace
    if tr is None or run.min_bytes_per_call is None or not run.calls:
        return None
    device_s = sum(s for name, s in tr["device_ops"] if NAME.match(name))
    if device_s <= 0:
        return None
    least = yardstick.least_seconds(run.min_bytes_per_call,
                                    run.flops_per_call)
    return 100.0 * least * len(run.calls) / device_s
