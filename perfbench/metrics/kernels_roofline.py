"""kernels: the least time of the calls' work over the device time of all
their kernels and memsets (torch.profiler), in %. The least time is the
larger of the problem's minimal bytes over 3.35 TB/s and its useful flops
over 495 TFLOP/s (yardstick.py); the bytes are the problem's own (the
CSR operands read once, the result written once), not the program's."""

from perfbench import yardstick


def read(run):
    tr = run.trace
    if tr is None or tr["kernel_s"] <= 0 or run.min_bytes_per_call is None:
        return None
    least = yardstick.least_seconds(run.min_bytes_per_call,
                                    run.flops_per_call)
    return 100.0 * least * len(run.calls) / tr["kernel_s"]
