"""device: the share of the calls' spans in which no kernel, memset or
copy ran on the device (torch.profiler timeline), in %."""


def read(run):
    tr = run.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
