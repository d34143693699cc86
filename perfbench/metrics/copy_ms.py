"""device: device time of copies (host to device, device to host, device
to device) inside the calls, per call, in ms (torch.profiler)."""


def read(run):
    tr = run.trace
    if tr is None or tr["busy_s"] <= 0 or not run.calls:
        return None
    return tr["copy_s"] * 1e3 / len(run.calls)
