"""Peak device memory allocated during the window (its peak counter
reset at the window's start), in GiB."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None
