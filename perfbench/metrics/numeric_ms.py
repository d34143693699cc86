"""numeric: the program's numeric_ms + upload_ms, the host's wall time
over upload, kernels, device compaction and download. Mean ms per call."""


def read(run):
    return run.phase_ms("numeric_ms", "upload_ms")
