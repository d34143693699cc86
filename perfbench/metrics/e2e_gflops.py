"""The useful flops of every call completed in the window over the sum of
those calls' clocks, in GFLOPS (10^9 flop/s). Useful flops: 2*nnzCub for
C = A^2 (products/<product>.py)."""


def read(run):
    done = run.done
    clock = sum(c["clock_s"] for c in done)
    if not done or clock <= 0:
        return None
    return run.flops_per_call * len(done) / clock / 1e9
