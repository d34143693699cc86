"""plan: the program's slice_ms span on the Ozaki routes (the value
model's scales and spans, the hi/lo split and the int8 slicing of every
operand; a child of prep_ms). Mean ms per call; None where the program
reports no such span."""


def read(run):
    return run.mean_ms(lambda c: c.get("timings_ms", {}).get("slice_ms"))
