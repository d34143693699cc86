"""Benchmark of spgemm_tpu_torch on one NVIDIA H100.

One command runs one cell of the repository's BENCHMARK.json once:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, entry point or
metric sits in a file of its own that the harness finds by name:

    configs/<config>.json     sizes, dtype, tiles and source of a matrix
    matrices/<generator>.py   the pattern a config names, and its values' draw
    traffic/<mix>.json        the entry a window drives and what each call varies
    variations/<vary>.py      one call's operands for that variation
    entries/<entry>.py        the program's call for that entry
    products/<product>.py     useful flops, minimal bytes and the check
    metrics/<metric>.py       the reader of one metric

The plain reference (reference.py) and the yardstick (yardstick.py) import
nothing of the program.
"""
