"""The one generator of every traffic mix: what each call of a window
gets, drawn from the run's seed and the call's index.

A traffic file (traffic/<mix>.json) names the entry the window drives,
the product it computes and what varies from call to call: `vary` names
a module variations/<vary>.py whose `inputs(traffic, call)` makes call
`call`'s operands. The matrix comes from matrices/<generator>.py, which
the config names: its pattern, and how it draws a set of values from a
torch.Generator. Values are drawn in the config's `dtype`.

Each array is one draw of a torch.Generator keyed on (seed, stream,
call): call -1, the seed's own, on the run's device in set-up; call 0
(the warm-up) and calls 1, 2, ... (the window) on the host, so that the
harness runs nothing on the device between the calls it times. The same
(seed, call) gives the same inputs on the same device, so the check
draws a call's inputs again instead of keeping them.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    """One call's operand A as raw CSR arrays: int32 indptr and indices,
    values in the config's dtype."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.size)


def generator(seed: int, stream: str, call: int,
              device) -> torch.Generator:
    """The generator of one draw: a stream is a name (a matrix's values,
    a variation's own draws), a call -1 the seed's own."""
    ss = np.random.SeedSequence([seed % (1 << 64), zlib.crc32(stream.encode()),
                                 call + 1])
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]) >> 1)
    return g


class Traffic:
    """The inputs of every call of one run: `matrix` is what the config's
    generator built, `vary` the traffic's variation module."""

    def __init__(self, spec: dict, cfg: dict, matrix, vary, seed: int,
                 device):
        self.spec, self.cfg, self.matrix, self.vary = spec, cfg, matrix, vary
        self.seed = seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.base = Inputs(matrix.indptr, matrix.indices,
                           self.values(-1), matrix.shape)

    def generator(self, stream: str, call: int) -> torch.Generator:
        """Call -1's draws on the run's device, the others' on the host."""
        return generator(self.seed, stream, call,
                         self.device if call < 0 else "cpu")

    def values(self, call: int) -> np.ndarray:
        """A fresh set of the matrix's values for call `call`."""
        v = self.matrix.values(self.generator("values", call), self.dtype)
        return v.to(self.dtype).cpu().numpy()

    def inputs(self, call: int) -> Inputs:
        """The operands of call `call` (-1: the seed's own)."""
        return self.base if call < 0 else self.vary.inputs(self, call)
