"""`spgemm_csr(A)`: C = A^2 through the public CSR API, its auto router,
the config's tile shape and its dtype. CSR in, CSR out on the host."""

from __future__ import annotations

import torch

import spgemm_tpu_torch as st


class Entry:
    def __init__(self, cfg: dict, spec: dict, base, device):
        self.tm, self.tn = (int(t) for t in cfg["tiles"])
        self.dtype = getattr(torch, cfg["dtype"])
        self.device = device
        self.last: dict = {}

    def prepare(self, inp):
        return st.CSR(inp.indptr, inp.indices, inp.data, inp.shape)

    def __call__(self, a):
        c, res = st.spgemm_csr(a, tm=self.tm, tn=self.tn,
                                compute_dtype=self.dtype, device=self.device)
        route = str(res.stats["backend"])
        group_rows = getattr(res.schedule, "group_rows", None)
        if group_rows is not None:  # the ESC plan's in-kernel reduction
            route += f"(G={group_rows})"
        self.last = {"timings_ms": dict(res.timings_ms), "route": route}
        return c

    @staticmethod
    def to_host(c):
        return c.indptr, c.indices, c.data

    def close(self) -> None:
        pass
