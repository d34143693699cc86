"""Fresh values over the config's fixed pattern each call (the matrix's
own draw: a graph's weights, a mesh's re-assembled stiffness)."""

from perfbench.traffic import Inputs


def inputs(tr, call: int) -> Inputs:
    b = tr.base
    return Inputs(b.indptr, b.indices, tr.values(call), b.shape)
