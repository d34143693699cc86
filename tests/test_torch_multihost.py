"""Real multi-process runs of the port's multi-device path (the
counterpart of tests/test_multihost.py): two local processes join one
gloo process group through init_multihost, build and upload only their
own strip shard (place_strip_partition), run spgemm_sharded_strip across
both ranks, and check the assembled C against scipy on BOTH ranks. Then
dryrun_multichip(2, device="cpu") spawns its own two gloo ranks and
prints its OK line. The workers import no JAX."""

import os
import subprocess
import sys

import pytest

from spgemm_tpu_torch.parallel.dist import _free_port

_WORKER = r"""
import sys
import numpy as np
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import csr_to_tiles
from spgemm_tpu_torch.ops import golden
from spgemm_tpu_torch.parallel.dist import (init_multihost, make_mesh,
                                            place_strip_partition,
                                            spgemm_sharded_strip)

n = init_multihost(f"127.0.0.1:{port}", num_processes=nproc,
                   process_id=pid, backend="gloo")
assert n == nproc, (n, nproc)
mesh = make_mesh(device="cpu")
assert (mesh.size, mesh.rank) == (nproc, pid)

# deterministic banded matrix, the same on every process
rows = 96
offs = np.arange(-5, 6)
r = np.repeat(np.arange(rows), offs.size)
c = r + np.tile(offs, rows)
keep = (c >= 0) & (c < rows) & (((r * 31 + c * 17) & 3) < 2)
keep |= r == c
r, c = r[keep], c[keep]
a = CSR.from_coo(r, c, ((r * 7 + c * 13) % 9 + 1).astype(np.float64),
                 (rows, rows))
at = csr_to_tiles(a, 16, 128)
bt = csr_to_tiles(a, 128, 128)
arrays, plan = place_strip_partition(at, bt, mesh, block_rows=2)
assert plan.a_val is None and arrays[0].shape[0] > 0
ct = spgemm_sharded_strip(at, bt, mesh, placed=(arrays, plan))
got = golden.drop_explicit_zeros(ct.to_csr())
ref = golden.spgemm_scipy(a, a)
assert got.pattern_equal(ref), "pattern mismatch"
np.testing.assert_array_equal(got.data, ref.data)
print(f"pid{pid}: OK nnzC={got.nnz}", flush=True)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def test_two_process_sharded_strip(tmp_path):
    port = _free_port()
    worker = tmp_path / "mh_worker.py"
    worker.write_text(_WORKER)
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), "2",
                               str(port)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=_env())
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"pid{i}: OK" in out, out


def test_dryrun_multichip_two_gloo_ranks():
    """dryrun_multichip(2, device="cpu") in a fresh interpreter (its ranks
    are spawned processes): it returns and prints its OK line."""
    code = ("from spgemm_tpu_torch.entry import dryrun_multichip\n"
            "dryrun_multichip(2, device='cpu')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=_env())
    assert res.returncode == 0, res.stdout + res.stderr
    assert "dryrun_multichip(2): OK" in res.stdout, res.stdout
