"""The port's multi-device layer (spgemm_tpu_torch/parallel/dist.py)
against the JAX reference (spgemm_tpu/parallel/dist.py).

Planners run in this process and must equal the JAX planners array for
array at 1, 2, 4 and 8 ranks (bfloat16 planes compared as their bits).
The six formulations run in gloo worker processes on CPU tensors, one
spawn per world size (2 and 4) running every case; the workers import no
JAX, get a free port each and write every rank's C to an .npz. Here the
JAX function runs on make_mesh(ndev) of the 8-device virtual CPU mesh on
the same seeded numpy matrices (square, rectangular, empty, banded), and
the two C must agree: equal pattern; values exactly equal on integer
values, within rtol 1e-6, atol 1e-6*max|C| on Gaussian f32 values (the
products sum in another order); bit-equal through Ozaki f64; ESC within
rtol 1e-6 after dropping explicit zeros. Every rank must assemble the
same C.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spgemm_tpu.models.csr import CSR as JCSR
from spgemm_tpu.models.tile import csr_to_tiles as j_tiles
from spgemm_tpu.models.tile import tiles_to_csr as j_to_csr
from spgemm_tpu.ops import golden as jgolden
from spgemm_tpu.parallel import dist as jdist

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import golden as tgolden
from spgemm_tpu_torch.parallel import dist as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 240


# --- seeded problems (numpy; the workers rebuild none: they load them) ------

def _random(rng, m, n, density, gaussian=False):
    nnz = max(1, int(m * n * density))
    vals = (rng.standard_normal(nnz) if gaussian
            else rng.integers(1, 10, nnz).astype(np.float64))
    return (rng.integers(0, m, nnz), rng.integers(0, n, nnz), vals, (m, n))


def _band(n, half, vals_fn):
    offs = np.arange(-half, half + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    return r, c, vals_fn(r), (n, n)


def _general(r):
    rng = np.random.default_rng(78)
    vals = rng.standard_normal(r.size)
    vals[r < 130] = rng.integers(1, 8, int((r < 130).sum()))
    return vals


def _problems():
    """name -> (A, B) as COO tuples (rows, cols, values, shape)."""
    rng = np.random.default_rng(0)
    sq = _random(rng, 200, 200, 0.03)
    gs = _random(rng, 200, 200, 0.03, gaussian=True)
    ra, rb = _random(rng, 150, 100, 0.04), _random(rng, 100, 120, 0.04)
    band = _band(256, 6, lambda r: np.random.default_rng(5).standard_normal(
        r.size))
    band_int = _band(300, 4, lambda r: np.random.default_rng(77).integers(
        1, 10, r.size).astype(np.float64))
    band_gen = _band(260, 3, _general)
    return {
        "square": (sq, sq), "gauss": (gs, gs), "rect": (ra, rb),
        "empty": (([0], [0], [1.0], (64, 64)), ([63], [63], [1.0], (64, 64))),
        "band": (band, band), "band_int": (band_int, band_int),
        "band_gen": (band_gen, band_gen),
    }


PROBLEMS = _problems()
GAUSSIAN = {"gauss", "band", "band_gen"}

# case -> (formulation, problem, (tm, tk, tn), strip block_rows, window)
CASES = {
    "pairs-square": ("pairs", "square", (16, 16, 16), None, None),
    "pairs-gauss": ("pairs", "gauss", (16, 16, 16), None, None),
    "pairs-rect": ("pairs", "rect", (16, 16, 16), None, None),
    "pairs-empty": ("pairs", "empty", (16, 16, 16), None, None),
    "gustavson-square": ("gustavson", "square", (16, 16, 16), None, None),
    "gustavson-gauss": ("gustavson", "gauss", (16, 16, 16), None, None),
    "gustavson-rect": ("gustavson", "rect", (16, 16, 16), None, None),
    "gustavson-empty": ("gustavson", "empty", (16, 16, 16), None, None),
    "ring-square": ("ring", "square", (8, 16, 16), None, None),
    "ring-rect": ("ring", "rect", (16, 16, 16), None, None),
    "strip-square": ("strip", "square", (8, 16, 16), 2, None),
    "strip-band-windowed": ("strip", "band", (8, 16, 16), 2, True),
    "strip-rect": ("strip", "rect", (16, 16, 16), 2, None),
    "strip-wide": ("strip", "band_int", (16, 128, 128), 2, None),
    "esc-square": ("esc", "square", None, None, None),
    "esc-gauss": ("esc", "gauss", None, None, None),
    "esc-rect": ("esc", "rect", None, None, None),
    "ozaki-band": ("ozaki", "band_int", (16, 128, 128), None, None),
    "ozaki-general": ("ozaki", "band_gen", (16, 128, 128), None, None),
}

_WORKER = r"""
import json, sys
import numpy as np
rank, ws, port, inp, cases_path, out = sys.argv[1:7]
rank, ws = int(rank), int(ws)
import spgemm_tpu_torch as pt
from spgemm_tpu_torch.parallel import dist as tdist

assert tdist.init_multihost(f"127.0.0.1:{port}", num_processes=ws,
                            process_id=rank, backend="gloo") == ws
mesh = tdist.make_mesh(ws, device="cpu")
z = np.load(inp)
cases = json.load(open(cases_path))
csr = lambda k: pt.CSR(z[k + "_p"], z[k + "_i"], z[k + "_d"],
                       tuple(int(v) for v in z[k + "_s"]))
res = {}
for name, (form, prob, tiles, block_rows, window) in cases.items():
    a, b = csr(prob + "_a"), csr(prob + "_b")
    if form == "esc":
        c = tdist.spgemm_sharded_esc(a, b, mesh)
    else:
        tm, tk, tn = tiles
        at, bt = pt.csr_to_tiles(a, tm, tk), pt.csr_to_tiles(b, tk, tn)
        if form == "strip":
            ct = tdist.spgemm_sharded_strip(at, bt, mesh,
                                            block_rows=block_rows,
                                            window=window)
        else:
            fn = {"pairs": tdist.spgemm_sharded_pairs,
                  "gustavson": tdist.spgemm_sharded,
                  "ring": tdist.spgemm_sharded_ring,
                  "ozaki": tdist.spgemm_sharded_ozaki}[form]
            ct = fn(at, bt, mesh)
        c = pt.tiles_to_csr(ct)
    res[name + "_p"], res[name + "_i"], res[name + "_d"] = (
        c.indptr, c.indices, c.data)
np.savez(f"{out}{rank}.npz", **res)
print(f"rank {rank}: OK", flush=True)
"""


def _spawn(tmp, ws: int) -> list:
    """Runs every case on `ws` gloo ranks; returns each rank's results."""
    inp, cases, out = tmp / "inputs.npz", tmp / "cases.json", str(tmp / "c")
    arrays = {}
    for name, (a, b) in PROBLEMS.items():
        for side, coo in (("a", a), ("b", b)):
            m = pt.CSR.from_coo(*coo)
            arrays.update({f"{name}_{side}_p": m.indptr,
                           f"{name}_{side}_i": m.indices,
                           f"{name}_{side}_d": m.data,
                           f"{name}_{side}_s": np.array(m.shape)})
    np.savez(inp, **arrays)
    cases.write_text(json.dumps(CASES))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = str(tdist._free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(ws),
                               port, str(inp), str(cases), out],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(ws)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{ws} gloo workers timed out:\n" + "\n".join(outs))
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: OK" in o, o
    return [dict(np.load(f"{out}{r}.npz")) for r in range(ws)]


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    cache = {}

    def get(ws):
        if ws not in cache:
            cache[ws] = _spawn(tmp_path_factory.mktemp(f"ws{ws}"), ws)
        return cache[ws]
    return get


def _jcsr(coo) -> JCSR:
    return JCSR.from_coo(*coo)


def _jax_c(case: str, ndev: int) -> JCSR:
    form, prob, tiles, block_rows, window = CASES[case]
    a, b = (_jcsr(x) for x in PROBLEMS[prob])
    mesh = jdist.make_mesh(ndev)
    if form == "esc":
        return jdist.spgemm_sharded_esc(a, b, mesh)
    tm, tk, tn = tiles
    at, bt = j_tiles(a, tm, tk), j_tiles(b, tk, tn)
    if form == "strip":
        return j_to_csr(jdist.spgemm_sharded_strip(
            at, bt, mesh, block_rows=block_rows, window=window))
    fn = {"pairs": jdist.spgemm_sharded_pairs,
          "gustavson": jdist.spgemm_sharded,
          "ring": jdist.spgemm_sharded_ring,
          "ozaki": jdist.spgemm_sharded_ozaki}[form]
    return j_to_csr(fn(at, bt, mesh))


@pytest.mark.parametrize("ws", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_formulation_matches_jax(worker_results, case, ws):
    ranks = worker_results(ws)
    got = [(r[case + "_p"], r[case + "_i"], r[case + "_d"]) for r in ranks]
    for other in got[1:]:  # every rank assembles the same C
        for x, y in zip(got[0], other):
            np.testing.assert_array_equal(x, y)
    exp = _jax_c(case, ws)
    form, prob = CASES[case][:2]
    port = pt.CSR(*got[0], exp.shape)
    if form == "esc":
        port = tgolden.drop_explicit_zeros(port)
        exp = jgolden.drop_explicit_zeros(exp)
    np.testing.assert_array_equal(port.indptr, exp.indptr)
    np.testing.assert_array_equal(port.indices, exp.indices)
    if form == "ozaki" or prob not in GAUSSIAN:
        np.testing.assert_array_equal(port.data, exp.data)
    else:
        scale = np.abs(exp.data).max() if exp.nnz else 0.0
        np.testing.assert_allclose(port.data, exp.data, rtol=1e-6,
                                   atol=1e-6 * scale)
    if prob == "empty":
        assert port.nnz == 0


# --- planners, array for array ----------------------------------------------

def _eq(port, ref, what):
    if isinstance(ref, np.ndarray):
        if ref.dtype.name == "bfloat16":
            ref = ref.view(np.uint16)
        np.testing.assert_array_equal(np.asarray(port), ref, err_msg=what)
        assert np.asarray(port).dtype == ref.dtype or what.endswith(
            ("ctrow", "ctcol")), (what, np.asarray(port).dtype, ref.dtype)
    else:
        assert port == ref, (what, port, ref)


def _tiles(prob, tiles):
    a, b = PROBLEMS[prob]
    tm, tk, tn = tiles
    return ((pt.csr_to_tiles(pt.CSR.from_coo(*a), tm, tk),
             pt.csr_to_tiles(pt.CSR.from_coo(*b), tk, tn)),
            (j_tiles(_jcsr(a), tm, tk), j_tiles(_jcsr(b), tk, tn)))


NDEVS = [1, 2, 4, 8]


@pytest.mark.parametrize("ndev", NDEVS)
def test_plan_row_partition_matches_jax(ndev):
    (at, bt), (jat, jbt) = _tiles("square", (16, 16, 16))
    p = tdist.plan_row_partition(at, bt, ndev)
    j = jdist.plan_row_partition(jat, jbt, ndev)
    for f in dataclasses.fields(p):
        if f.name == "schedule":
            for g in dataclasses.fields(p.schedule):
                _eq(getattr(p.schedule, g.name), getattr(j.schedule, g.name),
                    "schedule." + g.name)
        else:
            _eq(getattr(p, f.name), getattr(j, f.name), f.name)


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("prob,tiles", [("square", (16, 16, 16)),
                                        ("rect", (16, 16, 16)),
                                        ("band_int", (16, 128, 128))])
def test_plan_gustavson_partition_matches_jax(ndev, prob, tiles):
    (at, bt), (jat, jbt) = _tiles(prob, tiles)
    p = tdist.plan_gustavson_partition(at, bt, ndev)
    j = jdist.plan_gustavson_partition(jat, jbt, ndev)
    for f in dataclasses.fields(p):
        _eq(getattr(p, f.name), getattr(j, f.name), f.name)


def _skewed():
    n = 512
    rng = np.random.default_rng(3)
    r = np.concatenate([rng.integers(0, n // 4, 4000),
                        rng.integers(n // 4, n, 1000)])
    c = rng.integers(0, n, r.size)
    return r, c, np.ones(r.size), (n, n)


def _mixed():
    """Banded top half (a windowed plan alone), scattered bottom half (a
    cached one): shards that disagree all rebuild cached."""
    n = 512
    r, c, v, _ = _band(n // 2, 4, lambda r: np.ones(r.size))
    rng = np.random.default_rng(9)
    r2 = rng.integers(n // 2, n, 800)
    c2 = rng.integers(0, n, r2.size)
    return (np.concatenate([r, r2]), np.concatenate([c, c2]),
            np.ones(r.size + r2.size), (n, n))


STRIP_PLANS = {
    # kind -> (A and B as COO, tiles, block_rows, window, windowed at 2+)
    "windowed": (PROBLEMS["band"][0], (8, 16, 16), 2, None, True),
    "cached": (PROBLEMS["square"][0], (8, 16, 16), 2, False, False),
    "skewed": (_skewed(), (8, 16, 16), 2, None, None),
    "mixed-fallback": (_mixed(), (8, 16, 16), 2, None, False),
    "wide": (PROBLEMS["band_int"][0], (16, 128, 128), 4, None, None),
}


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("kind", list(STRIP_PLANS))
def test_plan_strip_partition_matches_jax(ndev, kind):
    coo, (tm, tk, tn), block_rows, window, windowed = STRIP_PLANS[kind]
    a, ja = pt.CSR.from_coo(*coo), _jcsr(coo)
    at, bt = pt.csr_to_tiles(a, tm, tk), pt.csr_to_tiles(a, tk, tn)
    jat, jbt = j_tiles(ja, tm, tk), j_tiles(ja, tk, tn)
    kw = dict(block_rows=block_rows, window=window)
    p = tdist.plan_strip_partition(at, bt, ndev, **kw)
    j = jdist.plan_strip_partition(jat, jbt, ndev, **kw)
    if windowed is not None and ndev > 1:
        assert (p.kwin is not None) == windowed
    for name in ("row_lo", "kwin", "gk_total", "a_val", "a_occ", "b_val",
                 "b_occ", "aptr", "gidx", "ntc", "ctrow", "ctcol",
                 "num_pairs"):
        _eq(getattr(p, name), getattr(j, name), name)
    for k in ("gm", "max_b", "max_cblock", "block_rows"):
        assert p.kernel_kwargs[k] == j.kernel_kwargs[k], k
    if p.kwin is None:  # the cached shape: the same ak and slots planes
        _eq(p.x1, j.x1, "x1")
        _eq(p.x2, j.x2, "x2")
    # every shard's own plan: the ak and slots both plan shapes carry
    tp = tdist._strip_shard_plans(at, bt, ndev, **kw)[0]
    jp = jdist._strip_shard_plans(jat, jbt, ndev, **kw)[0]
    for d, (ps, js) in enumerate(zip(tp, jp)):
        for name in ("a_val", "a_occ", "b_val", "b_occ", "aptr", "ak",
                     "slots", "gather_idx", "ctrow", "ctcol", "nt_c",
                     "max_ablock", "max_cblock", "kwin"):
            _eq(getattr(ps, name), getattr(js, name), f"shard {d} {name}")
        n = p.x1.shape[1]
        _eq(p.x1[d, : ps.ak.size], js.ak, f"x1[{d}]")
        _eq(p.x2[d, : ps.slots.size], js.slots, f"x2[{d}]")
        assert not p.x1[d, ps.ak.size: n].any()


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("prob", ["band_int", "band_gen"])
def test_plan_ozaki_partition_matches_jax(ndev, prob):
    (at, bt), (jat, jbt) = _tiles(prob, (16, 128, 128))
    p = tdist.plan_ozaki_partition(at, bt, ndev)
    j = jdist.plan_ozaki_partition(jat, jbt, ndev)
    for f in dataclasses.fields(p):
        if f.name == "ct_local":
            for d, (x, y) in enumerate(zip(p.ct_local, j.ct_local)):
                _eq(x[0], y[0], f"ct_local[{d}] rows")
                _eq(x[1], y[1], f"ct_local[{d}] cols")
        else:
            _eq(getattr(p, f.name), getattr(j, f.name), f.name)


def test_place_strip_partition_is_rank_zero_of_the_stacked_plan():
    """One process with no group is rank 0 of a one-rank mesh; its placed
    operands are the stacked plan's, and C is the golden one."""
    (at, bt), _ = _tiles("band_int", (16, 128, 128))
    mesh = tdist.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    arrays, plan = tdist.place_strip_partition(at, bt, mesh, block_rows=4)
    assert plan.a_val is None
    stacked = tdist.plan_strip_partition(at, bt, 1, block_rows=4)
    for name, t in zip(tdist._STRIP_NAMES, arrays):
        ref = getattr(stacked, name)[0]
        got = t.view(torch.int16).numpy() if name in ("a_occ", "b_occ") \
            else t.numpy()
        np.testing.assert_array_equal(got, ref.view(got.dtype)
                                      if ref.dtype == np.uint16 else ref)
    ct = tdist.spgemm_sharded_strip(at, bt, mesh, placed=(arrays, plan))
    a = pt.CSR.from_coo(*PROBLEMS["band_int"][0])
    ref = tgolden.spgemm_scipy(a, a)
    got = tgolden.drop_explicit_zeros(ct.to_csr())
    assert got.pattern_equal(ref)
    np.testing.assert_array_equal(got.data, ref.data)


def test_one_rank_mesh_and_refusals():
    """make_mesh without a process group is one rank; a larger n_devices
    and a non-f32 strip accumulator raise; the ESC skew fallback is not
    taken on a one-rank mesh."""
    mesh = tdist.make_mesh(1, device="cpu")
    assert mesh.size == 1 and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="one process per device"):
        tdist.make_mesh(2, device="cpu")
    (at, bt), _ = _tiles("square", (16, 16, 16))
    with pytest.raises(ValueError, match="float32"):
        tdist.spgemm_sharded_strip(at, bt, mesh, acc_dtype=torch.float64)
    assert tdist.init_multihost() == 1
    before = tdist.spgemm_sharded_esc.single_device_fallbacks
    a = pt.CSR.from_coo(*PROBLEMS["square"][0])
    c = tdist.spgemm_sharded_esc(a, a, mesh)
    assert tdist.spgemm_sharded_esc.single_device_fallbacks == before
    ref = tgolden.spgemm_scipy(a, a)
    assert tgolden.drop_explicit_zeros(c).pattern_equal(ref)
