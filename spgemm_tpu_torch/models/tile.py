"""The tiled sparse format (`TileMat`) and CSR <-> tile converters
(port of `spgemm_tpu/models/tile.py`).

Same layout contract as the JAX package, so the two packages' plans agree
array for array:

* tiles sorted row-major by (tile_row, tile_col), row-major intra-tile
  order;
* intra-tile code rc = r*tn + c (int32);
* per-row occupancy masks as uint32 words, LSB-first, ceil(tn/32) words
  per intra-tile row.

The native C++ converters (`native/csr2tile.cpp`, built by
`spgemm_tpu_torch/utils/native.py`) are the fast path; the vectorized
NumPy code here is the fallback and the reference semantics.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from spgemm_tpu_torch.models.csr import CSR, INDEX_DTYPE

MASK_BITS = 32
MASK_DTYPE = np.uint32


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class TileMat:
    """Tiled sparse matrix.

    The m x n matrix is cut into a gm x gn grid of tm x tn tiles; only
    non-empty tiles are stored, sorted by (tile_row, tile_col).

      trow, tcol : (nt,)  int32   tile coordinates
      tptr       : (gm+1,) int32  tile-row pointer over the sorted tiles
      tnnz_ptr   : (nt+1,) int32  exclusive scan of per-tile nnz
      rc         : (nnz,) int32   intra-tile code r*tn + c, row-major
      val        : (nnz,) float   values, same order as rc
      mask       : (nt, tm, mw) uint32  per-row occupancy words, LSB-first
      rowptr     : (nt, tm+1) int32  per-tile intra CSR row pointer
    """

    shape: tuple[int, int]
    tm: int
    tn: int
    trow: np.ndarray
    tcol: np.ndarray
    tptr: np.ndarray
    tnnz_ptr: np.ndarray
    rc: np.ndarray
    val: np.ndarray
    mask: np.ndarray
    rowptr: np.ndarray

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def gm(self) -> int:
        return cdiv(self.m, self.tm)

    @property
    def gn(self) -> int:
        return cdiv(self.n, self.tn)

    @property
    def nt(self) -> int:
        return int(self.trow.size)

    @property
    def nnz(self) -> int:
        return int(self.val.size)

    @property
    def mask_words(self) -> int:
        return cdiv(self.tn, MASK_BITS)

    def tile_nnz(self) -> np.ndarray:
        return self.tnnz_ptr[1:] - self.tnnz_ptr[:-1]

    def tile_ids_expanded(self) -> np.ndarray:
        """Per-nonzero tile ordinal, (nnz,) int64."""
        return np.repeat(
            np.arange(self.nt, dtype=np.int64), self.tile_nnz().astype(np.int64)
        )

    def dense(self, dtype=None) -> np.ndarray:
        """Per-tile dense blocks, (nt, tm, tn). A stored explicit zero is
        indistinguishable from padding here; structure lives in occ()."""
        dtype = dtype or self.val.dtype
        out = np.zeros(self.nt * self.tm * self.tn, dtype=dtype)
        out[self.tile_ids_expanded() * (self.tm * self.tn) + self.rc] = self.val
        return out.reshape(self.nt, self.tm, self.tn)

    def occ(self) -> np.ndarray:
        """Dense occupancy, (nt, tm, tn) uint8 (1 where a value is stored)."""
        out = np.zeros(self.nt * self.tm * self.tn, dtype=np.uint8)
        out[self.tile_ids_expanded() * (self.tm * self.tn) + self.rc] = 1
        return out.reshape(self.nt, self.tm, self.tn)

    def _padded_coords(self) -> tuple[np.ndarray, np.ndarray]:
        """(row, col) of every stored value in the (gm*tm, gn*tn) grid."""
        t = self.tile_ids_expanded()
        rows = self.trow[t].astype(np.int64) * self.tm + self.rc // self.tn
        cols = self.tcol[t].astype(np.int64) * self.tn + self.rc % self.tn
        return rows, cols

    def to_dense_padded(self, dtype=None) -> np.ndarray:
        """Full dense matrix padded to the tile grid, (gm*tm, gn*tn): the
        dense backend's operand layout."""
        rows, cols = self._padded_coords()
        out = np.zeros((self.gm * self.tm, self.gn * self.tn),
                       dtype=dtype or self.val.dtype)
        out[rows, cols] = self.val
        return out

    def occ_dense_padded(self) -> np.ndarray:
        """Dense structural occupancy padded to the tile grid, (gm*tm,
        gn*tn) uint8: 1 wherever a value is stored, explicit zeros
        included (the pattern never depends on the values)."""
        rows, cols = self._padded_coords()
        out = np.zeros((self.gm * self.tm, self.gn * self.tn), dtype=np.uint8)
        out[rows, cols] = 1
        return out

    def occ_from_mask(self) -> np.ndarray:
        """occ() recomputed from the packed bitmask words (reference
        semantics check; used by tests to validate mask construction)."""
        shifts = np.arange(MASK_BITS, dtype=MASK_DTYPE)
        bits = (self.mask[..., None] >> shifts) & MASK_DTYPE(1)
        return (
            bits.reshape(self.nt, self.tm, self.mask_words * MASK_BITS)[
                ..., : self.tn
            ]
        ).astype(np.uint8)

    @functools.cached_property
    def _csc_view(self) -> tuple[np.ndarray, np.ndarray]:
        perm = np.lexsort((self.trow, self.tcol)).astype(INDEX_DTYPE)
        cptr = np.zeros(self.gn + 1, dtype=INDEX_DTYPE)
        np.cumsum(np.bincount(self.tcol, minlength=self.gn), out=cptr[1:])
        return cptr, perm

    def csc_view(self) -> tuple[np.ndarray, np.ndarray]:
        """CSC-of-tiles view: (csc_ptr (gn+1,), csc_perm (nt,)); the tiles
        of tile-column j, in ascending tile-row order, are
        csc_perm[csc_ptr[j]:csc_ptr[j+1]]."""
        return self._csc_view

    def transpose_tiles(self) -> "TileMat":
        """Tiled form of A^T built directly in tile space (tile dims
        transpose too: the result has (tn, tm) tiles)."""
        r = self.rc // self.tn
        c = self.rc % self.tn
        t_rc = c.astype(np.int64) * self.tm + r
        tid = self.tile_ids_expanded()
        tile_key = self.tcol[tid].astype(np.int64) * self.gm + self.trow[tid]
        order = np.lexsort((t_rc, tile_key))
        return _build_tilemat(
            shape=(self.n, self.m),
            tm=self.tn,
            tn=self.tm,
            tile_key=tile_key[order],
            rc=t_rc[order].astype(INDEX_DTYPE),
            val=self.val[order],
            gm=self.gn,
            gn=self.gm,
        )

    def slice_tile_rows(self, r0: int, r1: int) -> "TileMat":
        """Sub-matrix of tile-rows [r0, r1), rebased to tile-row 0: the
        tile-row slab of A that one rank owns in the row-partitioned
        multi-device formulations (parallel/dist.py)."""
        lo, hi = int(self.tptr[r0]), int(self.tptr[r1])
        nlo, nhi = int(self.tnnz_ptr[lo]), int(self.tnnz_ptr[hi])
        rows = min((r1 - r0) * self.tm, self.m - r0 * self.tm)
        return TileMat(
            shape=(max(rows, 0), self.n),
            tm=self.tm,
            tn=self.tn,
            trow=self.trow[lo:hi] - r0,
            tcol=self.tcol[lo:hi],
            tptr=(self.tptr[r0 : r1 + 1] - self.tptr[r0]).astype(INDEX_DTYPE),
            tnnz_ptr=(self.tnnz_ptr[lo : hi + 1] - nlo).astype(INDEX_DTYPE),
            rc=self.rc[nlo:nhi],
            val=self.val[nlo:nhi],
            mask=self.mask[lo:hi],
            rowptr=self.rowptr[lo:hi],
        )

    def to_csr(self) -> CSR:
        return tiles_to_csr(self)

    def memory_bytes(self) -> dict[str, int]:
        """Tiled-format footprint, by array."""
        return {
            "tile_coo": self.trow.nbytes + self.tcol.nbytes,
            "tptr": self.tptr.nbytes,
            "tnnz_ptr": self.tnnz_ptr.nbytes,
            "rc": self.rc.nbytes,
            "val": self.val.nbytes,
            "mask": self.mask.nbytes,
            "rowptr": self.rowptr.nbytes,
        }

    def total_bytes(self) -> int:
        return sum(self.memory_bytes().values())


def _build_tilemat(
    shape: tuple[int, int],
    tm: int,
    tn: int,
    tile_key: np.ndarray,
    rc: np.ndarray,
    val: np.ndarray,
    gm: int,
    gn: int,
) -> TileMat:
    """Assemble a TileMat from nonzeros already sorted by
    (tile_key = trow*gn + tcol, intra-tile row-major code)."""
    nnz = tile_key.size
    mw = cdiv(tn, MASK_BITS)

    if nnz == 0:
        return TileMat(
            shape=shape,
            tm=tm,
            tn=tn,
            trow=np.zeros(0, INDEX_DTYPE),
            tcol=np.zeros(0, INDEX_DTYPE),
            tptr=np.zeros(gm + 1, INDEX_DTYPE),
            tnnz_ptr=np.zeros(1, INDEX_DTYPE),
            rc=np.zeros(0, INDEX_DTYPE),
            val=val,
            mask=np.zeros((0, tm, mw), MASK_DTYPE),
            rowptr=np.zeros((0, tm + 1), INDEX_DTYPE),
        )

    # int32 ordinals need nt*tm*mw (the largest derived key) in range;
    # nt <= nnz bounds it without knowing nt yet
    odt = np.int64 if nnz * tm * mw >= 2 ** 31 - 1 else np.int32

    new_tile = np.empty(nnz, dtype=bool)
    new_tile[0] = True
    np.not_equal(tile_key[1:], tile_key[:-1], out=new_tile[1:])
    starts = np.flatnonzero(new_tile)
    nt = starts.size
    tile_id = np.cumsum(new_tile, dtype=odt)
    tile_id -= 1

    keys = tile_key[starts]
    trow = (keys // gn).astype(INDEX_DTYPE)
    tcol = (keys % gn).astype(INDEX_DTYPE)

    tptr = np.zeros(gm + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(trow, minlength=gm), out=tptr[1:])

    tnnz_ptr = np.zeros(nt + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.diff(np.append(starts, nnz)), out=tnnz_ptr[1:])

    ri = rc // tn
    ci = rc % tn

    # Per-row bitmasks: OR the bit contributions within runs of equal
    # (tile, row, word); nonzeros are sorted, so runs are contiguous and
    # one bitwise_or.reduceat covers the whole matrix.
    rowkey = tile_id * tm + ri.astype(odt, copy=False)
    flat_word = rowkey * mw + (ci // MASK_BITS).astype(odt, copy=False)
    bits = (MASK_DTYPE(1) << (ci % MASK_BITS).astype(MASK_DTYPE)).astype(MASK_DTYPE)
    word_start = np.empty(nnz, dtype=bool)
    word_start[0] = True
    np.not_equal(flat_word[1:], flat_word[:-1], out=word_start[1:])
    wstarts = np.flatnonzero(word_start)
    mask = np.zeros(nt * tm * mw, dtype=MASK_DTYPE)
    mask[flat_word[wstarts]] = np.bitwise_or.reduceat(bits, wstarts)
    mask = mask.reshape(nt, tm, mw)

    row_counts = np.bincount(rowkey, minlength=nt * tm).reshape(nt, tm)
    rowptr = np.zeros((nt, tm + 1), dtype=INDEX_DTYPE)
    np.cumsum(row_counts, axis=1, out=rowptr[:, 1:])

    return TileMat(
        shape=shape,
        tm=tm,
        tn=tn,
        trow=trow,
        tcol=tcol,
        tptr=tptr,
        tnnz_ptr=tnnz_ptr,
        rc=rc.astype(INDEX_DTYPE),
        val=val,
        mask=mask,
        rowptr=rowptr,
    )


def csr_to_tiles(csr: CSR, tm: int = 16, tn: int = 16,
                 use_native: bool = True) -> TileMat:
    """CSR -> tiled format. Native C++ when the library builds; else one
    vectorized NumPy pass (a stable argsort by tile key keeps the CSR's
    (row, col) order inside each tile, so intra-tile order is row-major)."""
    if tm < 1 or tn < 1:
        raise ValueError("tile dims must be >= 1")
    if use_native:
        from spgemm_tpu_torch.utils.native import csr_to_tiles_native

        t = csr_to_tiles_native(csr, tm, tn)
        if t is not None:
            if csr.data.dtype != np.float64:
                t = dataclasses.replace(t, val=t.val.astype(csr.data.dtype))
            return t
    m, n = csr.shape
    gm, gn = cdiv(m, tm), cdiv(n, tn)
    rows = csr.rows_expanded()
    cols = csr.indices.astype(np.int64)
    tile_key = (rows // tm) * gn + cols // tn
    order = np.argsort(tile_key, kind="stable")
    rc = ((rows % tm) * tn + cols % tn).astype(INDEX_DTYPE)
    return _build_tilemat(
        shape=(m, n),
        tm=tm,
        tn=tn,
        tile_key=tile_key[order],
        rc=rc[order],
        val=csr.data[order],
        gm=gm,
        gn=gn,
    )


def tiles_to_csr(t: TileMat, use_native: bool = True) -> CSR:
    """Tiled format -> CSR. Native C++ when available; NumPy fallback: a
    stable argsort by global row keeps each row's columns ascending."""
    if use_native:
        from spgemm_tpu_torch.utils.native import tiles_to_csr_native

        c = tiles_to_csr_native(t)
        if c is not None:
            if t.val.dtype != np.float64:
                c = CSR(c.indptr, c.indices, c.data.astype(t.val.dtype),
                        c.shape)
            return c
    tid = t.tile_ids_expanded()
    grow = t.trow[tid].astype(np.int64) * t.tm + t.rc // t.tn
    gcol = t.tcol[tid].astype(np.int64) * t.tn + t.rc % t.tn
    order = np.argsort(grow, kind="stable")
    indptr = np.zeros(t.m + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(grow, minlength=t.m), out=indptr[1:])
    return CSR(indptr, gcol[order].astype(INDEX_DTYPE), t.val[order], t.shape)
