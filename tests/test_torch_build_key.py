"""The native build key (`spgemm_tpu_torch/utils/native.py:library_path`):
a library is keyed on its source, the files it includes with
`#include "..."` and the flags, so editing a shared header of the kernel
sources (csrc/*.cuh) builds every library that includes it anew instead
of loading one built from the old header. Nothing is compiled here.
"""

import os

from spgemm_tpu_torch.ops import kernels, pair_kernels, spmm_kernels
from spgemm_tpu_torch.utils import native


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_key_changes_with_an_included_header(tmp_path):
    src = tmp_path / "k.cu"
    _write(tmp_path / "outer.cuh", '#pragma once\n#include "inner.cuh"\n')
    _write(tmp_path / "inner.cuh", "constexpr int kA = 1;\n")
    _write(src, '#include <cstdint>\n#include "outer.cuh"\nint f();\n')
    flags = ["-O3"]
    key = native.library_path(str(src), "libk", flags)
    assert key == native.library_path(str(src), "libk", flags)
    assert os.path.dirname(key) == native.BUILD_DIR
    _write(tmp_path / "inner.cuh", "constexpr int kA = 2;\n")  # nested
    key2 = native.library_path(str(src), "libk", flags)
    assert key2 != key
    _write(tmp_path / "outer.cuh", '#pragma once\n#include "inner.cuh"\n\n')
    key3 = native.library_path(str(src), "libk", flags)
    assert key3 not in (key, key2)
    assert native.library_path(str(src), "libk", ["-O2"]) != key3
    assert [os.path.basename(p) for p in native.source_closure(str(src))] \
        == ["k.cu", "outer.cuh", "inner.cuh"]


def test_key_ignores_missing_and_system_includes(tmp_path):
    # <...> headers and names not found beside the source are left to the
    # compiler; an include cycle is followed once
    _write(tmp_path / "a.cuh", '#include "b.cuh"\n')
    _write(tmp_path / "b.cuh", '#include "a.cuh"\n#include "nowhere.h"\n')
    _write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n#include "a.cuh"\n')
    assert [os.path.basename(p)
            for p in native.source_closure(str(tmp_path / "k.cu"))] \
        == ["k.cu", "a.cuh", "b.cuh"]


def test_kernel_sources_key_on_their_headers():
    names = lambda src: [os.path.basename(p)
                         for p in native.source_closure(src)]
    assert names(kernels.KERNEL_SRC) == ["strip_numeric.cu",
                                         "sm90_common.cuh"]
    assert names(pair_kernels.KERNEL_SRC) == ["pair_accumulate.cu",
                                              "sm90_common.cuh"]
    assert names(spmm_kernels.KERNEL_SRC) == ["spmm_strip.cu",
                                              "sm90_common.cuh"]
