"""The edge-rotation engine of K1 and K4 (csrc/edge_rotate.cuh), on the CPU.

``ops/cuda/edge_rotate.py:tile_plan`` mirrors the header's tile plan (a
test on the card holds the two equal).  Here every instance, kind and dtype
of both kernels is planned over narrow, main-path and wide channel counts:
the plan must fit one block's 227 KB of shared memory, keep every bulk
copy's address and size 16-byte aligned, stay within an mbarrier's
transaction count, and give every consumer thread a 16-byte group at the
main paths' shapes.  ``ops/cuda/build.py`` must rebuild a kernel when a
header it includes changes.
"""

import re

import pytest

from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import build
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import edge_rotate as er
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import rotate as k4
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
    rotate_dense as rd,
)

WIDTHS = (8, 16, 24, 40, 64, 128, 256, 384, 512, 1024, 2048, 4096, 8192)
MAX_TX = (1 << 20) - 1   # an mbarrier's transaction count


def _rows(lib, lmax, mmax, kind):
    """Input and output rows of one edge."""
    if lib == "K1":
        info = rd._pair_info(lmax, mmax)
        return info["n_in"][kind], info["n_out"][kind]
    segs = k4.kernel_segments(lmax, mmax, kind)
    return sum(s[1] for s in segs), sum(s[3] for s in segs)


_CASES = [("K1", lm) for lm in rd.INSTANCES] + [("K4", lm) for lm in k4.INSTANCES]


@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", rd.KINDS)
@pytest.mark.parametrize("lib,lm", _CASES, ids=[f"{a}-{b}" for a, b in _CASES])
def test_every_plan_fits_and_keeps_alignment(lib, lm, kind, elt):
    ki, _ = _rows(lib, *lm, kind)
    plan_of = er.pairs_plan if lib == "K1" else er.rot_plan
    for C in WIDTHS:
        if C % (16 // elt):
            continue
        p = plan_of(elt, *lm, kind, C)
        assert p.smem <= er.SMEM_LIMIT, (C, p)
        assert 2 <= p.stages <= er.MAX_STAGES and p.te >= 1, (C, p)
        assert C % p.ct == 0 and (p.ct * elt) % 16 == 0, (C, p)
        # every stage, x tile and value table starts 16-byte aligned
        for off in (p.scratch_off, p.ring_off, p.x_bytes, p.stage_bytes):
            assert off % 16 == 0, (C, p)
        assert p.te * ki * p.ct * elt <= min(p.x_bytes, MAX_TX), (C, p)
        # channels are cut only where two stages of one whole edge exceed 227 KB
        assert p.ct == C or 2 * ki * C * elt > er.SMEM_LIMIT // 2, (C, p)


# (kernel, (lmax, mmax), kind, channels): the main paths' rotation sites
_SITES = [("K1", (4, 2), "to_m0", 256), ("K1", (4, 2), "from", 128), ("K1", (4, 2), "to", 128),
          ("K1", (4, 2), "from_m0", 256), ("K1", (4, 2), "to", 256), ("K1", (4, 2), "from", 256),
          ("K1", (6, 2), "to", 256), ("K1", (6, 2), "from", 128),
          ("K4", (6, 2), "to", 256), ("K4", (6, 2), "from", 128), ("K4", (4, 2), "to_m0", 256),
          ("K4", (4, 2), "from_m0", 256), ("K4", (4, 2), "from", 128)]


@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("site", _SITES, ids=lambda s: f"{s[0]}-{s[1]}-{s[2]}-C{s[3]}")
def test_main_path_tiles_are_whole_and_fill_the_consumers(site, elt):
    """At the main paths' shapes a tile is whole edges (one bulk copy) and
    gives every consumer thread a 16-byte channel group."""
    lib, lm, kind, C = site
    p = (er.pairs_plan if lib == "K1" else er.rot_plan)(elt, *lm, kind, C)
    assert p.ct == C
    assert p.te * C * elt // 16 >= er.CONSUMERS


def test_build_key_covers_the_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every local header it
    includes (transitively): editing a header rebuilds it."""
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nconstexpr int B = 1;\n")
    assert build._includes(tmp_path / "k.cu") == [tmp_path / "a.cuh", tmp_path / "b.cuh"]
    key = build._lib_path("k")
    (tmp_path / "b.cuh").write_text("#pragma once\nconstexpr int B = 2;\n")
    edited = build._lib_path("k")
    assert edited != key
    (tmp_path / "b.cuh").write_text("#pragma once\nconstexpr int B = 1;\n")
    assert build._lib_path("k") == key


def test_rotation_sources_include_the_engine():
    """Both rotation kernels are built from the shared engine header, so
    their cache keys change with it."""
    for name in ("rotate_dense", "rotate"):
        assert build.CSRC_DIR / "edge_rotate.cuh" in build._includes(
            build.CSRC_DIR / f"{name}.cu")


@pytest.mark.parametrize("name", ["CONSUMERS", "MAX_STAGES", "BLOCK_SMEM", "SMEM_LIMIT",
                                  "BAR_BYTES"])
def test_plan_constants_match_the_header(name):
    """The mirror's constants are the header's (`constexpr int NAME = value;`),
    so the CPU plans above are the plans the card runs."""
    src = (build.CSRC_DIR / "edge_rotate.cuh").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None, name
    assert int(m.group(1)) == getattr(er, name)
