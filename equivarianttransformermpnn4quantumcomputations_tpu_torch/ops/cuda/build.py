"""Build the port's CUDA kernels and bind them with ctypes.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside the
package (listed in ``.gitignore``).  The libraries are named by a hash of
their source, every local header it includes (``#include "..."``, beside
it in ``csrc/``) and the flags, so a second call in the same checkout
reuses them and an edited header rebuilds them.  ``build()`` starts one
``nvcc`` for every source that is not built yet, all at once, and keeps
each compiler's ``ptxas`` report (registers and spills of every kernel
instance).

Every C launcher returns ``cudaGetLastError()`` right after its launch (the
ctypes counterpart of ``C10_CUDA_KERNEL_LAUNCH_CHECK()``), and ``check``
raises on it, so a refused launch never passes silently.  Nothing here runs
unless a CUDA tensor reaches a kernel wrapper (or a caller asks for the
build), so the CPU tests never need ``nvcc``.  There is no fallback: a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "build", "library", "check", "ptxas_report"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("rotate_dense", "s2act", "so2conv", "rotate", "gata_value")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: name -> (argtypes, restype)
_SIGNATURES = {
    "rotate_dense": {
        "etq_rotate_pairs": ([_I, _I, _I, _I, _P, _P, _P, _I, _I, _P], _I),
        "etq_rotate_pairs_plan": ([_I, _I, _I, _I, _I, _P], _I),
    },
    "s2act": {
        "etq_s2act": ([_I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P], _I),
    },
    "so2conv": {
        "etq_so2conv": ([_I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
                        _I),
        "etq_so2conv_b": ([_I, _I, _I, _I, _P, _P, _P, _P], _I),
        "etq_so2conv_dw": ([_I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                            _P], _I),
    },
    "rotate": {
        "etq_rotate": ([_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P], _I),
        "etq_rotate_plan": ([_I, _I, _I, _I, _I, _P], _I),
        "etq_rotate_const_floats": ([], _I),
        "etq_rotate_const_offset": ([_I, _I, _I], _I),
        "etq_rotate_set_consts": ([_P, _I], _I),
    },
    "gata_value": {
        "etq_gata_value": ([_I, _I, _I, _I, _I, _I, ctypes.c_longlong, _P, _P], _I),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
ptxas_report: dict[str, list[dict]] = {}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _parse_ptxas(log: str) -> list[dict]:
    """Per kernel instance: a short name, registers and spill bytes."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            base = re.search(r"(pairs_kernel|s2act_tc_kernel|so2conv_kernel|so2conv_dw_kernel|"
                             r"so2conv_dw_reduce|b_operand_kernel|rot_kernel|"
                             r"gata_value_kernel)I", mangled)
            args = ["bf16" if "bfloat16" in mangled else "f32"]
            args += re.findall(r"L[ib](\d+)E", mangled)
            out.append(dict(name=f"{base.group(1) if base else mangled}<{','.join(args)}>",
                            registers=0, spill_bytes=0))
        elif out and (m := re.search(r"(\d+) bytes spill stores", ln)):
            out[-1]["spill_bytes"] = int(m.group(1))
        elif out and (m := re.search(r"Used (\d+) registers", ln)):
            out[-1]["registers"] = int(m.group(1))
    return out


def _includes(path: Path) -> list[Path]:
    """The local headers ``path`` includes, and theirs, in order."""
    out: list[Path] = []
    for inc in re.findall(r'^\s*#\s*include\s*"([^"]+)"', path.read_text(), re.M):
        for h in (path.parent / inc, *_includes(path.parent / inc)):
            if h not in out:
                out.append(h)
    return out


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    blob = b"".join(p.read_bytes() for p in (src, *_includes(src)))
    key = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names=SOURCES) -> list[str]:
    """Compile every named source not built yet, one nvcc each, in parallel.

    Returns the names compiled (empty when all were built already).  Raises
    RuntimeError with the compiler's output when a build fails.
    """
    todo = [n for n in names if not _lib_path(n).exists()]
    for n in set(names) - set(todo):
        ptxas_report.setdefault(
            n, json.loads(_lib_path(n).with_suffix(".ptxas.json").read_text()))
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f".lib{n}-{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        ptxas_report[n] = _parse_ptxas(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu failed (rc {proc.returncode}):\n{log}")
            continue
        _lib_path(n).with_suffix(".ptxas.json").write_text(json.dumps(ptxas_report[n]))
        os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, restype
        lib.etq_error_string.argtypes = [_I]
        lib.etq_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(name: str, rc: int, what: str) -> None:
    """Raise if a launcher returned non-zero (a refused or failed launch)."""
    if rc == 0:
        return
    if rc > 0:
        msg = library(name).etq_error_string(rc).decode()
    else:
        msg = {-1: "unknown kind", -2: "no kernel instance for these sizes",
               -3: "unsupported dtype", -4: "sizes the kernel does not take"}.get(
                   rc, "unknown error")
    raise RuntimeError(f"{what}: launch failed ({rc}: {msg})")
