"""Build and bind the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries are built on first use into
``build/hpslam_tpu_torch/`` at the repository root (or ``$HPSLAM_TORCH_BUILD``),
which ``.gitignore`` lists; the file name carries a hash of the source, of
every header it includes from ``csrc/`` and of the flags, so an edited
source or header is never served by a stale build.

Every wrapper counts its kernel launches in ``LAUNCHES`` (one per launch of
the kernel it wraps, nowhere else), so a run can show that the main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# C signatures: (name, argtypes, restype); P = pointer, I = int, F = float
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
SIGNATURES = {
    "topk_rows": [
        ("hp_topk_rows", [_P, _P, _I, _I, _I, _P, _P, _P], _I),
        ("hp_topk_blocks_per_sm", [_I, _I], _I),
    ],
    "maploss": [
        ("hp_maploss_scratch_floats", [_I] * 9, _L),
        ("hp_maploss",
         [_P, _I, _P, _I, _P, _P, _P, _P,        # row .. Bc
          _P, _P,                                # gw, cw pointer arrays
          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # n S u C emb/hid nb skip
          _I, _F, _I, _I, _F, _I, _I,            # flags, coef, w_color
          _P, _P, _P, _P, _P, _P, _I,            # scratch .. wsplits
          _P], _I),
    ],
    "trunks": [
        ("hp_trunks_scratch_floats", [_I] * 9, _L),
        ("hp_trunks_blocks_per_sm", [_I] * 7, _I),
        ("hp_trunks",
         [_P, _P, _P, _P, _P, _P, _P,            # p cg cc Bg Bc gw cw
          _I, _I, _I, _I, _I, _I, _I, _I,        # n C emb/hid nb skip
          _I, _I, _I, _I,                        # flags
          _P, _P, _P, _P, _P, _P, _P, _P,        # g_occ .. dcc
          _P, _P, _I, _P], _I),                  # dcw wpart wsplits stream
    ],
    "trackloss": [
        ("hp_trackloss_scratch_floats", [_I] * 6, _L),
        ("hp_trackloss_blocks_per_sm", [_I] * 7, _I),
        ("hp_trackloss",
         [_P, _P, _I, _P, _P, _P, _P, _P, _P,    # rays rowc Dr .. gw cw
          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # n S K C emb/hid nb skip
          _F, _I, _I, _I, _I,                    # coef, flags
          _P, _P, _P, _P, _P, _P, _P, _P,        # g_depth .. daff
          _P], _I),                              # stream
    ],
    "composite": [
        ("hp_composite_scratch_floats", [_I] * 9, _L),
        ("hp_composite_blocks_per_sm", [_I] * 7, _I),
        ("hp_composite",
         [_P, _P, _P, _P, _P, _P, _P, _P, _P,    # p cg cc z pm Bg Bc gw cw
          _I, _I, _I, _I, _I, _I, _I, _I, _I,    # n_r S C emb/hid nb skip
          _I, _F, _I, _I, _I,                    # with_color coef flags
          _P, _P, _P,                            # dD dV dC
          _P, _P, _P, _P, _P, _P,                # scratch depth .. rgb
          _P, _P, _P, _P, _I, _P], _I),          # dcg dcc dcw wpart ws st
    ],
}

LAUNCHES: Counter = Counter()
_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def build_dir() -> str:
    d = os.environ.get("HPSLAM_TORCH_BUILD")
    if not d:
        d = os.path.join(os.path.dirname(_HERE), "build", "hpslam_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every header it includes from ``csrc/``,
    transitively, in first-include order."""
    out, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in out:
            continue
        out.append(f)
        with open(os.path.join(_CSRC, f), "rb") as fh:
            todo += [m.decode() for m in _INCLUDE.findall(fh.read())]
    return out


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources(name):
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:16]}.so")


def compile_command(name: str, out: str, extra=()) -> list:
    return [nvcc_path(), *NVCC_FLAGS, *extra, "-o", out,
            os.path.join(_CSRC, f"{name}.cu")]


def start_build(name: str, extra=()):
    """Start nvcc for one source; returns (Popen or None if built, path)."""
    out = lib_path(name)
    if os.path.exists(out):
        return None, out
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(compile_command(name, tmp, extra),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out


def finish_build(proc, out: str) -> str:
    """Wait for a build from start_build; returns nvcc's output."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = proc.args[proc.args.index("-o") + 1]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(extra=()) -> dict:
    """Build every source at once (one nvcc per source, all started
    together); returns {name: nvcc output}."""
    started = {n: start_build(n, extra) for n in SIGNATURES}
    return {n: finish_build(*started[n]) for n in started}


def bind(path: str, name: str):
    lib = ctypes.CDLL(path)
    for fn, argtypes, restype in SIGNATURES[name]:
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def lib(name: str):
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            proc, out = start_build(name)
            finish_build(proc, out)
            _LIBS[name] = bind(out, name)
        return _LIBS[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
