"""Build the CUDA sources under ``tpusr_torch/csrc`` with ``nvcc`` at first use.

Each ``.cu`` file is compiled on its own into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``) and loaded
with ``ctypes``. Libraries land in ``tpusr_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
``build_all`` starts one ``nvcc`` per source, all together.

Nothing here runs at import time: the CPU tests import every module of the
package on machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the entry points, per source file
SIGNATURES = {
    "block1": {
        "block1_int8_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _P],
    },
    "conv3x3": {
        "conv3x3_int8_requant_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _P],
        "conv3x3_int8_dequant_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _P],
        "conv3x3_bias_act_f32_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                        _P],
        "conv3x3_bias_act_bf16_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _P],
    },
    "nlm": {
        "nlm_denoise_launch": [_P, _P, _P, _I, _I, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _compile(name: str) -> subprocess.Popen | None:
    """Start nvcc for one source unless its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path, proc.src_name = out, tmp, name
    return proc


def _finish(proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{proc.src_name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {proc.src_name}.cu "
                           f"(rc={proc.returncode}):\n{log[-4000:]}")
    os.replace(proc.tmp_path, proc.out_path)


def build_all() -> list[str]:
    """Compile every source in ``csrc`` in parallel; returns their names."""
    names = sorted(SIGNATURES)
    with _lock:
        procs = [p for p in (_compile(n) for n in names) if p is not None]
        errors = []
        for p in procs:
            try:
                _finish(p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            proc = _compile(name)
            if proc is not None:
                _finish(proc)
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err:
        msg = getattr(load(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
