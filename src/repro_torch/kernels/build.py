"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it includes) has
a plain C interface and is compiled by its own
``nvcc`` process for ``sm_90a`` into ``build/repro_torch/`` at the root of
the checkout (listed in ``.gitignore``), then loaded with ``ctypes``.  All
sources are compiled at once, in parallel, on the first call that needs a
kernel; a library whose file name carries the hash of its source is reused
if it is already there.  Nothing is built when a module is imported: the
CPU tests import every module and this host may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibraries:
    """The loaded kernel libraries, by source name, plus what the build
    said: ``ptxas_log[name]`` holds ``-Xptxas -v``'s register and
    shared-memory report of each library built in this process, and
    ``build_seconds`` the wall time of the last build."""

    def __init__(self) -> None:
        self._libs: dict[str, ctypes.CDLL] = {}
        self.ptxas_log: dict[str, str] = {}
        self.build_seconds = 0.0

    def get(self, name: str) -> ctypes.CDLL:
        if name not in self._libs:
            self.build_all()
        return self._libs[name]

    def build_all(self) -> None:
        """Compile every ``csrc/*.cu`` not yet built (one ``nvcc`` each,
        all started together) and load them."""
        sources = sorted(CSRC.glob("*.cu"))
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src in sources:
            digest = hashlib.sha256(src.read_bytes()
                                    + headers).hexdigest()[:12]
            lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
            if not lib.exists():
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                procs.append((src, lib, tmp, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            else:
                self._libs[src.stem] = ctypes.CDLL(str(lib))
        failures = []
        for src, lib, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {src.name}:\n{out}")
                continue
            self.ptxas_log[src.stem] = out
            os.replace(tmp, lib)
            self._libs[src.stem] = ctypes.CDLL(str(lib))
        self.build_seconds = time.perf_counter() - t0
        if failures:
            raise RuntimeError("\n".join(failures))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this host")


LIBS = KernelLibraries()


def cuobjdump() -> str | None:
    """The toolkit's cuobjdump, or None where there is none."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return tool if os.path.exists(tool) else None


def sass_counts(lib_names: tuple[str, ...],
                ops: tuple[str, ...] = ("HGMMA", "UTMALDG")) -> dict | None:
    """Lines of each op in the SASS of each built library (``cuobjdump
    -sass``), e.g. HGMMA (wgmma) and UTMALDG (TMA load); None where the
    toolkit has no cuobjdump."""
    tool = cuobjdump()
    if tool is None:
        return None
    counts = {}
    for name in lib_names:
        sass = subprocess.run([tool, "-sass", LIBS.get(name)._name],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
        counts[name] = {op: sum(op in line for line in sass) for op in ops}
    return counts


@functools.cache
def c_function(lib_name: str, fn_name: str, argtypes: tuple = (),
               restype=ctypes.c_int):
    """``fn_name`` of the library built from ``csrc/<lib_name>.cu``, with
    its argument types set (``ctypes.c_void_p`` for each pointer and the
    stream, so that none is cut to 32 bits) and its return type: by
    default an int, the CUDA error of the launch, 0 when none."""
    fn = getattr(LIBS.get(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn
