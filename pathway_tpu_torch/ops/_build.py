"""Build-at-first-use for the port's hand-written CUDA kernels.

Every ``pathway_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
``pathway_tpu_torch/_build/<name>-<hash>.so``, which the kernel's Python
wrapper loads with ``ctypes``. The hash covers the source, the headers
beside it and the compiler flags, so an edited kernel rebuilds and an
unchanged one loads from the cache. Sources build in parallel: one
``nvcc`` process per source, all started together.

Also the launch counts: each wrapper calls :func:`count_launch` where it
launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the log
    # optimise and assemble a source's kernels in parallel, one job a
    # core: about half the build time of the attention kernel's 26
    # instantiations (chip_smoke's `device` phase reads build_s)
    "--split-compile=0",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: dict[str, int] = {}
# kernel name -> {tag: launches}, for wrappers that tag a launch (the
# attention kernel's tag is its sequence length)
LAUNCH_TAGS: dict[str, dict[int, int]] = {}


def count_launch(name: str, tag: int | None = None) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    if tag is not None:
        by_tag = LAUNCH_TAGS.setdefault(name, {})
        by_tag[tag] = by_tag.get(tag, 0) + 1


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    LAUNCH_TAGS.clear()


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc (the CUDA toolkit's compiler) was not found in $CUDA_HOME/bin, "
        "on PATH or in /usr/local/cuda/bin; it is needed to build the "
        "kernels in pathway_tpu_torch/csrc/"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, in parallel. Returns {name: library path}.
    Raises if the compiler is missing or any compilation fails; the
    compiler's output is kept in ``_build/<name>-<hash>.log``."""
    names = sources() if names is None else names
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        # compile to a private name, then rename: a concurrent build of
        # the same source never sees a half-written library
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        todo[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
