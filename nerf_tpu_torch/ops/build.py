"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/nerf_tpu_torch/lib<name>-<hash>.so``
under the repository root, and loaded with ``ctypes``.  The file name carries
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source is rebuilt and an unchanged one is not.  Nothing is built when a module is imported: the first
call that launches a kernel builds it, and ``build()`` builds all of them at
once, one ``nvcc`` per source, started together.  A source listed in
``PARTS`` is compiled in that many parts at once, one object each (the
source selects its part's kernels by ``CSRC_PART``), and the objects are
linked into its library: one ``nvcc`` compiles a file's kernels one after
the other, and the dissection's 18 kernels would otherwise take minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
SOURCES = ("fused_mlp", "fused_mlp_bwd", "fused_mlp_recompute", "ref_fused",
           "ref_fused_bwd", "ref_fused_recompute", "ref_dissect")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PARTS = {"ref_dissect": 4}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: on PATH, else under /usr/local/cuda."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels "
                           "of nerf_tpu_torch/ops/csrc)")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS) + f" parts={PARTS.get(name, 1)}"
    digest = hashlib.sha1(src + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile each library that is missing; returns nvcc's report (ptxas
    registers, shared memory and spills) for each one it compiled.  Raises
    with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src = str(CSRC / f"{name}.cu")
        if name in PARTS:
            objs = [out.with_name(f"{out.stem}.{i}.{os.getpid()}.o")
                    for i in range(PARTS[name])]
            cmds = [[nvcc(), *NVCC_FLAGS, "-c", f"-DCSRC_PART={i}", "-o",
                     str(obj), src] for i, obj in enumerate(objs)]
        else:
            objs, cmds = [], [[nvcc(), *NVCC_FLAGS, "-shared", "-o",
                               str(tmp), src]]
        jobs[name] = ([subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                       for cmd in cmds], objs, tmp, out)
    reports, failed = {}, []
    for name, (procs, objs, tmp, out) in jobs.items():
        logs = [proc.communicate()[0] for proc in procs]
        if objs and all(proc.returncode == 0 for proc in procs):
            link = subprocess.run([nvcc(), "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            logs.append(link.stdout + link.stderr)
            procs.append(link)
            for obj in objs:
                obj.unlink()
        if any(proc.returncode != 0 for proc in procs):
            failed.append(f"nvcc failed for {name}.cu:\n" + "\n".join(logs))
            continue
        os.replace(tmp, out)
        reports[name] = "\n".join(logs)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            build((name,))
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
