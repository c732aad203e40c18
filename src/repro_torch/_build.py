"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

Each ``csrc/*.cu`` file is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

into ``build/repro_torch/`` at the root of the checkout, under a name keyed
by a hash of the source, of every ``csrc/*.cuh`` header it includes
(``ws_sched.cuh``, the scheduler every megakernel shares) and of the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it is.
The libraries expose a plain C interface (no PyTorch headers), which keeps a
build to seconds.  Nothing here runs at
import time: the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# the work-stealing megakernels (each over csrc/ws_sched.cuh), then the
# standalone kernels of repro_torch.kernels
WS_KERNELS = ("ws_attention", "ws_expert", "ws_expert_grad", "ws_unified")
KERNELS = WS_KERNELS + ("flash_fwd", "decode_attention", "ssd_scan")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds each build took in this process (0.0 when an existing .so was loaded)
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str, csrc: Path) -> List[Path]:
    """``csrc/<name>.cu`` and every local header it includes, transitively."""
    todo, seen = [csrc / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [csrc / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def source_key(name: str, csrc: Optional[Path] = None) -> str:
    """Hash of the source, its included headers (by name and bytes) and the flags."""
    csrc = CSRC if csrc is None else csrc
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_sources(name, csrc)):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def _lib_path(name: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    return build_dir / f"{name}_{source_key(name, csrc)}.so"


def build(name: str, csrc: Optional[Path] = None, build_dir: Optional[Path] = None) -> Path:
    """Compile ``csrc/<name>.cu`` unless the keyed library exists; returns its path.
    The compiler's output (ptxas registers, shared memory, spills) is kept
    beside the library as ``<lib>.log``.  ``csrc``/``build_dir`` build
    another checkout's sources elsewhere (the audit's comparison with an
    earlier build)."""
    csrc = CSRC if csrc is None else Path(csrc)
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    lib = _lib_path(name, csrc, build_dir)
    if lib.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, lib)
    return lib


def build_all(names) -> Dict[str, Path]:
    """Build several kernels at once: one ``nvcc`` each, all started together."""
    names = list(names)
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu`` as a ctypes library."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]


_FORBIDDEN_SASS = re.compile(r"\b(ATOM|ATOMS|ATOMG|RED|MEMBAR|FENCE)\b")
_FORBIDDEN_PTX = re.compile(r"\b(atom|red|fence|membar)\.")
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores")
_HMMA = re.compile(r"\bHMMA\b")


def _demangle(names: List[str]) -> Dict[str, str]:
    """Mangled -> demangled names (cu++filt or c++filt; unchanged without)."""
    cuda_bin = Path(nvcc_path()).parent
    for tool in (str(cuda_bin / "cu++filt"), shutil.which("cu++filt"), shutil.which("c++filt")):
        if tool and os.path.exists(tool):
            out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                                 text=True).stdout.splitlines()
            if len(out) == len(names):
                return dict(zip(names, out))
    return {n: n for n in names}


_UNTRACED = re.compile(r"(, |<)(false|\(bool\)0)>")


def is_traced(demangled: str) -> bool:
    """Whether a kernel function is the traced instantiation (its last
    template argument true, spelled ``true`` or ``(bool)1`` by the demangler)."""
    return bool(re.search(r"(, |<)(true|\(bool\)1)>", demangled.split("(W")[0]))


def function_key(demangled: str) -> str:
    """A kernel function's name as an earlier build spelled it, so the two can
    be set side by side: the untraced instantiation as the untemplated build
    did (``<float, false>`` -> ``<float>``; ``<false>`` and a template's
    ``void `` dropped), and the traced one with its flag spelled ``true``
    whichever demangler printed it."""
    key = _UNTRACED.sub(lambda m: ">" if m.group(1) == ", " else "", demangled)
    if "<" not in key.split("(")[0]:
        key = key.replace("void ", "", 1)
    return key.replace("(bool)1", "true")


def function_stats(name: str, csrc: Optional[Path] = None,
                   build_dir: Optional[Path] = None) -> Dict[str, Dict[str, object]]:
    """Per kernel function of the built library, by demangled name: ptxas'
    registers and spill stores (from the build log), SASS instructions and
    forbidden SASS opcodes and tensor-core instructions (HMMA) (``cuobjdump
    -sass``), and whether it is a traced instantiation (:func:`is_traced`)."""
    lib = build(name, csrc, build_dir)
    stats: Dict[str, Dict[str, object]] = {}
    fn = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = _ENTRY.search(line)
        if m:
            fn = m.group(1)
            stats[fn] = {"registers": None, "spill_stores": 0}
        elif fn is not None and _SPILL.search(line):
            stats[fn]["spill_stores"] = int(_SPILL.search(line).group(1))
        elif fn is not None and _REGS.search(line):
            stats[fn]["registers"] = int(_REGS.search(line).group(1))
    cuda_bin = Path(nvcc_path()).parent
    cuobjdump = shutil.which("cuobjdump") or str(cuda_bin / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        fn, body = part.split("\n", 1)
        fn = fn.strip()
        hits: Dict[str, int] = {}
        for m in _FORBIDDEN_SASS.finditer(body):
            hits[m.group(1)] = hits.get(m.group(1), 0) + 1
        stats.setdefault(fn, {"registers": None, "spill_stores": 0})
        stats[fn].update(sass_instructions=len(re.findall(r"/\*[0-9a-f]{4,}\*/", body)),
                         forbidden_sass=hits, hmma=len(_HMMA.findall(body)))
    names = _demangle(sorted(stats))
    return {names[fn]: dict(st, traced=is_traced(names[fn])) for fn, st in stats.items()}


def fence_audit(name: str, csrc: Optional[Path] = None) -> Dict[str, object]:
    """Count synchronising instructions in the built kernel: SASS opcodes
    ATOM*/RED*/MEMBAR/FENCE (``cuobjdump -sass`` of the library) and PTX
    ``atom.``/``red.``/``fence.``/``membar.`` (``nvcc -ptx`` of the source).
    A fence-free scheduler has zero of each.  ``csrc`` audits a source
    elsewhere (the probes)."""
    csrc = CSRC if csrc is None else Path(csrc)
    lib = build(name, csrc)
    cuda_bin = Path(nvcc_path()).parent
    cuobjdump = shutil.which("cuobjdump") or str(cuda_bin / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ptx_file = lib.with_suffix(".ptx")
    subprocess.run([nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-ptx", "-o",
                    str(ptx_file), str(csrc / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    ptx = ptx_file.read_text()
    sass_hits: Dict[str, int] = {}
    for m in _FORBIDDEN_SASS.finditer(sass):
        sass_hits[m.group(1)] = sass_hits.get(m.group(1), 0) + 1
    ptx_hits: Dict[str, int] = {}
    for m in _FORBIDDEN_PTX.finditer(ptx):
        ptx_hits[m.group(1)] = ptx_hits.get(m.group(1), 0) + 1
    n_sass_instr = len(re.findall(r"/\*[0-9a-f]{4,}\*/", sass))
    return {"sass": sass_hits, "ptx": ptx_hits,
            "sass_instructions": n_sass_instr,
            "sass_kernels": sorted(set(re.findall(r"Function : (\S+)", sass)))}
