"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in `dmayolo_tpu_torch/csrc/` has a plain C interface and
builds into its own shared library for `sm_90a`, at first use, under
`build/torch_kernels/` at the root of the checkout (listed in
`.gitignore`); a source that takes long builds into several, each with a
macro that keeps a part of its kernels (`PART_OF`).  A library's file
name carries a hash of its source, the headers beside it (`*.cuh`) and
its flags, so an edited source is rebuilt and an unchanged one is reused.
`build()` starts one nvcc per library, all at once.

The host library of the data path (`csrc/host/imgio.cpp`, plain C++ for
the CPU) is built the same way with g++ (`load_host_library`).  Its JPEG
codec is compiled in only where the system has `<jpeglib.h>`; the flag
that says so is part of the library's name.  Where it has not, JPEG goes
through the CUDA toolkit's nvJPEG: `csrc/host/nvjpeg_codec.cpp`, host
code built with g++ against `nvjpeg.h`, `libnvjpeg` and `libcudart`
(`load_nvjpeg_library`), only where the toolkit has that header.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# per-library nvcc flags beyond the common ones
SOURCES = {
    # bit-exact IoU: no FMA contraction, so every product and sum rounds
    # as in the plain PyTorch version and the JAX reference
    "nms_greedy": ["-fmad=false"],
    "nms_fixpoint": ["-fmad=false"],
    "conv3x3_s1": [],
    # the int8 conv's dequant epilogue rounds each product and sum as
    # XLA does; route (d) and the quantize in one library, the wgmma
    # kernel's instances in one a BN (csrc/conv_int8.cu, CI8_TC_BN)
    "conv_int8": ["-fmad=false", "-DCI8_TC_BN=-1"],
    **{f"conv_int8_bn{bn}": ["-fmad=false", f"-DCI8_TC_BN={bn}"] for bn in (64, 128, 256)},
}
# the libraries built from a part of another's source
PART_OF = {f"conv_int8_bn{bn}": "conv_int8" for bn in (64, 128, 256)}
_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = cuda_home()
    if home is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(home / "bin" / "nvcc")


def _flags(name: str):
    return _COMMON + SOURCES[name]


def source_path(name: str) -> Path:
    return CSRC / f"{PART_OF.get(name, name)}.cu"


def library_path(name: str) -> Path:
    # the headers in csrc/ count as part of every source
    src = b"".join(p.read_bytes() for p in [source_path(name), *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every listed library that is not built yet, one nvcc each,
    all started together.  Returns {name: compiler output}; raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(source_path(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


_HOST_COMMON = ["-std=c++17", "-O3", "-fPIC", "-shared"]
_headers: Dict[str, bool] = {}


def has_header(header: str) -> bool:
    """Whether g++ finds `<header>` on this machine."""
    with _lock:
        if header not in _headers:
            proc = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                                  input=f"#include <cstdio>\n#include <{header}>\n", capture_output=True, text=True)
            _headers[header] = proc.returncode == 0
        return _headers[header]


def host_library_path(name: str, cflags, libs) -> Path:
    src = (CSRC / "host" / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(cflags + libs).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-host-{digest}.so"


def load_host_library(name: str) -> ctypes.CDLL:
    """The host library `name`, built with g++ on first use and cached;
    with the JPEG codec where the system's libjpeg header is found."""
    jpeg = has_header("jpeglib.h")
    cflags = _HOST_COMMON + (["-DIMGIO_JPEG"] if jpeg else [])
    libs = ["-ljpeg"] if jpeg else []
    return _load_host(name, cflags, libs)


def cuda_home():
    """The CUDA toolkit's root as torch finds it ($CUDA_HOME, $CUDA_PATH,
    nvcc on PATH, /usr/local/cuda), or None."""
    from torch.utils.cpp_extension import CUDA_HOME

    return Path(CUDA_HOME) if CUDA_HOME else None


def nvjpeg_header() -> bool:
    """Whether the CUDA toolkit here has nvJPEG's header."""
    home = cuda_home()
    return home is not None and (home / "include" / "nvjpeg.h").exists()


def load_nvjpeg_library() -> ctypes.CDLL:
    """The nvJPEG codec (`csrc/host/nvjpeg_codec.cpp`), built with g++
    against the toolkit's headers and libraries on first use and cached;
    raises where the toolkit has no `nvjpeg.h`."""
    if not nvjpeg_header():
        raise RuntimeError("nvJPEG not found: no CUDA toolkit with include/nvjpeg.h "
                           "(set CUDA_HOME)")
    home = cuda_home()
    cflags = _HOST_COMMON + [f"-I{home / 'include'}"]
    lib_dir = home / "lib64"
    libs = [f"-L{lib_dir}", "-lnvjpeg", "-lcudart", f"-Wl,-rpath,{lib_dir}"]
    return _load_host("nvjpeg_codec", cflags, libs)


def _load_host(name: str, cflags, libs) -> ctypes.CDLL:
    out = host_library_path(name, cflags, libs)
    with _lock:
        lib = _libs.get(out.name)
        if lib is None:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
                proc = subprocess.run(
                    ["g++", *cflags, "-o", str(tmp), str(CSRC / "host" / f"{name}.cpp"), *libs],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}")
                os.replace(tmp, out)
            lib = _libs[out.name] = ctypes.CDLL(str(out))
        return lib


def load_library(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use and cached."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
