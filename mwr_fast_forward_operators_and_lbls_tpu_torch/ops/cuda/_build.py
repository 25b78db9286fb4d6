"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under `csrc/` have a plain C interface, so one `nvcc -shared`
call builds them into a shared library in seconds, with no PyTorch headers.
The library is keyed by a hash of the sources and the flags and lands in
`build/torch_kernels/` at the root of the checkout; it is built at first use.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PACKAGE = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Where the CUDA toolkit installs itself when neither PATH nor CUDA_HOME
# points at it.
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point: without them ctypes passes Python ints as
# 32-bit C ints and cuts the device pointers.
SIGNATURES = {
    # p, t, rho, lwc, o3, freqs, nf, tables, table_size, n_h2o, n_o2, n_o3,
    # h2o_off, o2_off, o3_off, gl_off, n, out, stream
    "mwr_absorption_lb": [_P] * 6 + [_I, _P] + [_I] * 9 + [_P, _P],
    # cos_el, freqs, alpha, z, n, t, E, F, L, B, alpha_is_mid, hk_ghz,
    # t_cosmic, earth_radius, tb, tau, tmr, trans, stream
    "mwr_forward_lb": [_P] * 6 + [_I] * 5 + [_F] * 3 + [_P] * 5,
}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, under $CUDA_HOME or $CUDA_PATH, or under the
    toolkit's default prefix.  Raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 DEFAULT_CUDA_HOME):
        if home:
            nvcc = os.path.join(home, "bin", "nvcc")
            if os.access(nvcc, os.X_OK):
                return nvcc
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin, $CUDA_PATH/bin "
        f"or {DEFAULT_CUDA_HOME}/bin): the CUDA kernels of "
        f"{_PACKAGE.name} are built from {CSRC} with the CUDA toolkit")


def build() -> pathlib.Path:
    """Compile `csrc/*.cu` into one shared library unless it is built already,
    and return its path.  nvcc's report (registers, spills) is kept beside it
    with the suffix `.log`."""
    nvcc = find_nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libmwr_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc exited with {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process, with every entry point's
    argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
