"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under `csrc/` have a plain C interface and include no PyTorch
headers: nvcc compiles each in its own process, in parallel, and one
`nvcc -shared` call links them into a shared library.  The library is keyed
by a hash of the sources and the flags and lands in `build/torch_kernels/`
at the root of the checkout; it is built at first use.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Where the CUDA toolkit installs itself when neither PATH nor CUDA_HOME
# points at it.
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_P, _I, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_double)
# argtypes of every C entry point: without them ctypes passes Python ints as
# 32-bit C ints and cuts the device pointers.
SIGNATURES = {
    # p, t, rho, lwc, o3, freqs (on the host), nf, tables, table_size, n_h2o,
    # n_o2, n_o3, h2o_off, o2_off, o3_off, gl_off, n, out, stream
    "mwr_absorption_lb": [_P] * 6 + [_I, _P] + [_I] * 9 + [_P, _P],
    # nf, table_floats, n_lines
    "mwr_absorption_resident_warps": [_I] * 3,
    # p, t, rho, lwc, freqs (on the host), nf, tables, n_h2o, n_o2, h2o_off,
    # o2_off, gl_off, n, out, out_dt, out_dr, out_dl (or null), stream
    "mwr_absorption_tangents_lb": [_P] * 5 + [_I, _P] + [_I] * 6 + [_P] * 5,
    # nf, n_h2o, n_o2
    "mwr_absorption_tangents_resident_warps": [_I] * 3,
    # cos_el64, freqs, alpha, z, n, t, E, F, L, B, alpha_is_mid, hk_ghz,
    # t_cosmic, earth_radius, tb, tau, tmr, trans, stream
    "mwr_forward_lb": [_P] * 6 + [_I] * 5 + [_F] * 3 + [_P] * 5,
    # alpha, E, F, L, B
    "mwr_forward_lb_copy_bytes": [_P] + [_I] * 4,
    # cos_el64, freqs, alpha, z, n, t, g_tb, its three strides, E, C, L, B,
    # hk_ghz, t_cosmic, earth_radius, d_alpha, stream
    "mwr_forward_lb_vjp": [_P] * 7 + [_I] * 7 + [_F] * 2 + [_D, _P, _P],
    # freqs, alpha, ds, t, E, F, L, B, alpha_is_mid, hk_ghz, t_cosmic, tb,
    # tau, tmr, trans, stream
    "mwr_downwelling_lb": [_P] * 4 + [_I] * 5 + [_F] * 2 + [_P] * 5,
    # p, t, rho, lwc, freqs, nf, tables, n_h2o, n_o2, h2o_off, o2_off,
    # gl_off, h2o_slots, n, lines, scratch, out, stream
    "mwr_absorption_spectral": [_P] * 5 + [_I, _P] + [_I] * 8 + [_P] * 3,
    # n_h2o, n_o2, h2o_slots
    "mwr_absorption_spectral_resident_warps": [_I] * 3,
    # kind, F, L, alpha_is_mid, want_trans, wide
    "mwr_staged_resident_warps": [_I] * 6,
    # mode, freqs, alpha, da, da2, ds, t, dnl, dk, dn, r0cos, E, F, L, B,
    # hk_ghz, t_cosmic, out, out2, stream
    "mwr_kmatrix_lb": [_I] + [_P] * 10 + [_I] * 4 + [_F] * 2 + [_P] * 3,
    # mode, L
    "mwr_kmatrix_resident_warps": [_I] * 2,
    # op, k, x, out, n, threads, stream
    "mwr_chain": [_I, _I, _P, _P, _I, _I, _P],
    # cos_el, z, p, t, rho, E, L, B, rv, earth_radius, k1, k2, k3, ds,
    # dds_dnl, dds_dk, dn_t, dn_rho, r0cos, stream
    "mwr_slant_geometry_lb": [_P] * 5 + [_I] * 3 + [_D] * 5 + [_P] * 7,
    # freqs, knots, w, w_row, w_col, cos_el, z, p, t, t_row, rho, lwc, B, E,
    # C, L, hk_ghz, t_cosmic, rv, earth_radius, k1, k2, k3, k_t, k_rho,
    # stream
    "mwr_fastk_adjoint": [_P] * 3 + [_I] * 2 + [_P] * 4 + [_I] + [_P] * 2
    + [_I] * 4 + [_F] * 2 + [_D] * 5 + [_P] * 3,
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
    and return its path.  Each source compiles in its own nvcc process, all
    started together; one `nvcc -shared` links the objects.  nvcc's report
    (registers, spills) is kept beside the library with the suffix `.log`."""
    nvcc = find_nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libmwr_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [f"== {src.name}\n{proc.communicate()[0]}"
            for src, proc in zip(sources, procs)]
    tmp = lib.with_name(f"{tag}.tmp")
    try:
        failed = [log for log, proc in zip(logs, procs) if proc.returncode]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                   *map(str, objs)],
                                  capture_output=True, text=True, check=False)
            if link.returncode:
                failed = [f"== link\n{link.stdout}{link.stderr}"]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "".join(failed))
        lib.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
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
