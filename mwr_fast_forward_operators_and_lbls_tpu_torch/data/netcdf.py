"""NetCDF I/O: own classic-format codec + HDF5-backed (NetCDF-4) reader.

The reference's stages communicate exclusively through NetCDF files
(SURVEY.md section 1); to keep that contract without the xarray/netCDF4
packages (absent from this image), this module implements the NetCDF
*classic* binary format (CDF-1 / CDF-2 64-bit-offset / CDF-5 64-bit-data)
from the public file-format specification — read and write — plus a reader
for NetCDF-4 (HDF5-based) files via h5py.  Files we write open unchanged in
xarray/netCDF4/ncdump, so a user of the reference pipeline can consume our
outputs directly.

A C++ fast path for bulk decode lives in native/ncio (used when built); this
pure-NumPy implementation is the always-available reference codec.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils import native
from .dataset import Dataset, Variable

NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
NC_UBYTE, NC_USHORT, NC_UINT, NC_INT64, NC_UINT64 = 7, 8, 9, 10, 11

_TYPEMAP = {
    NC_BYTE: np.dtype(">i1"), NC_CHAR: np.dtype("S1"),
    NC_SHORT: np.dtype(">i2"), NC_INT: np.dtype(">i4"),
    NC_FLOAT: np.dtype(">f4"), NC_DOUBLE: np.dtype(">f8"),
    NC_UBYTE: np.dtype(">u1"), NC_USHORT: np.dtype(">u2"),
    NC_UINT: np.dtype(">u4"), NC_INT64: np.dtype(">i8"),
    NC_UINT64: np.dtype(">u8"),
}
_REVMAP = {
    "i1": NC_BYTE, "i2": NC_SHORT, "i4": NC_INT, "f4": NC_FLOAT,
    "f8": NC_DOUBLE, "u1": NC_UBYTE, "u2": NC_USHORT, "u4": NC_UINT,
    "i8": NC_INT64, "u8": NC_UINT64, "S1": NC_CHAR,
}
_CDF5_ONLY = {NC_UBYTE, NC_USHORT, NC_UINT, NC_INT64, NC_UINT64}

_ZERO, _NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0, 0x0A, 0x0B, 0x0C


def _pad4(n: int) -> int:
    return (4 - n % 4) % 4


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, buf: bytes, path: str = "<bytes>"):
        self.buf = buf
        self.pos = 0
        self.path = path

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError(
                f"{self.path}: truncated or corrupt NetCDF header — needed "
                f"{n} bytes at offset {self.pos}, file has {len(self.buf)}")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def i4(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i8(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def size_t(self, cdf5: bool) -> int:
        return self.i8() if cdf5 else self.i4()

    def name(self, cdf5: bool) -> str:
        n = self.size_t(cdf5)
        s = self.take(n).decode("utf-8", "replace")
        self.take(_pad4(n))
        return s

    def values(self, nc_type: int, nelems: int):
        dt = _TYPEMAP[nc_type]
        nbytes = dt.itemsize * nelems
        raw = self.take(nbytes)
        self.take(_pad4(nbytes))
        if nc_type == NC_CHAR:
            return raw.decode("utf-8", "replace")
        arr = np.frombuffer(raw, dt).astype(dt.newbyteorder("="))
        return arr[0] if nelems == 1 else arr

    def att_list(self, cdf5: bool) -> dict:
        tag = self.i4()
        n = self.size_t(cdf5)
        if tag == _ZERO:
            return {}
        if tag != _NC_ATTRIBUTE:
            raise ValueError(
                f"{self.path}: corrupt NetCDF header — expected NC_ATTRIBUTE "
                f"tag at offset {self.pos - 8}, got {tag}")
        out = {}
        for _ in range(n):
            nm = self.name(cdf5)
            nc_type = self.i4()
            nelems = self.size_t(cdf5)
            out[nm] = self.values(nc_type, nelems)
        return out


def read_classic(path: str, lazy: bool = False) -> Dataset:
    """Parse a CDF-1/2/5 file into a Dataset.

    lazy=True memory-maps the file and returns zero-copy big-endian views
    into the map instead of decoded copies: opening a multi-GB harmonized
    campaign file costs only the header parse, and the OS pages data in as
    variables are actually touched (the reference's own outputs reach this
    scale — 520 x 180 x 10 x 72 x 14 plus model outputs).  The views keep
    the mapping alive through their buffer reference.
    """
    if lazy:
        import mmap

        with open(path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        return read_classic_bytes(mm, path, lazy=True)
    with open(path, "rb") as fh:
        buf = fh.read()
    return read_classic_bytes(buf, path)


def read_classic_bytes(buf, path: str = "<bytes>",
                       lazy: bool = False) -> Dataset:
    """Parse an in-memory CDF-1/2/5 file image (the native parallel loader
    hands whole-file buffers here, utils/native.read_files)."""
    if buf[:3] != b"CDF":
        raise ValueError(f"{path}: not a NetCDF classic file")
    version = buf[3]
    if version not in (1, 2, 5):
        raise ValueError(f"{path}: unsupported CDF version {version}")
    cdf5 = version == 5
    p = _Parser(buf, path)
    p.take(4)
    numrecs = p.size_t(cdf5)
    if numrecs in (0xFFFFFFFF, -1):
        numrecs = None  # STREAMING: infer later

    # dimensions
    tag = p.i4()
    ndims = p.size_t(cdf5)
    dims: list[tuple[str, int]] = []
    if tag == _NC_DIMENSION:
        for _ in range(ndims):
            nm = p.name(cdf5)
            sz = p.size_t(cdf5)
            dims.append((nm, sz))
    rec_dim = next((i for i, (_, sz) in enumerate(dims) if sz == 0), None)

    gatts = p.att_list(cdf5)

    tag = p.i4()
    nvars = p.size_t(cdf5)
    ds = Dataset(attrs=gatts)
    var_meta = []
    if tag == _NC_VARIABLE:
        for _ in range(nvars):
            nm = p.name(cdf5)
            rank = p.size_t(cdf5)
            dimids = [p.size_t(cdf5) for _ in range(rank)]
            vatts = p.att_list(cdf5)
            nc_type = p.i4()
            vsize = p.size_t(cdf5)
            begin = p.i8() if version >= 2 else p.i4()
            var_meta.append((nm, dimids, vatts, nc_type, vsize, begin))

    rec_vars = [m for m in var_meta if rec_dim is not None and
                m[1] and m[1][0] == rec_dim]
    recsize = sum(m[4] for m in rec_vars)
    if len(rec_vars) == 1:
        recsize = rec_vars[0][4]  # spec: single record var is unpadded
    if numrecs is None and rec_vars:
        first = min(m[5] for m in rec_vars)
        numrecs = (len(buf) - first) // max(recsize, 1)

    for nm, dimids, vatts, nc_type, vsize, begin in var_meta:
        dt = _TYPEMAP[nc_type]
        is_rec = rec_dim is not None and dimids and dimids[0] == rec_dim
        shape = tuple(
            (numrecs or 0) if i == rec_dim else dims[i][1] for i in dimids)
        dnames = tuple(dims[i][0] for i in dimids)
        fixed_count = int(np.prod(shape[1:] if is_rec else shape, dtype=np.int64))
        # Bounds check before any frombuffer: a truncated data region must
        # name the variable, not surface as a numpy buffer-size error.
        if is_rec and (numrecs or 0) > 0:
            end = begin + (numrecs - 1) * recsize + fixed_count * dt.itemsize
        else:
            end = begin + fixed_count * dt.itemsize
        if begin < 0 or ((numrecs or 0) > 0 or not is_rec) and end > len(buf):
            raise ValueError(
                f"{path}: truncated NetCDF file — variable {nm!r} data "
                f"extends to byte {end} but the file has {len(buf)}")
        if nc_type == NC_CHAR:
            if is_rec:
                parts = [np.frombuffer(buf, dt, fixed_count, begin + r * recsize)
                         for r in range(numrecs or 0)]
                data = (np.stack(parts) if parts
                        else np.empty((0,) + shape[1:], dt)).reshape(shape)
            else:
                data = np.frombuffer(buf, dt, fixed_count, begin).reshape(shape)
            data = data.view("S1")
        elif lazy:
            if is_rec:
                # Zero-copy strided view over the interleaved record blocks.
                inner = shape[1:]
                strides = (recsize,) + tuple(
                    int(np.prod(inner[i + 1:], dtype=np.int64))
                    * dt.itemsize for i in range(len(inner)))
                data = np.ndarray(shape, dt, buffer=buf, offset=begin,
                                  strides=strides)
            else:
                data = np.frombuffer(buf, dt, fixed_count,
                                     begin).reshape(shape)
        elif is_rec:
            data = native.gather_records_be(
                buf, dt, numrecs or 0, recsize, fixed_count, begin
            ).reshape(shape)
        else:
            data = native.decode_be(buf, dt, fixed_count, begin).reshape(shape)
        ds.variables[nm] = Variable(dnames, data, vatts)
    # keep zero-sized declared dims visible through a stash attr-free way:
    ds.attrs.setdefault("_dims_declared", {nm: sz for nm, sz in dims})
    return ds


def read_hdf5(path: str) -> Dataset:
    """Read a NetCDF-4 (HDF5) file via h5py into a Dataset."""
    import h5py

    ds = Dataset()
    with h5py.File(path, "r") as f:
        def decode(v):
            if isinstance(v, bytes):
                return v.decode("utf-8", "replace")
            if isinstance(v, np.ndarray) and v.dtype.kind in "SO":
                return " ".join(x.decode("utf-8", "replace")
                                if isinstance(x, bytes) else str(x) for x in v)
            return v

        ds.attrs.update({k: decode(v) for k, v in f.attrs.items()
                         if not k.startswith("_Netcdf")})
        for name, node in f.items():
            if not isinstance(node, h5py.Dataset):
                continue
            attrs = {k: decode(v) for k, v in node.attrs.items()
                     if k not in ("DIMENSION_LIST", "CLASS", "NAME",
                                  "REFERENCE_LIST", "_Netcdf4Dimid",
                                  "_Netcdf4Coordinates")}
            if "DIMENSION_LIST" in node.attrs:
                dims = []
                for refs in node.attrs["DIMENSION_LIST"]:
                    ref = refs[0] if len(refs) else None
                    dims.append(f[ref].name.split("/")[-1] if ref else "?")
                dims = tuple(dims)
            elif node.attrs.get("CLASS") == b"DIMENSION_SCALE":
                dims = (name,)
            else:
                dims = tuple(f"phony_dim_{i}" for i in range(node.ndim))
            data = node[()]
            if data.dtype.kind == "O":
                data = np.asarray([decode(x) for x in data.ravel()],
                                  dtype="U").reshape(data.shape)
            ds.variables[name] = Variable(dims, data, attrs)
    return ds


def read(path: str, lazy: bool = False) -> Dataset:
    """Open either classic or HDF5-based NetCDF.

    lazy=True mmaps classic files (zero-copy big-endian views; memory stays
    bounded on multi-GB inputs).  HDF5 reads are always materialized.
    """
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic[:3] == b"CDF":
        return read_classic(path, lazy=lazy)
    if magic[:8] == b"\x89HDF\r\n\x1a\n":
        return read_hdf5(path)
    raise ValueError(f"{path}: unrecognized format {magic!r}")


def read_many(paths: list) -> list:
    """Read many NetCDF files with the native OpenMP file pool (the ingest
    layer opens hundreds of small scan files per launch — the reference\'s
    hot ingest loop, MWR_read_in_module.py:167-234).

    Returns [Dataset | None] aligned with `paths`; classic files parse from
    the concurrently-read buffers, HDF5 files fall back to `read`.
    """
    from ..utils import native

    bufs = native.read_files(list(paths))
    out = []
    for path, buf in zip(paths, bufs):
        try:
            if buf is None:
                out.append(None)
            elif buf[:3] == b"CDF":
                out.append(read_classic_bytes(buf, path))
            else:
                out.append(read(path))
        except Exception:
            out.append(None)
    return out


# ---------------------------------------------------------------------------
# NetCDF-4 (HDF5) writer
# ---------------------------------------------------------------------------

# netcdf-c's sentinel NAME for a dimension without a coordinate variable
# (libsrc4/nc4hdf.c, DIM_WITHOUT_VARIABLE): sentence + %10d length.
_DIM_WITHOUT_VARIABLE = "This is a netCDF dimension but not a netCDF variable."


def _h5_value(v):
    if isinstance(v, str):
        return v
    if isinstance(v, np.ndarray) and v.dtype.kind == "U":
        return [s.encode("utf-8") for s in v.ravel()]
    return v


def write_hdf5(path: str, ds: Dataset, compression=None) -> None:
    """Write the Dataset as NetCDF-4 (HDF5 with netCDF-4 conventions).

    The reference pipeline's own outputs are netCDF4-by-default (xarray
    `to_netcdf`, reference/python_src/preproc/preprocessing4all.py:
    1397-1401); this writer produces the same on-disk dialect — dimension
    scales, DIMENSION_LIST attachments, `_Netcdf4Dimid` markers — so
    xarray/netCDF4 tooling opens our compat-mode files exactly as it opens
    the reference's.

    compression: e.g. "gzip" to chunk+deflate the data variables.
    """
    import h5py

    dims: dict[str, int] = {}
    for nm, var in ds.variables.items():
        for d, n in zip(var.dims, var.data.shape):
            if dims.setdefault(d, n) != n:
                raise ValueError(f"dim {d} size conflict")

    def as_h5(data: np.ndarray) -> np.ndarray:
        if data.dtype.kind == "U":
            return np.char.encode(data, "utf-8")
        if data.dtype.kind == "b":
            return data.astype("i1")
        return data

    coord_names = {d for d in dims
                   if d in ds.variables and ds.variables[d].dims == (d,)}
    with h5py.File(path, "w") as f:
        for k, v in ds.attrs.items():
            if k.startswith("_dims"):
                continue
            f.attrs[k] = _h5_value(v)
        # 1) dimension scales
        for dimid, (d, n) in enumerate(dims.items()):
            if d in coord_names:
                data = as_h5(np.asarray(ds.variables[d].data))
                dset = f.create_dataset(d, data=data,
                                        compression=compression)
                dset.make_scale(d)
                for ak, av in ds.variables[d].attrs.items():
                    dset.attrs[ak] = _h5_value(av)
            else:
                dset = f.create_dataset(d, shape=(n,), dtype=">f4")
                dset.make_scale(f"{_DIM_WITHOUT_VARIABLE}{n:10d}")
            dset.attrs["_Netcdf4Dimid"] = np.int32(dimid)
        # 2) data variables with their dims attached
        for nm, var in ds.variables.items():
            if nm in coord_names:
                continue
            data = as_h5(np.asarray(var.data))
            dset = f.create_dataset(nm, data=data, compression=compression)
            for ak, av in var.attrs.items():
                dset.attrs[ak] = _h5_value(av)
            for axis, d in enumerate(var.dims):
                dset.dims[axis].attach_scale(f[d])


# ---------------------------------------------------------------------------
# Writer (classic; CDF-2 default, CDF-5 when 64-bit/unsigned types present)
# ---------------------------------------------------------------------------

def _nc_type_for(arr: np.ndarray) -> tuple[int, np.ndarray]:
    dt = arr.dtype
    if dt.kind == "U":
        return NC_CHAR, arr
    if dt.kind == "S":
        return NC_CHAR, arr
    if dt.kind == "b":
        return NC_BYTE, arr.astype("i1")
    key = f"{dt.kind}{dt.itemsize}"
    if key == "f2":
        return NC_FLOAT, arr.astype("f4")
    if key not in _REVMAP:
        raise TypeError(f"cannot map dtype {dt} to NetCDF classic")
    return _REVMAP[key], arr


def _encode_values(nc_type: int, value) -> tuple[bytes, int]:
    if nc_type == NC_CHAR:
        if isinstance(value, np.ndarray):
            raw = value.astype("S1").tobytes()
        else:
            raw = str(value).encode("utf-8")
        return raw, len(raw)
    arr = np.atleast_1d(np.asarray(value))
    dt = _TYPEMAP[nc_type]
    return arr.astype(dt).tobytes(), arr.size


class _Writer:
    def __init__(self, cdf5: bool):
        self.cdf5 = cdf5
        self.parts: list[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(b)

    def i4(self, v: int):
        self.raw(struct.pack(">i", v))

    def i8(self, v: int):
        self.raw(struct.pack(">q", v))

    def size_t(self, v: int):
        (self.i8 if self.cdf5 else self.i4)(v)

    def name(self, s: str):
        b = s.encode("utf-8")
        self.size_t(len(b))
        self.raw(b + b"\x00" * _pad4(len(b)))

    def att_list(self, attrs: dict):
        attrs = {k: v for k, v in attrs.items() if not k.startswith("_dims")}
        if not attrs:
            self.i4(_ZERO)
            self.size_t(0)
            return
        self.i4(_NC_ATTRIBUTE)
        self.size_t(len(attrs))
        for k, v in attrs.items():
            if isinstance(v, str) or (isinstance(v, np.ndarray) and
                                      v.dtype.kind in "SU"):
                nc_type = NC_CHAR
            else:
                arr = np.atleast_1d(np.asarray(v))
                nc_type, _ = _nc_type_for(arr)
                if not self.cdf5 and nc_type in _CDF5_ONLY:
                    nc_type = NC_INT if arr.dtype.kind in "iu" else NC_DOUBLE
            raw, nelems = _encode_values(nc_type, v)
            self.name(k)
            self.i4(nc_type)
            self.size_t(nelems)
            self.raw(raw + b"\x00" * _pad4(len(raw)))

    def tobytes(self) -> bytes:
        return b"".join(self.parts)


def write(path: str, ds: Dataset, version: int | None = None,
          fmt: str = "classic") -> None:
    """Write the Dataset as NetCDF.

    fmt: "classic" (CDF-2/5, own codec) or "netcdf4" (HDF5-based, the
    reference's default output dialect — see `write_hdf5`).
    version: for classic — 2 (64-bit offset, default) or 5 (64-bit data;
    auto-selected when any variable needs int64/unsigned types).
    """
    if fmt == "netcdf4":
        return write_hdf5(path, ds)
    if fmt != "classic":
        raise ValueError(f"unknown NetCDF format {fmt!r}")
    converted = {}
    for nm, var in ds.variables.items():
        data = var.data
        if data.dtype.kind == "U":
            ml = max((len(s) for s in data.ravel()), default=1) or 1
            b = np.array([s.encode("utf-8")[:ml].ljust(ml, b"\x00")
                          for s in data.ravel()], dtype=f"S{ml}")
            data = b.view("S1").reshape(data.shape + (ml,))
            converted[nm] = Variable(var.dims + (f"string{ml}_{nm}",),
                                     data, var.attrs)
        else:
            converted[nm] = Variable(var.dims, data, var.attrs)

    if version is None:
        version = 2
        for var in converted.values():
            t, _ = _nc_type_for(var.data)
            if t in _CDF5_ONLY:
                version = 5
    cdf5 = version == 5

    dims: dict[str, int] = {}
    for var in converted.values():
        for d, n in zip(var.dims, var.data.shape):
            if dims.setdefault(d, n) != n:
                raise ValueError(f"dim {d} size conflict")
    dim_ids = {d: i for i, d in enumerate(dims)}

    w = _Writer(cdf5)
    w.raw(b"CDF" + bytes([version]))
    w.size_t(0)  # numrecs (no record dim)
    if dims:
        w.i4(_NC_DIMENSION)
        w.size_t(len(dims))
        for d, n in dims.items():
            w.name(d)
            w.size_t(n)
    else:
        w.i4(_ZERO)
        w.size_t(0)
    w.att_list(ds.attrs)

    # variable metadata with placeholder offsets, then fix up
    var_entries = []
    for nm, var in converted.items():
        nc_type, data = _nc_type_for(var.data)
        if not cdf5 and nc_type in _CDF5_ONLY:
            nc_type = NC_INT
            data = data.astype("i4")
        if nc_type == NC_CHAR:
            raw = np.frombuffer(data.astype("S1").tobytes(), np.uint8)
        else:
            # one parallel native byteswap pass straight to on-disk bytes
            # (no astype copy, no tobytes copy)
            dt = np.dtype(_TYPEMAP[nc_type]).newbyteorder("=")
            raw = native.encode_be(data.astype(dt, copy=False))
        vsize = len(raw) + _pad4(len(raw))
        var_entries.append((nm, var, nc_type, raw, vsize))

    w.i4(_NC_VARIABLE if var_entries else _ZERO)
    w.size_t(len(var_entries))
    header_chunks = [w.tobytes()]
    # build per-var metadata, computing header size first with dummy offsets
    def var_header(entry, begin):
        nm, var, nc_type, raw, vsize = entry
        vw = _Writer(cdf5)
        vw.name(nm)
        vw.size_t(len(var.dims))
        for d in var.dims:
            vw.size_t(dim_ids[d])
        vw.att_list(var.attrs)
        vw.i4(nc_type)
        vw.size_t(min(vsize, 2**31 - 1) if not cdf5 else vsize)
        vw.i8(begin)  # version >= 2: 8-byte offsets
        return vw.tobytes()

    meta_size = sum(len(var_header(e, 0)) for e in var_entries)
    offset = len(header_chunks[0]) + meta_size
    data_chunks = []
    for entry in var_entries:
        header_chunks.append(var_header(entry, offset))
        raw = entry[3]
        npad = _pad4(len(raw))
        data_chunks.append(raw)
        if npad:
            data_chunks.append(b"\x00" * npad)
        offset += len(raw) + npad

    with open(path, "wb") as fh:
        for chunk in header_chunks:
            fh.write(chunk)
        for chunk in data_chunks:
            # numpy buffers are written zero-copy via the buffer protocol
            fh.write(memoryview(chunk) if isinstance(chunk, np.ndarray)
                     else chunk)
