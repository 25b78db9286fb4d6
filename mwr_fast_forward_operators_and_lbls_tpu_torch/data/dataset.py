"""Lightweight labeled-dataset container (dims / variables / attributes).

The reference pipeline's inter-stage IR is a CF-1.8 NetCDF dataset built with
xarray (reference/python_src/preproc/preprocessing4all.py:1111-1245).
This container keeps that contract — named dimensions, per-variable dims +
attrs, global attrs — without the xarray dependency (not in this image), and
with zero-copy NumPy storage that feeds `jax.device_put` directly.

Serialization lives in data/netcdf.py (own NetCDF-classic codec, readable by
any NetCDF tool) so downstream users of the reference can open our outputs
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Variable:
    dims: tuple
    data: np.ndarray
    attrs: dict = field(default_factory=dict)

    def __post_init__(self):
        self.dims = tuple(self.dims)
        self.data = np.asarray(self.data)
        if len(self.dims) != self.data.ndim:
            raise ValueError(
                f"dims {self.dims} do not match data ndim {self.data.ndim}")


class Dataset:
    """dims: {name: size}; variables: {name: Variable}; attrs: {str: any}."""

    def __init__(self, variables: dict | None = None, attrs: dict | None = None):
        self.variables: dict[str, Variable] = {}
        self.attrs: dict = dict(attrs or {})
        for name, var in (variables or {}).items():
            self[name] = var

    # -- dict-ish interface -------------------------------------------------
    def __setitem__(self, name: str, value):
        if isinstance(value, Variable):
            var = value
        else:
            dims, data, *rest = value
            var = Variable(dims, data, rest[0] if rest else {})
        for d, n in zip(var.dims, var.data.shape):
            if self.dims.get(d, n) != n:
                raise ValueError(
                    f"variable {name!r}: dim {d!r} size {n} conflicts with "
                    f"existing size {self.dims[d]}")
        self.variables[name] = var

    def __getitem__(self, name: str) -> Variable:
        return self.variables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.variables

    def __iter__(self):
        return iter(self.variables)

    def get(self, name, default=None):
        return self.variables.get(name, default)

    @property
    def dims(self) -> dict:
        out: dict[str, int] = {}
        for var in self.variables.values():
            for d, n in zip(var.dims, var.data.shape):
                out.setdefault(d, n)
        return out

    # -- transforms ---------------------------------------------------------
    def isel(self, **indexers) -> "Dataset":
        """Integer/slice selection along named dims (xarray.Dataset.isel)."""
        out = Dataset(attrs=self.attrs)
        for name, var in self.variables.items():
            idx = tuple(
                indexers.get(d, slice(None)) for d in var.dims
            )
            new_dims = tuple(
                d for d, i in zip(var.dims, idx) if not np.isscalar(i)
            )
            out.variables[name] = Variable(new_dims, var.data[idx], dict(var.attrs))
        return out

    def sel_mask(self, dim: str, mask: np.ndarray) -> "Dataset":
        """Boolean selection along one dim (rows where mask is True)."""
        return self.isel(**{dim: np.nonzero(np.asarray(mask))[0]})

    def copy(self) -> "Dataset":
        out = Dataset(attrs=dict(self.attrs))
        for name, var in self.variables.items():
            out.variables[name] = Variable(var.dims, var.data.copy(),
                                           dict(var.attrs))
        return out

    def rename(self, mapping: dict) -> "Dataset":
        out = Dataset(attrs=dict(self.attrs))
        for name, var in self.variables.items():
            out.variables[mapping.get(name, name)] = var
        return out

    def drop(self, *names: str) -> "Dataset":
        out = Dataset(attrs=dict(self.attrs))
        for name, var in self.variables.items():
            if name not in names:
                out.variables[name] = var
        return out

    def __repr__(self):
        lines = [f"<Dataset dims={self.dims}>"]
        for name, var in self.variables.items():
            lines.append(f"  {name}{var.dims} {var.data.dtype}")
        return "\n".join(lines)


def concat(datasets: list, dim: str) -> Dataset:
    """Concatenate along `dim` (xr.concat analogue used at
    preprocessing4all.py:1397); variables lacking `dim` are taken from the
    first dataset."""
    if not datasets:
        raise ValueError("no datasets")
    out = Dataset(attrs=dict(datasets[0].attrs))
    for name, var0 in datasets[0].variables.items():
        if dim in var0.dims:
            axis = var0.dims.index(dim)
            data = np.concatenate(
                [ds[name].data for ds in datasets], axis=axis)
            out.variables[name] = Variable(var0.dims, data, dict(var0.attrs))
        else:
            out.variables[name] = var0
    return out
