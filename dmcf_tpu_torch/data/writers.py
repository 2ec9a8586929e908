"""Result writers (the port's copy of dmcf_tpu/data/writers.py): the
hdf5 file written by ``data/hdf5.py``, without ``h5py``."""

from __future__ import annotations

from .hdf5 import read_results, write_results

__all__ = ["read_results", "write_results"]
