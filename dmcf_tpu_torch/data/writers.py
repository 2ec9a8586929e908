"""Result writers (the port's copy of dmcf_tpu/data/writers.py)."""

from __future__ import annotations

import os


def write_results(path, name, data):
    """Write rollout arrays to hdf5: one group per model, one dataset per
    series (pred/gt/bnd) with type/dim attributes.  ``h5py`` is imported
    here, where a file is written."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        grp = f.create_group(name)
        for d, props in data:
            dset = grp.create_dataset(props["name"], data=d)
            dset.attrs["type"] = props.get("type", "DENSITY")
            dset.attrs["dim"] = d.shape
