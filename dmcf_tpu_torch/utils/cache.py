"""Filesystem cache helpers (the port's copy of dmcf_tpu/utils/cache.py)."""

from __future__ import annotations

import hashlib
import os

import numpy as np

from .log import make_dir


def get_hash(x: str) -> str:
    return hashlib.sha1(x.encode()).hexdigest()


class Cache:
    """npy-file cache for preprocessed samples keyed by name."""

    def __init__(self, func, cache_dir, cache_key):
        self.func = func
        self.cache_dir = os.path.join(cache_dir, cache_key)
        make_dir(self.cache_dir)
        self.cached_ids = [
            f[:-4] for f in os.listdir(self.cache_dir) if f.endswith(".npy")
        ]

    def __call__(self, unique_id, *data):
        fpath = os.path.join(self.cache_dir, f"{unique_id}.npy")
        if not os.path.exists(fpath):
            output = self.func(*data)
            np.save(fpath, output, allow_pickle=True)
            self.cached_ids.append(unique_id)
            return output
        return np.load(fpath, allow_pickle=True).item()
