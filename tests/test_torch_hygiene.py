"""The PyTorch port stands alone: no file of ``dmcf_tpu_torch/`` (its
``parallel/`` modules too), not ``chip_smoke.py``, not the port's
diagnostic scripts and not the rank bodies its multi-process tests spawn
(``tests/_torch_ranks.py``) import JAX, flax, optax, orbax, TensorFlow or
the JAX package (an AST scan, so imports inside functions count too).
Nor do they import what the GPU machine lacks: ``zstandard`` nowhere
(scene files go through ``data/zstd.py`` and ``libzstd.so.1``), ``h5py``
nowhere outside ``viz/`` (results go through ``data/hdf5.py``; the
renderer stays a tool for the CPU machine)."""

import ast
import pathlib

import pytest
import torch

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflow",
             "dmcf_tpu")
NOT_INSTALLED = ("zstandard", "h5py")   # h5py allowed in viz/ alone
PORT_FILES = sorted((ROOT / "dmcf_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_klist_phases.py",
    ROOT / "scripts" / "torch_redesign_ab.py",
    ROOT / "scripts" / "torch_redesign_variants.py",
    ROOT / "scripts" / "torch_bwd_flips.py",
    ROOT / "scripts" / "torch_multi_rank.py",
    ROOT / "tests" / "_torch_ranks.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_the_gpu_machine_lacks(path):
    renderer = (ROOT / "dmcf_tpu_torch" / "viz") in path.parents
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in NOT_INSTALLED
           and not (renderer and m.split(".")[0] == "h5py")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
