"""The PyTorch port stands alone: no file of ``dmcf_tpu_torch/``, not
``chip_smoke.py`` and not the port's diagnostic script imports JAX, flax,
optax, orbax or the JAX package (an AST scan, so imports inside functions
count too)."""

import ast
import pathlib

import pytest
import torch

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dmcf_tpu")
PORT_FILES = sorted((ROOT / "dmcf_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_klist_phases.py"]


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
