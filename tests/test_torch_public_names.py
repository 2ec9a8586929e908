"""The port's public names: every name a ``dmcf_tpu`` subpackage exports
(its ``__all__``, read by AST, so no JAX module is imported for it)
resolves in the port's subpackage of the same name, but for
``utils.enable_compilation_cache`` (JAX's persistent compilation cache,
not ported on purpose); ``reduce_neighbor_count`` equals JAX's exactly
on a seeded search, and ``code2md`` JAX's text."""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.ops import cconv as jcconv
from dmcf_tpu.ops import neighbors as jneighbors
from dmcf_tpu.utils import log as jlog
from dmcf_tpu_torch.ops import fixed_radius_search, reduce_neighbor_count
from dmcf_tpu_torch.utils.log import code2md

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXEMPT = {("utils", "enable_compilation_cache")}
INITS = sorted((ROOT / "dmcf_tpu").glob("*/__init__.py"))


def exported(path):
    """The names of a module's ``__all__`` ([] where it has none)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


@pytest.mark.parametrize("init", INITS, ids=[p.parent.name for p in INITS])
def test_jax_subpackage_names_resolve_in_the_port(init):
    sub = init.parent.name
    names = [n for n in exported(init) if (sub, n) not in EXEMPT]
    if not names:
        return
    port = importlib.import_module(f"dmcf_tpu_torch.{sub}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"dmcf_tpu_torch.{sub} lacks {missing}"


def test_ops_farthest_point_sample_is_the_kernel_wrapper():
    from dmcf_tpu_torch import ops
    from dmcf_tpu_torch.kernels import fps
    assert ops.farthest_point_sample is fps.farthest_point_sample


@pytest.mark.parametrize("num_out", [None, 50])
def test_reduce_neighbor_count_matches_jax(num_out):
    rng = np.random.RandomState(3)
    pts = rng.uniform(0.0, 1.0, (120, 3)).astype(np.float32)
    qry = rng.uniform(0.0, 1.0, (80, 3)).astype(np.float32)
    pmask = rng.uniform(size=120) > 0.2
    # JAX's search compiled whole (eager, each op compiles on its own)
    want = jcconv.reduce_neighbor_count(jax.jit(
        lambda p, q, m: jneighbors.fixed_radius_search(
            p, q, 0.2, 16, points_mask=m))(
        jnp.asarray(pts), jnp.asarray(qry), jnp.asarray(pmask)), num_out)
    got = reduce_neighbor_count(fixed_radius_search(
        torch.from_numpy(pts), torch.from_numpy(qry), 0.2, 16,
        points_mask=torch.from_numpy(pmask)), num_out)
    assert got.dtype == torch.float32
    assert got.shape == (num_out or 80,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.max()) <= 16


@pytest.mark.parametrize("language", [None, "python"])
def test_code2md_matches_jax(language):
    code = "def f(x):\n    return x + 1"
    assert code2md(code, language) == jlog.code2md(code, language)
