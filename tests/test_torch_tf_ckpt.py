"""Reference TensorFlow checkpoints in the port, without TensorFlow
(``utils/tf_bundle.py``, ``utils/tf_ckpt.py``, ``run_sample --tf_ckpt``),
held against TensorFlow's own reader and the JAX package's loader.

* The bundle reader gives ``tf.train.load_checkpoint``'s bits, dtype and
  shape for every key, on the committed fixture
  (``tests/data/tf_ckpt_liquid3d``: ``configs/Liquid3d.yml``'s SymNet at
  full width in the reference's variable layout, the JAX package's
  ``PRNGKey(0)`` init, written by ``scripts/make_tf_reference_fixture.py``)
  and on a bundle TensorFlow writes here with every mapped dtype and
  enough variables for several index blocks; a flipped byte raises.
* The port's ``load_tf_reference_checkpoint`` equals the JAX package's
  (through ``interop.params_from_flax``) bit for bit on the fixture and
  on a narrow 2D SymNet with the pre-advection branch; its strict errors
  are the JAX package's, message for message.
* ``run_sample --tf_ckpt`` loads the fixture and rolls out what
  ``run_sample.run_sample`` does with those weights; one step with them
  on an isolated blob conserves momentum as
  ``tests/test_tf_ckpt.py::test_converted_step_is_finite_and_conserving``
  requires of the reference's weights (residual within 1e-4 of the
  summed |velocity|).

TensorFlow is imported by this file only among the port's tests.
"""

import json
import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu.utils.tf_ckpt import load_tf_reference_checkpoint as jax_load
from dmcf_tpu_torch import run_sample
from dmcf_tpu_torch.data import read_msgpack_zst, write_msgpack_zst
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.scene import bench_sample
from dmcf_tpu_torch.utils import tf_bundle
from dmcf_tpu_torch.utils.tf_ckpt import load_tf_reference_checkpoint
from scripts.make_tf_reference_fixture import write_reference_checkpoint
from test_tf_ckpt import _sample
from test_torch_options import BASE, make_sample

tf = pytest.importorskip("tensorflow")

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(ROOT, "tests", "data", "tf_ckpt_liquid3d", "ckpt")
FIXTURES = os.path.join(ROOT, "tests", "data", "fixtures.json")
CONFIG = os.path.join(ROOT, "configs", "Liquid3d.yml")

# a narrow 2D SymNet with the pre-advection branch (adv_convs, adv_dense)
PRE_ADV = dict(BASE, name="SymNet", sym_kernel_size=[1, 4, 4], sym_axis=1,
               layer_channels=[[[8]], [[8], [4]], [[8]], [[3]]],
               use_pre_adv=True)


def liquid3d_cfg():
    with open(CONFIG) as f:
        return yaml.safe_load(f)["model"]


def jax_template(jmodel, sample):
    """The flax param tree of zeros from ``eval_shape`` (no compile), as
    root ``run_sample.py`` builds it."""
    js = {k: jnp.asarray(v) for k, v in sample.items()}
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), js, training=False))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def seeded(tree, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: rng.uniform(-0.3, 0.3, a.shape).astype(
        np.float32), tree)


@pytest.fixture(scope="module")
def multi_block(tmp_path_factory):
    """A bundle TensorFlow writes with each mapped dtype, a scalar and
    2,500 variables of 200-character names (a LevelDB index of three data
    blocks)."""
    rng = np.random.RandomState(0)
    m = tf.Module()
    m.f32 = tf.Variable(rng.randn(7, 3).astype(np.float32))
    m.f64 = tf.Variable(rng.randn(5).astype(np.float64))
    m.i32 = tf.Variable(rng.randint(-9, 9, (4, 2)).astype(np.int32))
    m.i64 = tf.Variable(rng.randint(-2 ** 40, 2 ** 40, (3,)))
    m.scalar = tf.Variable(np.float32(-2.5))
    m.f16 = tf.Variable(rng.randn(3).astype(np.float16))
    m.bf16 = tf.Variable(tf.constant([1.5, -2.0, 3.25], tf.bfloat16))
    m.flags = tf.Variable([True, False, True])
    m.empty = tf.Variable(np.zeros((0, 4), np.float32))
    for i in range(2500):
        setattr(m, f"v{i:05d}_" + "w" * 200, tf.Variable(np.float32(i)))
    prefix = str(tmp_path_factory.mktemp("bundle") / "ckpt")
    return tf.train.Checkpoint(model=m, step=tf.Variable(3)).write(prefix)


def index_blocks(prefix):
    """The data blocks of a bundle's index table."""
    path = prefix + ".index"
    with open(path, "rb") as f:
        data = f.read()
    footer = data[-tf_bundle.FOOTER_BYTES:]
    _, pos = tf_bundle._block_handle(footer)
    handle, _ = tf_bundle._block_handle(footer, pos)
    return len(list(tf_bundle._block_entries(
        tf_bundle._read_block(data, handle, path), path)))


@pytest.mark.parametrize("which", ["fixture", "multi_block"])
def test_bundle_reader_gives_tf_bits(which, request):
    prefix = FIXTURE if which == "fixture" else \
        request.getfixturevalue("multi_block")
    rd = tf.train.load_checkpoint(prefix)
    dtypes = rd.get_variable_to_dtype_map()
    ours = tf_bundle.load_checkpoint(prefix)
    shapes = ours.get_variable_to_shape_map()
    assert set(shapes) == {k for k in dtypes if dtypes[k] != tf.string}
    assert rd.get_variable_to_shape_map().keys() - shapes.keys() == {
        "_CHECKPOINTABLE_OBJECT_GRAPH"}
    for key, shape in shapes.items():
        want, got = np.asarray(rd.get_tensor(key)), ours.get_tensor(key)
        assert got.dtype == want.dtype, key
        assert got.shape == want.shape == tuple(shape), key
        assert got.tobytes() == want.tobytes(), key
    if which == "multi_block":
        assert index_blocks(prefix) >= 3
        assert {str(ours.get_tensor(k).dtype) for k in shapes} >= {
            "float32", "float64", "int32", "int64", "float16", "bfloat16",
            "bool"}
    else:
        with open(FIXTURES) as f:
            want = json.load(f)["tf_ckpt_liquid3d"]
        assert len(shapes) == want["tensors"]
        assert math.fsum(math.fsum(np.abs(ours.get_tensor(k).astype(
            np.float64)).ravel()) for k in shapes) == want["abs_sum"]


@pytest.mark.parametrize("where", ["data", "index"])
def test_bundle_reader_raises_on_a_flipped_byte(where, tmp_path):
    for name in os.listdir(os.path.dirname(FIXTURE)):
        shutil.copy(os.path.join(os.path.dirname(FIXTURE), name), tmp_path)
    prefix = str(tmp_path / "ckpt")
    key = "model/fluid_convs/kernel/.ATTRIBUTES/VARIABLE_VALUE"
    if where == "data":
        path = prefix + ".data-00000-of-00001"
        offset = tf_bundle.BundleReader(prefix)._entries[key]["offset"] + 17
    else:
        path, offset = prefix + ".index", 40
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x10]))
    with pytest.raises(ValueError, match="CRC32C"):
        tf_bundle.load_checkpoint(prefix).get_tensor(key)


def test_port_loader_equals_jax_loader_on_the_fixture():
    cfg = liquid3d_cfg()
    jmodel = jax_build_model(cfg)
    want = params_from_flax(jax_load(
        FIXTURE, jax_template(jmodel, _sample()), jmodel.layer_channels,
        use_pre_adv=jmodel.use_pre_adv, strict=True))
    model = build_model(cfg, device="cpu")
    got = load_tf_reference_checkpoint(FIXTURE, model, strict=True)
    assert list(got) == list(model.state_dict())
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    model.load_state_dict(got, strict=True)


def pre_adv_models():
    jmodel = jax_build_model(PRE_ADV)
    params = seeded(jax_template(jmodel, make_sample()))
    return jmodel, params, build_model(PRE_ADV, device="cpu")


def test_port_loader_equals_jax_loader_with_pre_advection(tmp_path):
    jmodel, params, model = pre_adv_models()
    assert {"adv_conv0", "adv_dense0"} <= set(params["params"])
    prefix = write_reference_checkpoint(
        str(tmp_path / "ckpt"), params, jmodel.layer_channels, True)
    keys = tf_bundle.load_checkpoint(prefix).get_variable_to_shape_map()
    assert any(k.startswith("model/adv_convs/0/") for k in keys)
    assert any(k.startswith("model/adv_dense/0/") for k in keys)
    want = params_from_flax(jax_load(
        prefix, jax.tree.map(np.zeros_like, params), jmodel.layer_channels,
        use_pre_adv=True, strict=True))
    got = load_tf_reference_checkpoint(prefix, model, strict=True)
    assert set(got) == set(want) == set(params_from_flax(params))
    for k in got:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], params_from_flax(params)[k]), k


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_strict_errors_match_jax(fault, tmp_path):
    jmodel, params, model = pre_adv_models()
    bad = jax.tree.map(lambda a: a, params)
    if fault == "missing":
        del bad["params"]["obs_dense"]
    elif fault == "extra":
        bad["params"]["fluid_dense"]["Dense_0"]["extra"] = np.zeros(
            2, np.float32)
    else:
        k = bad["params"]["fluid_dense"]["Dense_0"]["kernel"]
        bad["params"]["fluid_dense"]["Dense_0"]["kernel"] = k.T.copy()
    prefix = write_reference_checkpoint(
        str(tmp_path / "ckpt"), bad, jmodel.layer_channels, True)
    with pytest.raises(ValueError) as jerr:
        jax_load(prefix, jax.tree.map(np.zeros_like, params),
                 jmodel.layer_channels, use_pre_adv=True, strict=True)
    with pytest.raises(ValueError) as perr:
        load_tf_reference_checkpoint(prefix, model, strict=True)
    assert str(perr.value) == str(jerr.value)
    assert {"missing": "unconverted", "extra": "unconsumed",
            "shape": "shape"}[fault] in str(perr.value)


def small_block(path):
    """A 4 x 3 x 4 block at spacing 0.05 in its open box
    (``chip_smoke.liquid_scene``) as a one-frame scene file."""
    sys.path.insert(0, ROOT)
    from chip_smoke import liquid_scene

    pos, box, nrm = liquid_scene((4, 3, 4))
    write_msgpack_zst(path, [{"pos": pos, "vel": np.zeros_like(pos),
                              "box": box, "box_normals": nrm,
                              "frame_id": 0, "scene_id": "block"}])


def test_run_sample_tf_ckpt(tmp_path, capsys):
    import h5py

    scene = str(tmp_path / "block.msgpack.zst")
    small_block(scene)
    assert run_sample.main([
        "-c", CONFIG, "--tf_ckpt", FIXTURE, "--device", "cpu",
        "--data_path", scene, "--timesteps", "3", "--vel", "0", "0", "0",
        "--output_dir", str(tmp_path / "out")]) == 0
    assert f"Converted reference TF checkpoint {FIXTURE}" in \
        capsys.readouterr().out
    with h5py.File(tmp_path / "out" / "example" / "0000" / "0000.hdf5",
                   "r") as f:
        got = np.asarray(f["SymNet"]["pred"])
    model = build_model(liquid3d_cfg(), device="cpu")
    model.load_state_dict(load_tf_reference_checkpoint(FIXTURE, model))
    want, _ = run_sample.run_sample(model, read_msgpack_zst(scene)[0], 3,
                                    vel=[0.0, 0.0, 0.0], device="cpu",
                                    log=lambda m: None)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want[2], want[0])


def test_loaded_step_is_finite_and_conserving():
    model = build_model(liquid3d_cfg(), device="cpu")
    model.load_state_dict(load_tf_reference_checkpoint(FIXTURE, model),
                          strict=True)
    # test_tf_ckpt.py's isolated fluid blob, the boundary far away
    pos = np.random.RandomState(1).uniform(-0.2, 0.2, (128, 3)).astype(
        np.float32)
    box = np.full((2, 3), 100.0, np.float32)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (2, 1))
    sample = bench_sample(pos, box, nrm, device="cpu")
    with torch.no_grad():
        p1, v1, aux = model(sample)
    fm = sample["fluid_mask"]
    assert bool(torch.isfinite(p1[fm]).all() and torch.isfinite(v1[fm]).all())
    assert float(aux["pos_correction"][fm].abs().max()) > 0.0
    dv = v1[fm] - (sample["vel"][fm] + model.timestep * torch.tensor(
        [0.0, model.grav, 0.0]))
    residual = dv.sum(0).abs().max()
    scale = v1[fm].abs().sum()
    assert float(residual) < 1e-4 * max(float(scale), 1.0)
