"""The port's sharding rules, activation tags and meshes
(``parallel/sharding.py``, ``parallel/act.py``, ``launch/mesh.py``)
against the live reference (``repro/parallel/{sharding,act}.py``).

Specs are compared leaf by leaf as tuples: the reference's tree comes
from ``jax.eval_shape`` and its specs are placed on a device-free mesh
stand-in (the reference's own ``FakeMesh`` pattern,
``tests/test_sharding.py``); the port's tree is built with fake tensors
(``launch/dryrun_lib.py::abstract_params``). Nothing here allocates a
full-size tree.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.parallel import act as jact
from repro.parallel import sharding as jsharding
from repro_torch import configs
from repro_torch.launch import dryrun_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.parallel import act, sharding
from repro_torch.train.tree import leaves_with_path

ARCHS = configs.ARCH_NAMES


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, whose thread pools would otherwise contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Just enough mesh surface for spec computation (no devices)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@functools.lru_cache(maxsize=None)
def trees(arch: str):
    """(reference abstract params, port fake params) of the full config."""
    jcfg = jconfigs.get_config(arch)
    ref = jax.eval_shape(
        lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))
    return ref, dryrun_lib.abstract_params(configs.get_config(arch))


def ref_flat(specs) -> dict:
    return {jsharding._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, JP))[0]}


def port_flat(tree, specs) -> dict:
    return {path: spec for path, leaf, spec in
            sharding.leaves_with_specs(tree, specs)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    ref, port = trees(arch)
    jm, m = FakeMesh(MESHES[mesh]), mesh_lib.Mesh(MESHES[mesh])
    for fn in ("param_specs", "serving_param_specs"):
        want = ref_flat(getattr(jsharding, fn)(ref, jm))
        got = port_flat(port, getattr(sharding, fn)(port, m))
        assert len(want) == len(jax.tree.leaves(ref))
        assert got == want, fn


def test_fsdp_engages_on_236b_serving():
    ref, port = trees("deepseek-v2-236b")
    m = mesh_lib.make_production_mesh()
    flat = port_flat(port, sharding.serving_param_specs(port, m))
    assert any("data" in s for s in flat.values())        # the fallback
    ref, port = trees("qwen3-8b")
    flat = port_flat(port, sharding.serving_param_specs(port, m))
    assert not any("data" in s for s in flat.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_equal_reference(mesh):
    jm, m = FakeMesh(MESHES[mesh]), mesh_lib.Mesh(MESHES[mesh])
    for b in (256, 128, 1, 3):
        assert sharding.batch_spec(m, b) == tuple(jsharding.batch_spec(jm, b))
    for shape, b in (((128, 32768, 8, 128), 128), ((1, 524288, 8, 128), 1),
                     ((36, 128, 32768, 8, 128), 128), ((7, 5), 7),
                     ((4, 1, 8192), 1)):
        assert sharding.cache_spec(shape, m, b) == tuple(
            jsharding.cache_spec(shape, jm, b))


@pytest.mark.parametrize("mesh", sorted(MESHES) + ["1x1"])
def test_logical_spec_equals_reference(mesh):
    shape = MESHES.get(mesh, {"data": 1, "model": 1})
    names = set(shape)
    m = mesh_lib.Mesh(shape)
    for tags in (("batch", None, "model"), ("batch",), (None, "model"),
                 ("model", "nonexistent", None), ("data", "batch")):
        want = tuple(JP(*(jact._resolve(t, names) for t in tags)))
        assert act.logical_spec(tags, m) == want


def test_constrain_is_the_identity():
    x = torch.ones(2, 3)
    assert act.constrain(x, "batch", "model") is x
    tree = {"a": x, "b": (x, None)}
    assert act.constrain_tree(tree, "batch", None) is tree


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b",
                                  "rwkv6-3b", "zamba2-7b", "whisper-medium"])
def test_state_specs_equal_reference_cache_specs(arch):
    """Every cache leaf of ``init_serve_state`` at the decode_32k shape
    (dense, moe, ssm, hybrid, audio)."""
    batch, max_len = 128, 32768
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    ref = jax.eval_shape(lambda: jt.init_serve_state(jcfg, batch, max_len))
    with dryrun_lib._fake_mode():
        port = tf.init_serve_state(cfg, batch, max_len)
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = [x for _, x in leaves_with_path(port) if x is not None]
    assert [tuple(x.shape) for x in port_leaves] == [
        tuple(x.shape) for x in ref_leaves]
    for mesh in MESHES.values():
        jm, m = FakeMesh(mesh), mesh_lib.Mesh(mesh)
        got = [spec for _, _, spec in sharding.leaves_with_specs(
            port, sharding.state_specs(port, m, batch))]
        want = [tuple(JP()) if x.ndim == 0 else tuple(
            jsharding.cache_spec(x.shape, jm, batch)) for x in ref_leaves]
        assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_local_bytes_sum_to_the_tree_at_one_device(arch):
    _, port = trees(arch)
    m = mesh_lib.make_local_mesh("cpu")
    whole = sum(x.numel() * x.element_size()
                for _, x in leaves_with_path(port))
    assert sharding.local_bytes(port, sharding.param_specs(port, m),
                                m) == whole
    big = mesh_lib.make_production_mesh()
    assert sharding.local_bytes(port, sharding.param_specs(port, big),
                                big) < whole / 16 * 1.01


def test_local_shape():
    m = mesh_lib.Mesh({"pod": 2, "data": 16, "model": 16})
    assert sharding.local_shape((64, 100, 7), ("model", None), m) == (
        4, 100, 7)
    assert sharding.local_shape((1, 524288), (None, ("pod", "data",
                                                     "model")), m) == (1, 1024)
    assert sharding.local_shape((33,), ("model",), m) == (3,)     # padded


def test_meshes():
    m = mesh_lib.make_mesh((2, 3), ("stage", "model"), devices=["cpu"] * 6)
    assert m.axis_names == ("stage", "model") and m.size == 6
    assert m.axis_devices("stage") == [torch.device("cpu")] * 2
    assert m.axis_devices("model") == [torch.device("cpu")] * 3
    p = mesh_lib.make_production_mesh()
    assert p.shape == {"data": 16, "model": 16} and p.devices is None
    assert mesh_lib.dp_axes(p) == ("data",)
    mp = mesh_lib.make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_lib.dp_axes(mp) == ("pod", "data")
    assert mesh_lib.make_production_mesh(pods=4).shape["pod"] == 4
    local = mesh_lib.make_local_mesh("cpu")
    assert local.shape == {"data": 1, "model": 1}
    data = mesh_lib.make_data_mesh(3, ["cpu"] * 4)
    assert data.shape == {"data": 3, "model": 1} and len(data.devices) == 3
    with pytest.raises(ValueError):
        mesh_lib.make_data_mesh(5, ["cpu"] * 4)
    with pytest.raises(ValueError):
        p.axis_devices("data")                     # abstract


def test_executable_mesh_needs_a_gpu_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        mesh_lib.make_mesh((1,), ("stage",))
    with pytest.raises(RuntimeError):
        mesh_lib.make_local_mesh()
