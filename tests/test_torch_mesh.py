"""The single-controller mesh of the PyTorch port
(deepspeed_tpu_torch.parallel.mesh) against `jax.sharding.Mesh` +
`shard_map` collectives on the simulated CPU devices: the same per-rank
data through `lax.ppermute` / `all_gather` / `all_to_all` / `psum_scatter`
and through the port's list-of-ranks versions, bitwise (these only move
and add)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu_torch.models import ranked_from_stacked
from deepspeed_tpu_torch.parallel import mesh as pmesh

from .test_torch_low_bandwidth import f32, jax_mesh, port_mesh, sm, stacked

AXES = ("data", "expert")


def test_axis_names_match_the_jax_package():
    for name in ("MESH_AXES", "PIPE_AXIS", "DATA_AXIS", "EXPERT_AXIS",
                 "SEQ_AXIS", "MODEL_AXIS", "ZERO_AXES"):
        assert getattr(pmesh, name) == getattr(jmesh, name)


@pytest.mark.parametrize("n,spec", [
    (8, dict(data=-1)), (8, dict(data=-1, expert=2)),
    (8, dict(pipe=2, data=2, model=-1))])
def test_resolve_mesh_shape_matches(n, spec):
    assert pmesh.resolve_mesh_shape(n, **spec).as_tuple() == \
        jmesh.resolve_mesh_shape(n, **spec).as_tuple()


def test_resolve_mesh_shape_refusals_and_shared_devices():
    with pytest.raises(ValueError, match="Only one mesh axis may be -1"):
        pmesh.resolve_mesh_shape(8, data=-1, model=-1)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.resolve_mesh_shape(8, data=-1, expert=3)
    # a world the devices cannot hold is not an error: ranks share a device
    mesh = pmesh.MeshContext.create(data=4, expert=2, devices=["cpu"])
    assert mesh.world_size == 8
    assert all(mesh.device_of(r) == torch.device("cpu") for r in range(8))


def test_default_devices_never_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="does not fall back to the CPU"):
        pmesh.MeshContext.create(data=4)
    with pytest.raises(RuntimeError, match="does not fall back to the CPU"):
        pmesh.initialize_mesh(data=4)


def test_registry():
    pmesh.reset_mesh_context()
    assert pmesh.get_mesh_context(required=False) is None
    with pytest.raises(RuntimeError, match="Mesh is not initialized"):
        pmesh.get_mesh_context()
    ctx = pmesh.initialize_mesh(data=2, devices=["cpu"])
    assert pmesh.get_mesh_context() is ctx and ctx.world_size == 2
    pmesh.reset_mesh_context()
    assert pmesh.get_mesh_context(required=False) is None


def test_layout_is_row_major_over_the_axes():
    mesh = port_mesh(data=4, expert=2)
    assert [mesh.axis_index(r, "data") for r in range(8)] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    assert [mesh.axis_index(r, "expert") for r in range(8)] == [0, 1] * 4
    assert mesh.group(5, "data") == [1, 3, 5, 7]
    assert mesh.group(5, "expert") == [4, 5]
    assert mesh.group(5, AXES) == list(range(8))
    assert mesh.group(5, ("expert", "data")) == [0, 2, 4, 6, 1, 3, 5, 7]
    assert mesh.group_index(5, AXES) == 5
    assert mesh.group_index(5, ("expert", "data")) == 6
    assert mesh.peer(5, "data", -1) == 7 and mesh.peer(5, "data", 4) == 1


@pytest.mark.parametrize("axis,shift", [("data", -1), ("data", 2),
                                        ("expert", 1)])
def test_permute_matches_ppermute(axis, shift):
    x = np.random.RandomState(0).randn(8, 3, 5).astype(np.float32)
    size = 4 if axis == "data" else 2
    perm = [(i, (i + shift) % size) for i in range(size)]
    ref = sm(lambda a: lax.ppermute(a, axis, perm), jax_mesh((4, 2), AXES),
             P(AXES), P(AXES))(jnp.asarray(x))
    mesh = port_mesh(data=4, expert=2)
    with mesh.forked():
        out = mesh.permute(ranked_from_stacked(x, mesh), axis, perm)
    assert (stacked(out) == f32(ref)).all()


def test_permute_partial_gives_zeros():
    x = np.random.RandomState(1).randn(4, 2, 3).astype(np.float32)
    perm = [(0, 1), (1, 2)]
    ref = sm(lambda a: lax.ppermute(a, "data", perm), jax_mesh(), P("data"),
             P("data"))(jnp.asarray(x))
    mesh = port_mesh(data=4)
    out = mesh.permute(ranked_from_stacked(x, mesh), "data", perm)
    assert (stacked(out) == f32(ref)).all()
    assert (out[0] == 0).all() and (out[3] == 0).all()


@pytest.mark.parametrize("axes", [("data",), ("expert",), AXES,
                                  ("expert", "data")])
def test_all_gather_and_psum_scatter_match(axes):
    x = np.random.RandomState(2).randint(-8, 8, size=(8, 8, 3)).astype(
        np.float32)  # small integers: any order of the sum is exact
    jm = jax_mesh((4, 2), AXES)
    gathered = sm(lambda a: lax.all_gather(a[0], axes, axis=0,
                                           tiled=True)[None],
                  jm, P(AXES), P(AXES))(jnp.asarray(x))
    scattered = sm(lambda a: lax.psum_scatter(a[0], axes,
                                              scatter_dimension=0,
                                              tiled=True)[None],
                   jm, P(AXES), P(AXES))(jnp.asarray(x))
    mesh = port_mesh(data=4, expert=2)
    xs = ranked_from_stacked(x, mesh)
    assert (stacked(mesh.all_gather(xs, axes, 0)) == f32(gathered)).all()
    assert (stacked(mesh.psum_scatter(xs, axes, 0)) == f32(scattered)).all()


def test_all_to_all_matches():
    x = np.random.RandomState(3).randn(4, 4, 2, 3).astype(np.float32)
    ref = sm(lambda a: lax.all_to_all(a[0], "data", split_axis=0,
                                      concat_axis=0)[None],
             jax_mesh(), P("data"), P("data"))(jnp.asarray(x))
    mesh = port_mesh(data=4)
    out = mesh.all_to_all(ranked_from_stacked(x, mesh), "data")
    assert (stacked(out) == f32(ref)).all()


def test_ranked_values_are_checked():
    mesh = port_mesh(data=4)
    with pytest.raises(ValueError, match="one value per rank"):
        mesh.permute([torch.zeros(1)] * 3, "data", [(0, 1)])
    with pytest.raises(ValueError, match="must be divisible"):
        mesh.psum_scatter([torch.zeros(6, 2)] * 4, "data", 0)
    with pytest.raises(ValueError, match="all 'cuda' or all 'cpu'"):
        pmesh.MeshContext.create(data=2, devices=["cpu", "cuda:0"])
