"""The port's mesh (``parallel/mesh.py``) vs the JAX package's, on the CPU.

A four-rank gloo world builds the port's meshes (``make_mesh`` over the
world's ranks, the multi-host (dcn_data, data, model) mesh) and cuts a
batch with ``shard_batch``; the JAX package does the same on four of its
eight virtual CPU devices. Shapes, the error messages, each rank's block
of the (padded) batch and the multi-host layout must agree; the port's one
difference, a mesh that leaves ranks out, raises.
"""

import jax
import numpy as np
import pytest

from audax.core.config import MeshConfig as JaxMeshConfig
from audax.parallel import mesh as JM
from audax_torch.core.config import MeshConfig
from audax_torch.parallel import mesh as M

from .mesh_world import run_world

BATCH = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)   # 5 rows: padded


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(4, "tests.torch_port.mesh_cases:mesh_layout",
                     dict(batch=BATCH), tmp_path_factory.mktemp("mesh"))


def _jerr(cfg):
    with pytest.raises(ValueError) as e:
        JM.make_mesh(cfg, devices=jax.devices()[:4])
    return str(e.value)


def test_mesh_shapes_match_jax(world):
    devs = jax.devices()[:4]
    for name, cfg in (("default", JaxMeshConfig()),
                      ("model2", JaxMeshConfig(model=2)),
                      ("data2", JaxMeshConfig(data=2, model=2))):
        jm = JM.make_mesh(cfg, devices=devs)
        for r, out in enumerate(world):
            names, shape, d, m = out["shapes"][name]
            assert names == tuple(jm.axis_names)
            assert shape == tuple(jm.devices.shape)
            # rank r sits where JAX puts device r
            pos = np.argwhere(jm.devices == devs[r])[0]
            assert (d, m) == tuple(int(p) for p in pos)


def test_mesh_errors_match_jax(world):
    errs = world[0]["errors"]
    assert errs["model3"] == _jerr(JaxMeshConfig(model=3))
    assert errs["too_big"] == _jerr(JaxMeshConfig(data=4, model=2))
    # JAX lays a smaller mesh over the first devices; the port runs one
    # process per rank and refuses to leave ranks idle
    assert "covers 2 of the world's 4 ranks" in errs["subset"]


def test_shard_batch_pads_like_jax(world):
    """B=5 over data 2: padded to 6 by repeating row 0, unmasked; rank r
    holds JAX's shard of the device it stands for."""
    devs = jax.devices()[:4]
    jm = JM.make_mesh(JaxMeshConfig(model=2), devices=devs)
    arr = JM.shard_batch(jm, {"x": BATCH})["x"]
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r, out in enumerate(world):
        np.testing.assert_array_equal(out["block"], shards[devs[r]])


def test_multihost_mesh_matches_jax(world):
    devs = jax.devices()[:4]
    jm = JM.make_multihost_mesh(JaxMeshConfig(model=2), devices=devs,
                                num_hosts=2)
    sharding = jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(("dcn_data", "data"), None))
    arr = jax.device_put(np.concatenate([BATCH[:4], BATCH[:4]]), sharding)
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r, out in enumerate(world):
        names, shape, n, br = out["multihost"]
        assert names == tuple(jm.axis_names)
        assert shape == tuple(jm.devices.shape)
        assert n == 2
        # the port pads B=5 to 6 over the two batch blocks
        assert out["mh_block"].shape == (3, 3)
        assert br == int(np.argwhere(jm.devices == devs[r])[0][0])
    assert len(shards) == 4


def test_multihost_grid_on_fake_lists():
    fake = [f"h{h}d{d}" for h in range(4) for d in range(8)]
    ours = M.multihost_device_grid(fake, num_hosts=4, model=2)
    np.testing.assert_array_equal(
        ours, JM.multihost_device_grid(fake, num_hosts=4, model=2))
    for bad in (dict(num_hosts=4, model=4), dict(num_hosts=3, model=1)):
        with pytest.raises(ValueError) as ours_e:
            M.multihost_device_grid(list(range(8)), **bad)
        with pytest.raises(ValueError) as theirs_e:
            JM.multihost_device_grid(list(range(8)), **bad)
        assert str(ours_e.value) == str(theirs_e.value)


def test_single_process_helpers(world, monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert M.init_distributed() == 1
    assert all(out["init_noop"] for out in world)
    for n, m in ((5, 2), (8, 4), (1, 3)):
        assert M.pad_to_multiple(n, m) == JM.pad_to_multiple(n, m)
    assert MeshConfig() == MeshConfig(**dict(JaxMeshConfig().__dict__))
    assert tuple(M.data_sharding(None, 3)) == tuple(
        JM.P("data", None, None))
    assert tuple(M.replicated(None)) == ()


def test_named_mesh_and_ring_shift_in_a_world_of_one(mesh_of_one):
    """``make_named_mesh`` lays out any of JAX's SP/PP axis names (one
    size may be -1), refuses what cannot cover the world, and keeps
    'seq'/'stage' out of the batch axes; ``ring_shift`` in a group of one
    is the identity on a ring and zeros on a chain (JAX's ``ppermute``
    over [(0, 0)] and [])."""
    import torch

    from audax_torch.parallel.comm import ring_shift
    from audax_torch.parallel.mesh import (axis_group, axis_size, batch_axes,
                                           make_named_mesh)

    m = make_named_mesh([("data", -1), ("model", 1), ("seq", 1)],
                        device="cpu")
    assert m.mesh_dim_names == ("data", "model", "seq")
    assert batch_axes(m) == ("data",)
    pp = make_named_mesh([("stage", 1), ("data", 1)], device="cpu")
    assert batch_axes(pp) == ("data",) and axis_size(pp, "stage") == 1
    for axes, msg in ((([("seq", 2)]), "needs 2 devices, only 1"),
                      ([("data", 1), ("data", 1)], "repeat"),
                      ([("data", -1), ("seq", -1)], "one of them")):
        with pytest.raises(ValueError, match=msg):
            make_named_mesh(axes, device="cpu")
    x = torch.arange(6.0, requires_grad=True)
    g = axis_group(m, "seq")
    y = ring_shift(x, g, wrap=True)
    assert torch.equal(y, x.detach())
    assert torch.equal(ring_shift(x, g, wrap=False), torch.zeros(6))
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(6))
