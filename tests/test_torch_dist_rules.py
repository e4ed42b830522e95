"""The port's sharding rules (``repro_torch.distributed.sharding``) and
meshes (``repro_torch.launch.mesh``) against the reference's.

Every leaf of all ten configs at full width: the port's parameters and
decode caches on the meta device laid out under the reference's paths
(:func:`param_shapes`, :func:`cache_shapes`), the reference's through
``jax.eval_shape``; ``param_specs``, ``zero1_specs``, ``cache_specs``
(both strategies), ``batch_spec`` and ``activation_spec`` equal leaf by
leaf on meshes (16, 16), (2, 16, 16), (1, 1), (2, 2) and (4, 2), faked as
``tests/test_distributed.py`` fakes them.  The reference's divisibility,
tree-cover and ZeRO-1 contracts hold on the port.  A mesh with no process
group refuses.  No process group is made here: the role-wise cut
(``shard_tensor``/``gather_tensor`` with ``parts``) runs in a spawned
gloo world of 4 ranks (``tests/_torch_dist.py::roles_world``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import sharding as jshd
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import (init_distributed, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models import DecoderLM
from tests import _torch_dist as td
from tests._torch_threads import one_torch_thread  # noqa: F401

MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (1, 1)),
          (("data", "model"), (2, 2)),
          (("data", "model"), (4, 2))]
BATCH, MAX_LEN = 32, 512


class FakeMesh:
    """A mesh as the rules read it: ``axis_names`` and ``shape``."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _specs(tree) -> dict:
    """A reference tree of ``PartitionSpec``s as ``{path: tuple}``."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}


@pytest.fixture(scope="module")
def trees():
    """Per arch: (reference params, reference caches, port model, port
    caches), shapes only."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = j_get_config(arch)
            params = jax.eval_shape(lambda k: jlm.init_params(jcfg, k),
                                    jax.random.PRNGKey(0))
            caches = jax.eval_shape(lambda: jlm.init_decode_caches(
                jcfg, BATCH, max_len=MAX_LEN))
            model = DecoderLM(get_config(arch), seed=None, device="meta")
            cache[arch] = (params, caches, model,
                           model.init_decode_caches(BATCH, MAX_LEN))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_zero1_specs_equal_reference(trees, arch):
    params, _, model, _ = trees(arch)
    want_shapes = {k: tuple(v.shape) for k, v in _flat(params).items()}
    got_shapes = shd.param_shapes(model)
    assert got_shapes == want_shapes            # the tree is covered
    for names, sizes in MESHES:
        mesh = FakeMesh(names, sizes)
        assert shd.param_specs(model, mesh) == _specs(
            jshd.param_specs(params, mesh)), (names, sizes)
        assert shd.zero1_specs(model, mesh) == _specs(
            jshd.zero1_specs(params, mesh)), (names, sizes)


@pytest.mark.parametrize("strategy", ["sequence", "feature"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(trees, arch, strategy):
    _, caches, model, port_caches = trees(arch)
    shapes = shd.cache_shapes(model.cfg, port_caches)
    assert shapes == {k: tuple(v.shape) for k, v in _flat(caches).items()}
    for names, sizes in MESHES:
        mesh = FakeMesh(names, sizes)
        assert shd.cache_specs(shapes, mesh, strategy) == _specs(
            jshd.cache_specs(caches, mesh, strategy)), (names, sizes)


@pytest.mark.parametrize("names,sizes", MESHES)
def test_batch_and_activation_specs_equal_reference(names, sizes):
    mesh = FakeMesh(names, sizes)
    for extra in (1, 2):
        for batch in (None, 1, 8, 64, 96):
            assert shd.batch_spec(mesh, extra, batch) == tuple(
                jshd.batch_spec(mesh, extra, batch))
    for seq in (False, True):
        assert shd.activation_spec(mesh, seq_sharded=seq) == tuple(
            jshd.activation_spec(mesh, seq_sharded=seq))
    assert shd.data_size(mesh) == jshd.data_size(mesh)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b",
                                  "hymba-1.5b", "xlstm-1.3b"])
def test_param_specs_divisibility(trees, arch):
    """``tests/test_distributed.py::test_param_specs_divisibility`` on the
    port: no spec shards a dim the 16-way model axis does not divide."""
    _, _, model, _ = trees(arch)
    shapes = shd.param_shapes(model)
    specs = shd.param_specs(model, FakeMesh(("data", "model"), (16, 16)))
    sharded = 0
    for path, spec in specs.items():
        for dim, ax in zip(shapes[path], spec):
            if ax == "model":
                assert dim % 16 == 0, (arch, path, shapes[path], spec)
                sharded += 1
    assert sharded > 0


def test_zero1_adds_data_axis():
    model = DecoderLM(get_config("qwen3-0.6b").reduced(), seed=None,
                      device="meta")
    z = shd.zero1_specs(model, FakeMesh(("data", "model"), (16, 16)))
    assert any("data" in spec for spec in z.values())
    z = shd.zero1_specs(model, FakeMesh(("pod", "data", "model"),
                                        (2, 16, 16)))
    assert any(("pod", "data") in spec for spec in z.values())


def test_meshes_need_a_process_group():
    """Building a mesh is collective: without a process group every maker
    refuses, and touches no device."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    for make in (lambda: make_test_mesh(1, 4), make_production_mesh,
                 lambda: make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="init_distributed"):
            make()
    with pytest.raises(ValueError, match="backend"):
        init_distributed("meta")
    assert not dist.is_initialized()


def test_shard_tensor_on_a_one_rank_mesh_is_the_whole():
    """A mesh of size 1 along every sharded axis keeps the whole tensor
    (no collective is needed to tell)."""
    full = torch.arange(24.0).reshape(4, 6)
    mesh = FakeMesh(("data", "model"), (1, 1))
    mesh.size = lambda axes: 1
    assert torch.equal(shd.shard_tensor(full, ("data", "model"), mesh), full)
    assert np.array_equal(
        shd.gather_tensor(full, ("data", "model"), mesh).numpy(),
        full.numpy())


@pytest.mark.parametrize("M", [2, 4])
def test_tp_plan_replicates_a_moe_layer_that_does_not_divide(M):
    """``shard_lm``'s plan on a reduced deepseek-moe-16b with 6 routed
    experts: at M = 2 the routed experts split on their expert axis and
    the shared experts by columns; at M = 4 the rules already leave the 6
    experts whole, and the port replicates the layer's shared experts
    with them (one expert computed on one rank), listing the shared
    leaves beside the GQA layers' 2 kv heads."""
    import dataclasses

    from repro_torch.distributed.tensor_parallel import _plan

    cfg = get_config("deepseek-moe-16b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           num_experts=6))
    model = DecoderLM(cfg, seed=None, device="meta")
    mesh = FakeMesh(("data", "model"), (1, M))
    mesh.size = lambda axes: M if axes == "model" else 1
    specs, replicated, vocab = _plan(model, mesh)
    moe = [i for i, k in enumerate(cfg.layer_kinds) if k == "moe"]
    assert vocab and moe
    if M == 2:
        assert replicated == []
        for i in moe:
            assert specs[f"blocks.{i}.moe.w_gate"] == ("model", None, None)
            assert specs[f"blocks.{i}.moe.shared.w_gate"] == (None, "model")
            assert specs[f"blocks.{i}.moe.shared.w_down"] == ("model", None)
        return
    want = [f"blocks.{i}.attn.{w}" for i in range(cfg.num_layers)
            for w in ("wk", "wv")]
    want += [f"blocks.{i}.moe.shared.{w}" for i in moe
             for w in ("w_gate", "w_up", "w_down")]
    assert sorted(replicated) == sorted(want)
    for i in moe:
        for w in ("w_gate", "w_up", "w_down", "router", "shared.w_gate",
                  "shared.w_up", "shared.w_down"):
            assert specs[f"blocks.{i}.moe.{w}"] == (), w


@pytest.fixture(scope="module")
def roles(tmp_path_factory):
    """``roles_world`` on 4 ranks: meshes (2, 2) and (1, 4)."""
    return td.run_world(td.roles_world, 4, tmp_path_factory.mktemp("roles"))


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("M", [2, 4])
def test_role_wise_cut_keeps_each_rank_s_channels_of_every_role(roles, M,
                                                                 parts):
    """A leaf of ``parts`` roles side by side ([a | b], [i f z o]) cut over
    a model axis of ``M``: each rank's block holds the same channels of
    every role, in role order (a contiguous cut would give rank 0 the
    first roles whole), and the blocks gather back whole."""
    width = parts * 8
    full = np.arange(3 * width, dtype=np.float32).reshape(3, width)
    c = 8 // M                                   # a role's channels a rank
    seen = set()
    for index, local, round_trip in (r[(M, parts)] for r in roles):
        want = np.concatenate([full[:, j * 8 + index * c:
                                    j * 8 + (index + 1) * c]
                               for j in range(parts)], axis=1)
        np.testing.assert_array_equal(local, want)
        assert round_trip
        seen.add(index)
    assert seen == set(range(M))
