"""Data-parallel training of the port over real gloo worlds of 1, 2 and 4
ranks, against JAX's one-device step on the global batch.

The rank bodies are in ``tests/_torch_dist.py``.  The reduced Qwen3
(float32) starts from the reference's weights; rank r takes rows
``r::world`` of each global batch (the data pipeline's host split).
Contracts:
* every step's loss within 1e-6 (relative) and every averaged gradient
  leaf within 1e-5 of its max |g| of JAX's ``value_and_grad`` of the
  reference's ``lm_loss`` on the global batch at the port's parameters
  before that step, for 3 steps at world 2 and 4, microbatches 1 and 2,
  with and without ``compress_grads``; parameters, moments and residual
  equal on every rank;
* the reduced DeepSeek-V2-Lite (MoE with grouped routing, MLA) at world
  2 and 4, microbatches 1 and 2: loss and metrics within 1e-5 (relative)
  and every gradient leaf within 1e-4 of its max |g| (the tolerances
  its one-device gradients meet, ``test_torch_train_grads_kinds``) of
  JAX on the global batch, which is the ranks' rows in rank order,
  microbatch by microbatch: the capacity, the dropped tokens and the
  load balance are the whole batch's, and the batch drops tokens;
* at world 1 the step (its all-reduce included) equals the one-device
  step bit for bit, for every combination;
* the reference's SPMD contract: the loss falls by 0.2 over 8 steps at lr
  5e-3 (world 4);
* a checkpoint saved at world 4 (rank 0 writes) restores at world 2 bit
  for bit on every rank;
* ``launch.train.main(["--mesh", "2x1", ...])`` in a 2-rank world trains,
  checkpoints and resumes, with losses within 1e-5 of a one-process run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import lm_to_arrays
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as launch
from tests import _torch_dist as td
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_training import GRAD_REL as MOE_GRAD_REL
from tests.test_torch_training import LOSS_REL as MOE_LOSS_REL
from tests.test_torch_training import _paths

COMBOS = [(1, False), (1, True), (2, False), (2, True)]
MOE = "deepseek-v2-lite-16b"
MOE_COMBOS = [(1, False), (2, False)]
BATCH, SEQ, STEPS = 8, 16, 3
LOSS_REL, GRAD_REL = 1e-6, 1e-5
LAUNCH = ["--device", "cpu", "--reduced", "--batch", "4", "--seq", "16",
          "--lr", "1e-3", "--ckpt-every", "3", "--log-every", "1"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's weights saved for the ranks (Qwen3 and the MoE
    config), the global batches and a jitted ``value_and_grad`` of the
    reference's loss for each config."""
    d = tmp_path_factory.mktemp("dist_train")
    grads = {}
    for arch, name in (("qwen3-0.6b", "qwen"), (MOE, "moe")):
        jcfg = j_get_config(arch).reduced()
        params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        td.save_tree(d / f"{name}.npz", jax.tree.map(np.asarray, params))
        grads[arch] = jax.jit(jax.value_and_grad(
            lambda p, tok, lab, _c=jcfg: jlm.lm_loss(p, _c, tokens=tok,
                                                     labels=lab),
            has_aux=True))
    src = tpipe.make_source(tpipe.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=BATCH))
    batches = [src.batch(s) for s in range(STEPS)]
    return d, batches, grads


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    d, batches, _ = setup
    ckpt = str(d / "ckpt")
    learn = {"tokens": np.random.default_rng(5).integers(
        0, 512, (8, 32)).astype(np.int32)}
    learn["labels"] = np.random.default_rng(6).integers(
        0, 512, (8, 32)).astype(np.int32)
    out = {}
    for world in (4, 2, 1):          # 4 saves the checkpoint 2 restores
        out[world] = td.run_world(td.train_world, world,
                                  tmp_path_factory.mktemp(f"w{world}"),
                                  str(d / "qwen.npz"), batches, ckpt, learn,
                                  COMBOS, LAUNCH, str(d / "moe.npz"),
                                  MOE_COMBOS)
    return out


def _tree(named: dict, arch="qwen3-0.6b"):
    cfg = get_config(arch).reduced()
    return lm_to_arrays({k: torch.as_tensor(v) for k, v in named.items()},
                        cfg)


def _global_microbatches(batch: dict, world: int, M: int) -> list:
    """The global batch the ranks hold (rank r has rows ``r::world``,
    split into M microbatches): microbatch i is every rank's microbatch
    i, in rank order."""
    local = [{k: v[r::world].reshape(M, -1, *v.shape[1:])
              for k, v in batch.items()} for r in range(world)]
    return [{k: np.concatenate([loc[k][i] for loc in local])
             for k in batch} for i in range(M)]


@pytest.mark.parametrize("M,compress", COMBOS)
@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_reference(setup, worlds, world, M, compress):
    _, batches, grads = setup
    grad = grads["qwen3-0.6b"]
    ranks = [r["dp"][(M, compress)] for r in worlds[world]]
    rec = ranks[0]
    for s, b in enumerate(batches):
        (jloss, _), jgrads = grad(_tree(rec["params"][s]),
                                  jnp.asarray(b["tokens"]),
                                  jnp.asarray(b["labels"]))
        jloss = float(jloss)
        for r in ranks:
            assert abs(r["loss"][s] - jloss) <= LOSS_REL * abs(jloss), s
        got = _paths(_tree(rec["grads"][s]))
        want = _paths(jax.tree.map(np.asarray, jgrads))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            err = float(np.max(np.abs(got[path] - w)))
            assert err <= GRAD_REL * float(np.max(np.abs(w))), (s, path, err)
    assert len({r["digest"] for r in ranks}) == 1     # replicated state


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("world", [2, 4])
def test_moe_dp_step_takes_the_whole_batch(setup, worlds, world, M):
    """The MoE layers' capacity, drops and load balance over the whole
    (micro)batch: each rank's statistics alone would give another loss
    and other gradients."""
    _, batches, grads = setup
    ranks = [r["moe"][(M, False)] for r in worlds[world]]
    rec = ranks[0]
    dropped = []
    for s, b in enumerate(batches):
        params = _tree(rec["params"][s], MOE)
        outs = [grads[MOE](params, jnp.asarray(mb["tokens"]),
                           jnp.asarray(mb["labels"]))
                for mb in _global_microbatches(b, world, M)]
        jloss = float(np.mean([float(l) for (l, _), _ in outs]))
        jmet = {k: float(np.mean([float(m[k]) for (_, m), _ in outs]))
                for k in outs[0][0][1]}
        jgrads = jax.tree.map(lambda *g: np.mean(np.stack(g), axis=0),
                              *[g for _, g in outs])
        for r in ranks:
            np.testing.assert_allclose(r["loss"][s], jloss,
                                       rtol=MOE_LOSS_REL)
        for k, v in jmet.items():
            np.testing.assert_allclose(rec["metrics"][s][k], v,
                                       rtol=MOE_LOSS_REL, atol=1e-7,
                                       err_msg=k)
        dropped.append(jmet["dropped_frac"])
        got = _paths(_tree(rec["grads"][s], MOE))
        want = _paths(jgrads)
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            err = float(np.max(np.abs(got[path] - w)))
            assert err <= MOE_GRAD_REL * float(np.max(np.abs(w))), \
                (s, path, err)
    assert max(dropped) > 0, dropped          # the capacity binds
    assert len({r["digest"] for r in ranks}) == 1


def test_dp_at_world_one_is_the_one_device_step(worlds):
    rec = worlds[1][0]["dp"]
    assert sorted(rec) == sorted(COMBOS)
    for combo, r in rec.items():
        assert r["same"] == [True] * STEPS, combo


def test_dp_learns_as_the_reference_spmd_step(worlds):
    losses = [r["learn"] for r in worlds[4]]
    assert all(l == losses[0] for l in losses)
    assert losses[0][-1] < losses[0][0] - 0.2, losses[0]


def test_checkpoint_from_world_four_restores_at_world_two(setup, worlds):
    d, _, _ = setup
    with np.load(d / "ckpt" / "step_7" / "arrays.npz") as z:
        saved = {k: z[k] for k in z.files}
    assert sorted(p.name for p in (d / "ckpt").iterdir()) == ["step_7"]
    for step, arrays in (r["restore"] for r in worlds[2]):
        assert step == 7
        assert sorted(arrays) == sorted(saved)
        for k, v in saved.items():
            assert arrays[k].dtype == v.dtype
            np.testing.assert_array_equal(arrays[k], v, err_msg=k)


def test_launcher_trains_and_resumes_over_two_ranks(setup, worlds,
                                                    tmp_path):
    d, _, _ = setup
    ckpt = str(tmp_path / "one")
    first = launch.main([*LAUNCH, "--steps", "3", "--ckpt-dir", ckpt])
    second = launch.main([*LAUNCH, "--steps", "6", "--ckpt-dir", ckpt])
    assert len(first) == len(second) == 3
    for r in worlds[2]:
        a, b = r["launch"]
        np.testing.assert_allclose(a, first, rtol=1e-5)
        np.testing.assert_allclose(b, second, rtol=1e-5)
        assert (a, b) == worlds[2][0]["launch"]
    steps = sorted(p.name for p in (d / "ckpt_launch").iterdir())
    assert steps == ["step_3", "step_6"]
