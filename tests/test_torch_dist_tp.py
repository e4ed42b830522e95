"""Tensor parallelism of the port over the model axis, over real gloo
worlds of 2 and 4 ranks, against the reference's and the port's
one-device models.

The reduced qwen3-0.6b (dense, tied head), gemma3-4b (local and global
layers, 6 layers, window 16) and glm4-9b (untied head) start from the
reference's weights (``jlm.init_params``, carried by
``repro_torch.convert.lm_from_arrays``), in float32.  The ranks
(``tests/_torch_dist.py::tp_world``) cut them over meshes (1, 2) (world
2), (2, 2) and (1, 4) (world 4) with ``shard_lm``.  At M = 4 the kv heads
(2 in every reduced config) do not divide, so ``wk`` and ``wv`` are
replicated; the test lists those leaves.

Contracts, against JAX's one-device ``lm`` and the port's one-device
``DecoderLM`` on the same weights:
* the prefill logits within 1e-5 of max |logits|;
* the loss within 1e-6 (relative), every gradient leaf within 1e-4 of its
  max |g|;
* 8 decode steps from empty caches: argmax equal, |Δ| within 1e-5 of max
  |logits|;
* ``gather_lm`` returns the weights the ranks were cut from, bit for bit.
Training at (2, 2): 5 steps with ZeRO-1, without and with int8
compression, on the ranks' rows of a global batch of 8, against the
port's one-device steps on that batch: each loss within 1e-5 (relative);
without compression every parameter within 1e-3 of the largest update its
leaf took in the 5 steps; with it, where the partial sums' last bits move
an element across an int8 rounding boundary and Adam turns one quantum
into a step of ~lr, within 0.25 of that update, and at most 10% of a
leaf's elements past 1e-3 of it.  The loss falls by 0.2
over 8 steps at lr 5e-3 (the contract of the reference's
``test_spmd_train_step_runs``).  ZeRO-1 moments over a (2, 1) mesh equal
whole moments bit for bit, parameters included.  The checkpoint written at
(2, 2) restores at (1, 2) and at world 1 bit for bit.  ``launch.train
--mesh 1x2`` and ``2x2`` train and resume, losses within 1e-5 of a
one-process run.  The MoE, MLA, hybrid, xLSTM and cross configs at M = 2
raise ``NotImplementedError`` naming the next slice, and flash decoding
on the model axis of a sharded model raises ``ValueError``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import (lm_from_arrays, lm_to_arrays,
                                 train_state_to_arrays)
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as launch
from repro_torch.models.lm import lm_loss
from repro_torch.training.train_step import (TrainConfig, make_train_step,
                                             train_state_init)
from tests import _torch_dist as td
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_training import _paths

ARCHS = td.TP_ARCHS
SHAPES = [(1, 2), (2, 2), (1, 4)]
B, S, DECODE, MAX_LEN = 4, 16, 8, 32
LOGIT_REL, LOSS_REL, GRAD_REL = 1e-5, 1e-6, 1e-4
TRAIN_LOSS_REL = 1e-5
TRAIN_STEP_REL = 1e-3       # of the largest update a leaf took
INT8_STEP_REL, INT8_FLIPS = 0.25, 0.1
STEPS, BATCH = 5, 8
LAUNCH = ["--device", "cpu", "--reduced", "--batch", "4", "--seq", "16",
          "--lr", "1e-3", "--ckpt-every", "3", "--log-every", "1"]
REFUSED = ("deepseek-moe-16b", "xlstm-1.3b", "hymba-1.5b",
           "deepseek-v2-lite-16b", "llama-3.2-vision-11b")


def _one_device(model, tokens, labels):
    """The port's one-device logits, loss, gradients (by name) and decode
    logits."""
    with torch.no_grad():
        logits = model(torch.as_tensor(tokens)).numpy()
        caches = model.init_decode_caches(B, MAX_LEN)
        dec = []
        for t in range(DECODE):
            lg, caches = model.decode_step(torch.as_tensor(
                tokens[:, t:t + 1]), caches, t)
            dec.append(lg.numpy())
    for p in model.parameters():
        p.requires_grad_(True)
    loss, _ = lm_loss(model, tokens, labels=labels)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return {"logits": logits, "loss": float(loss.detach()),
            "grads": {n: g.numpy() for (n, _), g in
                      zip(model.named_parameters(), grads)},
            "decode": np.stack(dec)}


def _global(batch: dict, D: int) -> dict:
    """The global batch the data ranks hold (rank r rows ``r::D``), in
    rank order."""
    return {k: np.concatenate([v[r::D] for r in range(D)])
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's weights saved for the ranks, and each config's
    one-device results from JAX and from the port; the global batches,
    the learning batch, and the port's one-device trajectory."""
    d = tmp_path_factory.mktemp("dist_tp")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    ref = {}
    for arch, over in ARCHS.items():
        jcfg = j_get_config(arch).reduced(**over)
        params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, params)
        td.save_tree(d / f"{arch}.npz", host)
        logits = jax.jit(lambda p, t, c=jcfg: jlm.forward(
            p, c, tokens=t)[0])(params, tokens)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, t, lab, c=jcfg: jlm.lm_loss(p, c, tokens=t,
                                                  labels=lab),
            has_aux=True))(params, tokens, labels)
        step = jax.jit(lambda p, t, c, pos, k=jcfg: jlm.decode_step(
            p, k, t, c, pos))
        caches = jlm.init_decode_caches(jcfg, B, MAX_LEN)
        dec = []
        for t in range(DECODE):
            lg, caches = step(params, jnp.asarray(tokens[:, t:t + 1]),
                              caches, jnp.int32(t))
            dec.append(np.asarray(lg))
        cfg = get_config(arch).reduced(**over)
        ref[arch] = {
            "cfg": cfg,
            "jax": {"logits": np.asarray(logits), "loss": float(loss),
                    "grads": _paths(jax.tree.map(np.asarray, grads)),
                    "decode": np.stack(dec)},
            "port": _one_device(lm_from_arrays(host, cfg, "cpu"), tokens,
                                labels)}
    src = tpipe.make_source(tpipe.DataConfig(vocab_size=512, seq_len=16,
                                             global_batch=BATCH))
    batches = [src.batch(s) for s in range(STEPS)]
    learn = {"tokens": np.random.default_rng(5).integers(
        0, 512, (8, 32)).astype(np.int32)}
    learn["labels"] = np.random.default_rng(6).integers(
        0, 512, (8, 32)).astype(np.int32)
    # the port's one-device trajectories on the global batches
    traj = {}
    for compress in (False, True):
        tcfg = TrainConfig(microbatches=1, peak_lr=1e-3, warmup_steps=2,
                           total_steps=50, compress_grads=compress,
                           remat=False)
        model = lm_from_arrays(td.load_tree(d / "qwen3-0.6b.npz"),
                               ref["qwen3-0.6b"]["cfg"], "cpu")
        state = train_state_init(model, tcfg)
        step = make_train_step(model, tcfg)
        init = {n: p.detach().numpy().copy()
                for n, p in model.named_parameters()}
        losses = []
        for b in batches:
            state, m = step(state, _global(b, 2))
            losses.append(float(m["loss"]))
        traj[compress] = (losses, init, {
            n: p.detach().numpy() for n, p in model.named_parameters()})
    return d, tokens, labels, ref, batches, learn, traj


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    d, tokens, labels, _, batches, learn, _ = setup
    out = {}
    for world in (4, 2):             # 4 writes the checkpoint 2 restores
        out[world] = td.run_world(td.tp_world, world,
                                  tmp_path_factory.mktemp(f"tp{world}"),
                                  str(d), tokens, labels, DECODE, MAX_LEN,
                                  batches, learn, LAUNCH, timeout=600)
    return out


def _models(worlds, shape, arch) -> list:
    return [r["models"][(shape, arch)]
            for r in worlds[shape[0] * shape[1]]]


def _tree_paths(named: dict, cfg) -> dict:
    """Gradients by port name as the reference's tree paths."""
    return _paths(lm_to_arrays({k: torch.as_tensor(v)
                                for k, v in named.items()}, cfg))


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", SHAPES)
def test_tp_prefill_matches_one_device(setup, worlds, shape, arch):
    ref = setup[3][arch]
    for r in _models(worlds, shape, arch):
        for want in (ref["jax"]["logits"], ref["port"]["logits"]):
            assert _rel(r["logits"], want) <= LOGIT_REL
        np.testing.assert_array_equal(r["logits"], _models(
            worlds, shape, arch)[0]["logits"])


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", SHAPES)
def test_tp_loss_and_grads_match_one_device(setup, worlds, shape, arch):
    ref = setup[3][arch]
    cfg = ref["cfg"]
    want_jax = ref["jax"]["grads"]
    want_port = _tree_paths(ref["port"]["grads"], cfg)
    for r in _models(worlds, shape, arch):
        for want in (ref["jax"]["loss"], ref["port"]["loss"]):
            assert abs(r["loss"] - want) <= LOSS_REL * abs(want)
        got = _tree_paths(r["grads"], cfg)
        assert sorted(got) == sorted(want_jax) == sorted(want_port)
        for want in (want_jax, want_port):
            for path, w in want.items():
                err = float(np.max(np.abs(got[path] - w)))
                assert err <= GRAD_REL * float(np.max(np.abs(w))), \
                    (path, err)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", SHAPES)
def test_tp_decode_matches_one_device(setup, worlds, shape, arch):
    ref = setup[3][arch]
    for r in _models(worlds, shape, arch):
        for want in (ref["jax"]["decode"], ref["port"]["decode"]):
            np.testing.assert_array_equal(r["decode"].argmax(-1),
                                          want.argmax(-1))
            assert _rel(r["decode"], want) <= LOGIT_REL


def test_head_split_leaves_replicated(setup, worlds):
    """Where a rule would cut inside a head, the leaf is replicated: every
    reduced config's 2 kv heads at M = 4 (glm4-9b's 2 kv heads at full
    width too), nothing at M = 2; the caches hold each rank's kv heads;
    the cut weights gather back whole bit for bit."""
    for shape in SHAPES:
        M = shape[1]
        for arch in ARCHS:
            L = setup[3][arch]["cfg"].num_layers
            want = ([] if M == 2 else
                    [f"blocks.{i}.attn.{w}" for i in range(L)
                     for w in ("wk", "wv")])
            for r in _models(worlds, shape, arch):
                assert sorted(r["replicated"]) == sorted(want)
                assert r["kv_heads"] == 1
                assert r["round_trip"]


def test_tp_training_trajectory_matches_one_device(setup, worlds):
    for r in worlds[4]:
        t = r["train"]
        for compress in (False, True):
            losses, init, params = setup[6][compress]
            got_losses, got = t["traj"][compress]
            np.testing.assert_allclose(got_losses, losses,
                                       rtol=TRAIN_LOSS_REL)
            assert got_losses == worlds[4][0]["train"]["traj"][compress][0]
            for n, want in params.items():
                diff = np.abs(got[n] - want)
                moved = float(np.max(np.abs(want - init[n])))
                if not compress:
                    assert diff.max() <= TRAIN_STEP_REL * moved, n
                else:
                    assert diff.max() <= INT8_STEP_REL * moved, n
                    assert (diff > TRAIN_STEP_REL * moved).mean() \
                        <= INT8_FLIPS, n
        # ZeRO-1 at (2, 2): the embedding's rows are split over the model
        # axis, so its moments' columns are split over the data axis
        assert t["zero"]["embed"] == 1
        assert t["moments"]["embed"] == (512 // 2, 128 // 2)


def test_zero1_is_bit_for_bit_with_whole_moments(worlds):
    for r in worlds[2]:
        z = r["zero"]
        assert z["zero_used"] and z["params"] and z["moments"]


def test_tp_learns_as_the_reference_spmd_step(worlds):
    losses = [r["train"]["learn"] for r in worlds[4]]
    assert all(l == losses[0] for l in losses)
    assert losses[0][-1] < losses[0][0] - 0.2, losses[0]


def test_checkpoint_from_2x2_restores_at_1x2_and_world_one(setup, worlds):
    d = setup[0]
    with np.load(d / "ckpt" / f"step_{STEPS}" / "arrays.npz") as z:
        saved = {k: z[k] for k in z.files}
    for step, arrays in (r["restore"] for r in worlds[2]):
        assert step == STEPS
        assert sorted(arrays) == sorted(saved)
        for k, v in saved.items():
            assert arrays[k].dtype == v.dtype
            np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    cfg = setup[3]["qwen3-0.6b"]["cfg"]
    state = train_state_init(lm_from_arrays(
        td.load_tree(d / "qwen3-0.6b.npz"), cfg, "cpu"),
        TrainConfig(compress_grads=True))
    state, meta = Checkpointer(str(d / "ckpt")).restore(state)
    one = train_state_to_arrays(state)
    assert meta["step"] == STEPS and sorted(one) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(one[k], v, err_msg=k)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_launcher_trains_and_resumes_over_a_model_axis(setup, worlds, mesh,
                                                       tmp_path):
    d = setup[0]
    ckpt = str(tmp_path / "one")
    first = launch.main([*LAUNCH, "--steps", "3", "--ckpt-dir", ckpt])
    second = launch.main([*LAUNCH, "--steps", "6", "--ckpt-dir", ckpt])
    world = 2 if mesh == "1x2" else 4
    for r in worlds[world]:
        a, b = r["launch"] if world == 2 else r["train"]["launch"]
        assert len(a) == len(b) == 3
        np.testing.assert_allclose(a, first, rtol=1e-5)
        np.testing.assert_allclose(b, second, rtol=1e-5)
    steps = sorted(p.name for p in (d / ("launch12" if world == 2
                                         else "launch22")).iterdir())
    assert steps == ["step_3", "step_6"]


def test_tp_with_flash_decoding_is_refused(worlds):
    for shape in SHAPES:
        for arch in ARCHS:
            for r in _models(worlds, shape, arch):
                assert "not combined" in r["flash"]


def test_other_kinds_refused_at_model_axis_two(worlds):
    for r in worlds[2]:
        assert sorted(r["refused"]) == sorted(REFUSED)
        for arch, msg in r["refused"].items():
            assert msg is not None and "next slice" in msg, arch
            assert "queue 1 item 2" in msg, arch
