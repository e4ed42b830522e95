"""Tensor parallelism of the port over the model axis, over real gloo
worlds of 2 and 4 ranks, against the reference's and the port's
one-device models.

The reduced qwen3-0.6b (dense, tied head), gemma3-4b (local and global
layers, 6 layers, window 16), glm4-9b (untied head), deepseek-moe-16b
(GQA and a MoE of 8 routed and 2 shared experts), deepseek-v2-lite-16b
(MLA and the MoE), llama-3.2-vision-11b (5 layers, the last a cross
layer, fed seeded media, its gate opened to 0.5: a zero gate passes any
parity), hymba-1.5b (hybrid: its 4 heads' attention split, the Mamba
branch by channels), xlstm-1.3b with an sLSTM layer every 2nd (mLSTM and
sLSTM by heads), and three variants (``tests/_torch_dist.py::TP_ARCHS``:
int8 dispatch; grouped routing at a capacity that drops tokens; hymba's
"+odd", 5 heads whose 64 Mamba channels straddle the ranks as the full
width's 25 heads do), start from the reference's weights
(``jlm.init_params``, carried by ``repro_torch.convert.lm_from_arrays``),
in float32.  The ranks (``tests/_torch_dist.py::tp_world``) cut them over
meshes (1, 2) (world 2), (2, 2) and (1, 4) (world 4) with ``shard_lm``.
At M = 4 the kv heads (2 in every reduced config) do not divide, so
``wk`` and ``wv`` are replicated (the cross layer's too); "+odd"'s 5
heads replicate its attention; sLSTM's ``out_norm`` acts on h gathered
whole, and its MLP (170 wide) stays whole at M = 4; the test lists
those leaves.  MLA's latent cache stays whole on every rank; a Mamba
cache holds this rank's channels as sub-heads of gcd(P, inner / M),
an xLSTM cache this rank's heads.

Contracts, against JAX's one-device ``lm`` and the port's one-device
``DecoderLM`` on the same weights:
* the prefill logits within 1e-5 of max |logits|;
* the loss within 1e-6 (relative), every gradient leaf within 1e-4 of its
  max |g|;
* 8 decode steps from empty caches: argmax equal, |Δ| within 1e-5 of max
  |logits|;
* ``gather_lm`` returns the weights the ranks were cut from, bit for bit;
* the MoE's dropped fraction equal to the one-device model's, and at
  (2, 2) with the statistics over the data group (the data-parallel mean
  of the ranks' rows against the one-device global batch) the loss and
  gradients as above and the aux terms within 1e-6 (relative);
* at a model axis of one rank ((2, 1), world 2) every case equals the
  plain model bit for bit: logits, loss, every gradient leaf, decode.
With int8 dispatch a partial sum's last bits move an element across an
int8 rounding boundary, one quantum (1/127) of its row's max, which the
next layers carry: that case holds the logits within 1/127 of max
|logits|, the loss and the aux terms within 1e-3 (relative), the
gradients within 2e-2 of max |g|, the decode's argmax equal.
Training at (2, 2): 5 steps with ZeRO-1, without and with int8
compression, on the ranks' rows of a global batch of 8, against the
port's one-device steps on that batch: each loss within 1e-5 (relative);
without compression every parameter within 1e-3 of the largest update its
leaf took in the 5 steps; with it, where the partial sums' last bits move
an element across an int8 rounding boundary and Adam turns one quantum
into a step of ~lr, within 0.25 of that update, and at most 10% of a
leaf's elements past 1e-3 of it.  The reduced
deepseek-v2-lite-16b trains the same 5 steps at (2, 2) without
compression, held as the compressed run (an embedding element whose
gradient nearly cancels takes another Adam step, as under data
parallelism alone).  The loss falls by 0.2
over 8 steps at lr 5e-3 (the contract of the reference's
``test_spmd_train_step_runs``).  ZeRO-1 moments over a (2, 1) mesh equal
whole moments bit for bit, parameters included.  The checkpoints written at
(2, 2) (Qwen3's, int8, and the MoE's) restore at (1, 2) and at world 1
bit for bit.  The xLSTM case trains the same 5 steps at (2, 2) without
compression, held as the MoE's (an embedding element whose gradient
nearly cancels, as under data parallelism alone), its roles (``w_up``,
``w_if``, ``w_gates``) cut role by role; its checkpoint restores at
(1, 2) and at world 1 bit for bit.  ``launch.train --mesh 1x2`` and
``2x2`` train and resume, losses within 1e-5 of a one-process run, the
reduced deepseek-v2-lite-16b, hymba-1.5b and xlstm-1.3b too at ``1x2``.
Each of the ten reduced configs shards at M = 2 and 4, its split logits
within 1e-5 of the plain model's, and flash decoding on the model axis
of a sharded model raises ``ValueError``.
"""

import math

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
# int8 dispatch: a partial sum's last bits can move an element across an
# int8 rounding boundary, one quantum (1/127) of its row's max
INT8_QUANTUM = 1 / 127
INT8_LOSS_REL, INT8_GRAD_REL = 1e-3, 2e-2
STEPS, BATCH = 5, 8
LAUNCH = ["--device", "cpu", "--reduced", "--batch", "4", "--seq", "16",
          "--lr", "1e-3", "--ckpt-every", "3", "--log-every", "1"]
MOE = td.TP_MOE
CROSS_GATE = 0.5
AUX_REL = 1e-6


def _is_int8(case: str) -> bool:
    return "+int8" in case


def _logit_rel(case: str) -> float:
    """The logits' bound: ``LOGIT_REL``, or for int8 dispatch one int8
    quantum of a row's max (module docstring)."""
    return INT8_QUANTUM if _is_int8(case) else LOGIT_REL


def _media(cfg, rng):
    return (rng.standard_normal((B, cfg.vision_tokens, cfg.d_model))
            .astype(np.float32) if cfg.vision_tokens else None)


def _one_device(model, tokens, labels, media):
    """The port's one-device logits, loss and its metrics, gradients (by
    name) and decode logits."""
    kw = td.media_kw(model, media)
    with torch.no_grad():
        logits = model(torch.as_tensor(tokens), **kw).numpy()
        caches = td.decode_caches(model, torch.as_tensor(tokens), media,
                                  MAX_LEN)
        dec = []
        for t in range(DECODE):
            lg, caches = model.decode_step(torch.as_tensor(
                tokens[:, t:t + 1]), caches, t)
            dec.append(lg.numpy())
    for p in model.parameters():
        p.requires_grad_(True)
    loss, metrics = lm_loss(model, tokens, labels=labels, **kw)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return {"logits": logits, "loss": float(loss.detach()),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: g.numpy() for (n, _), g in
                      zip(model.named_parameters(), grads)},
            "decode": np.stack(dec)}


def _jax_loss(params, jcfg, tokens, labels, media):
    kw = {} if media is None else {"media": jnp.asarray(media)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, t, lab: jlm.lm_loss(p, jcfg, tokens=t, labels=lab, **kw),
        has_aux=True))(params, tokens, labels)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _paths(jax.tree.map(np.asarray, grads))}


def _jax_one_device(params, jcfg, tokens, labels, media):
    """JAX's one-device logits, loss, metrics, gradients (tree paths) and
    decode logits, the cross layers' media K/V from the prefill."""
    kw = {} if media is None else {"media": jnp.asarray(media)}
    logits, _, pre = jax.jit(lambda p, t: jlm.forward(
        p, jcfg, tokens=t, want_caches=True, **kw))(params, tokens)
    step = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, jcfg, t, c, pos))
    caches = jlm.init_decode_caches(jcfg, B, MAX_LEN)
    if "cross" in pre:
        caches["cross"] = pre["cross"]
    dec = []
    for t in range(DECODE):
        lg, caches = step(params, jnp.asarray(tokens[:, t:t + 1]), caches,
                          jnp.int32(t))
        dec.append(np.asarray(lg))
    return {"logits": np.asarray(logits), "decode": np.stack(dec),
            **_jax_loss(params, jcfg, tokens, labels, media)}


def _global(batch: dict, D: int) -> dict:
    """The global batch the data ranks hold (rank r rows ``r::D``), in
    rank order."""
    return {k: np.concatenate([v[r::D] for r in range(D)])
            for k, v in batch.items()}


def _trajectory(path, cfg, batches, tcfg):
    """The port's one-device steps on the global batches: (losses, the
    parameters before, after)."""
    model = lm_from_arrays(td.load_tree(path), cfg, "cpu")
    state = train_state_init(model, tcfg)
    step = make_train_step(model, tcfg)
    init = {n: p.detach().numpy().copy()
            for n, p in model.named_parameters()}
    losses = []
    for b in batches:
        state, m = step(state, _global(b, 2))
        losses.append(float(m["loss"]))
    return losses, init, {n: p.detach().numpy()
                          for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's weights saved for the ranks (the cross gate
    opened), the media, and each case's one-device results from JAX and
    from the port (a MoE case's also on the global batch of the data
    ranks' rows); the global batches, the learning batch, and the port's
    one-device trajectories."""
    d = tmp_path_factory.mktemp("dist_tp")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    media = _media(get_config("llama-3.2-vision-11b").reduced(),
                   np.random.default_rng(3))
    glob = _global({"tokens": tokens, "labels": labels}, 2)
    ref = {}
    for case in ARCHS:
        jcfg = td.tp_config(j_get_config, case)
        params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        if "cross" in params["blocks"]:
            attn = params["blocks"]["cross"]["attn"]
            attn["gate"] = jnp.full_like(attn["gate"], CROSS_GATE)
        host = jax.tree.map(np.asarray, params)
        td.save_tree(d / f"{case}.npz", host)
        cfg = td.tp_config(get_config, case)
        m = media if cfg.vision_tokens else None
        ref[case] = {
            "cfg": cfg,
            "jax": _jax_one_device(params, jcfg, tokens, labels, m),
            "port": _one_device(lm_from_arrays(host, cfg, "cpu"), tokens,
                                labels, m)}
        if case in MOE:
            ref[case]["global"] = {
                "jax": _jax_loss(params, jcfg, glob["tokens"],
                                 glob["labels"], None),
                "port": _one_device(lm_from_arrays(host, cfg, "cpu"),
                                    glob["tokens"], glob["labels"], None)}
    src = tpipe.make_source(tpipe.DataConfig(vocab_size=512, seq_len=16,
                                             global_batch=BATCH))
    batches = [src.batch(s) for s in range(STEPS)]
    learn = {"tokens": np.random.default_rng(5).integers(
        0, 512, (8, 32)).astype(np.int32)}
    learn["labels"] = np.random.default_rng(6).integers(
        0, 512, (8, 32)).astype(np.int32)
    traj = {}
    for compress in (False, True):
        tcfg = TrainConfig(microbatches=1, peak_lr=1e-3, warmup_steps=2,
                           total_steps=50, compress_grads=compress,
                           remat=False)
        traj[compress] = _trajectory(d / "qwen3-0.6b.npz",
                                     ref["qwen3-0.6b"]["cfg"], batches, tcfg)
        if not compress:
            for key, case in (("moe", td.TP_TRAIN_MOE),
                              ("xlstm", td.TP_XLSTM)):
                traj[key] = _trajectory(d / f"{case}.npz",
                                        ref[case]["cfg"], batches, tcfg)
    return d, tokens, labels, ref, batches, learn, traj, media


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    d, tokens, labels, _, batches, learn, _, media = setup
    out = {}
    for world in (4, 2):             # 4 writes the checkpoints 2 restores
        out[world] = td.run_world(td.tp_world, world,
                                  tmp_path_factory.mktemp(f"tp{world}"),
                                  str(d), tokens, labels, media, DECODE,
                                  MAX_LEN, batches, learn, LAUNCH,
                                  timeout=900)
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


def _grads_close(got: dict, wants: tuple, bound: float, only=None):
    """Every gradient leaf (tree paths; those ``only`` picks) within
    ``bound`` of its max |g| against each of ``wants``."""
    for want in wants:
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            if only is not None and not only(path):
                continue
            err = float(np.max(np.abs(got[path] - w)))
            assert err <= bound * float(np.max(np.abs(w))), (path, err)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", SHAPES)
def test_tp_prefill_matches_one_device(setup, worlds, shape, arch):
    ref = setup[3][arch]
    for r in _models(worlds, shape, arch):
        for want in (ref["jax"]["logits"], ref["port"]["logits"]):
            assert _rel(r["logits"], want) <= _logit_rel(arch)
        np.testing.assert_array_equal(r["logits"], _models(
            worlds, shape, arch)[0]["logits"])


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", SHAPES)
def test_tp_loss_and_grads_match_one_device(setup, worlds, shape, arch):
    ref = setup[3][arch]
    cfg = ref["cfg"]
    loss_rel = INT8_LOSS_REL if _is_int8(arch) else LOSS_REL
    grad_rel = INT8_GRAD_REL if _is_int8(arch) else GRAD_REL
    for r in _models(worlds, shape, arch):
        for want in (ref["jax"]["loss"], ref["port"]["loss"]):
            assert abs(r["loss"] - want) <= loss_rel * abs(want)
        _grads_close(_tree_paths(r["grads"], cfg), (
            ref["jax"]["grads"], _tree_paths(ref["port"]["grads"], cfg)),
            grad_rel)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", SHAPES)
def test_tp_decode_matches_one_device(setup, worlds, shape, arch):
    ref = setup[3][arch]
    for r in _models(worlds, shape, arch):
        for want in (ref["jax"]["decode"], ref["port"]["decode"]):
            np.testing.assert_array_equal(r["decode"].argmax(-1),
                                          want.argmax(-1))
            assert _rel(r["decode"], want) <= _logit_rel(arch)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape", SHAPES)
def test_tp_moe_router_gradient_is_whole(setup, worlds, shape, arch):
    """The routers' gradients within 1e-4 of their max |g|: a rank's
    share alone (its experts' combine weights) or one summed over the
    model axis (the aux terms' whole gradient M times) is far outside."""
    ref = setup[3][arch]
    cfg = ref["cfg"]
    bound = INT8_GRAD_REL if _is_int8(arch) else GRAD_REL
    for r in _models(worlds, shape, arch):
        _grads_close(_tree_paths(r["grads"], cfg), (
            ref["jax"]["grads"], _tree_paths(ref["port"]["grads"], cfg)),
            bound, only=lambda path: path[-1] == "router")


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape", SHAPES)
def test_tp_moe_statistics_match_one_device(setup, worlds, shape, arch):
    """The layers' summed dropped fraction equal to the port's one-device
    model's and JAX's, the aux terms within 1e-6 (relative; with int8
    dispatch, whose quanta reach the next layer's router, the loss's
    bound)."""
    ref = setup[3][arch]
    aux_rel = INT8_LOSS_REL if _is_int8(arch) else AUX_REL
    for r in _models(worlds, shape, arch):
        got = r["metrics"]
        assert got["dropped_frac"] == ref["port"]["metrics"]["dropped_frac"]
        for want in (ref["jax"]["metrics"], ref["port"]["metrics"]):
            assert abs(got["dropped_frac"] - want["dropped_frac"]) <= \
                AUX_REL * abs(want["dropped_frac"])
            for k in ("load_balance", "router_z"):
                assert abs(got[k] - want[k]) <= aux_rel * abs(want[k]), k
    if arch.endswith("+routed"):
        assert ref["port"]["metrics"]["dropped_frac"] > 0


@pytest.mark.parametrize("arch", MOE)
def test_tp_moe_statistics_over_the_data_group(setup, worlds, arch):
    """At (2, 2) each data rank holds half the rows and the MoE's
    capacity, drops and load balance are taken over the data group: the
    data-parallel mean of the loss, the metrics and the gradients equals
    the one-device model's on the global batch."""
    ref = setup[3][arch]["global"]
    cfg = setup[3][arch]["cfg"]
    bound = INT8_GRAD_REL if _is_int8(arch) else GRAD_REL
    loss_rel = INT8_LOSS_REL if _is_int8(arch) else LOSS_REL
    aux_rel = INT8_LOSS_REL if _is_int8(arch) else AUX_REL
    for r in worlds[4]:
        got = r["data_group"][arch]
        for want in (ref["jax"], ref["port"]):
            assert abs(got["loss"] - want["loss"]) <= loss_rel * \
                abs(want["loss"])
            for k in ("load_balance", "router_z", "dropped_frac"):
                w = want["metrics"][k]
                assert abs(got["metrics"][k] - w) <= aux_rel * abs(w), k
        assert got["metrics"]["dropped_frac"] == \
            ref["port"]["metrics"]["dropped_frac"]
        _grads_close(_tree_paths(got["grads"], cfg), (
            ref["jax"]["grads"], _tree_paths(ref["port"]["grads"], cfg)),
            bound)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp_model_axis_of_one_is_bit_for_bit(worlds, arch):
    for r in worlds[2]:
        got = r["one_rank"][arch]
        assert got["logits"] and got["loss"] and got["decode"]
        assert got["grads"] == []


def _replicated_want(cfg, M: int) -> list:
    """The leaves a model axis of ``M`` replicates against the rules: an
    attention layer's four projections where its query heads do not
    divide ("+odd"'s 5), else its ``wk``/``wv`` where its kv heads do not
    (every reduced config's 2 at M = 4; MLA has none); every sLSTM
    layer's ``out_norm``, and its ``w_ff2`` where the MLP's columns do
    not divide (the rules would cut its d_model columns instead)."""
    out = []
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == "slstm":
            out.append(f"blocks.{i}.mix.out_norm")
            if (4 * cfg.d_model // 3) % M:
                out.append(f"blocks.{i}.mix.w_ff2")
        elif kind != "mlstm" and not cfg.mla_enabled:
            held = (("wq", "wk", "wv", "wo") if cfg.num_heads % M else
                    ("wk", "wv") if cfg.num_kv_heads % M else ())
            out += [f"blocks.{i}.attn.{w}" for w in held]
    return out


def _caches_want(cfg, M: int) -> dict:
    """What a rank's caches hold at a model axis of ``M``
    (``tests/_torch_dist.py::_cache_widths``)."""
    kinds = set(cfg.layer_kinds)
    want = {"kv_heads": [], "latent": [], "ssm": [], "mlstm": [],
            "slstm": []}
    if cfg.mla_enabled:
        want["latent"] = [cfg.mla.kv_lora_rank]
    elif kinds - {"mlstm", "slstm"}:
        want["kv_heads"] = [1]          # one kv head a rank, or held
    if "hybrid" in kinds:
        inner = cfg.ssm.expand * cfg.d_model // M
        sub = math.gcd(cfg.ssm.expand * cfg.d_model // cfg.num_heads, inner)
        want["ssm"] = [(inner, inner // sub, cfg.ssm.state_dim, sub)]
    if "mlstm" in kinds:
        want["mlstm"] = [cfg.num_heads // M]
    if "slstm" in kinds:
        want["slstm"] = [(cfg.d_model // M, cfg.num_heads // M)]
    return want


def test_head_split_leaves_replicated(setup, worlds):
    """Where a rule would cut inside a head, the leaf is replicated: every
    reduced config's 2 kv heads at M = 4 (glm4-9b's 2 kv heads at full
    width too), "+odd"'s attention at M = 2 and 4, sLSTM's ``out_norm``
    and its MLP at M = 4; the GQA and cross caches hold each rank's kv
    heads, an MLA cache its whole latent, a Mamba cache this rank's
    channels as sub-heads (P′ = 32 and 16 for "+odd"), an xLSTM cache
    this rank's heads; the cut weights gather back whole bit for bit."""
    for shape in SHAPES:
        M = shape[1]
        for arch in ARCHS:
            cfg = setup[3][arch]["cfg"]
            want = _caches_want(cfg, M)
            for r in _models(worlds, shape, arch):
                assert sorted(r["replicated"]) == sorted(
                    _replicated_want(cfg, M)), (arch, M)
                for key, w in want.items():
                    assert r[key] == w, (arch, M, key, r[key])
                assert r["round_trip"]
    odd = setup[3]["hymba-1.5b+odd"]["cfg"]
    assert [_caches_want(odd, M)["ssm"][0][3] for M in (2, 4)] == [32, 16]


def _trajectory_close(got_losses, got, want, amplified=False):
    """Each loss within ``TRAIN_LOSS_REL``; every parameter within
    ``TRAIN_STEP_REL`` of the largest update its leaf took, or, where Adam
    amplifies a last-bit difference into a step of ~lr (``amplified``),
    within ``INT8_STEP_REL`` of it and at most ``INT8_FLIPS`` of a leaf's
    elements past ``TRAIN_STEP_REL``."""
    losses, init, params = want
    np.testing.assert_allclose(got_losses, losses, rtol=TRAIN_LOSS_REL)
    for n, w in params.items():
        diff = np.abs(got[n] - w)
        moved = float(np.max(np.abs(w - init[n])))
        if not amplified:
            assert diff.max() <= TRAIN_STEP_REL * moved, n
        else:
            assert diff.max() <= INT8_STEP_REL * moved, n
            assert (diff > TRAIN_STEP_REL * moved).mean() <= INT8_FLIPS, n


def test_tp_training_trajectory_matches_one_device(setup, worlds):
    for r in worlds[4]:
        t = r["train"]
        for compress in (False, True):
            got_losses, got = t["traj"][compress]
            _trajectory_close(got_losses, got, setup[6][compress], compress)
            assert got_losses == worlds[4][0]["train"]["traj"][compress][0]
        # ZeRO-1 at (2, 2): the embedding's rows are split over the model
        # axis, so its moments' columns are split over the data axis
        assert t["zero"]["embed"] == 1
        assert t["moments"]["embed"] == (512 // 2, 128 // 2)


def test_tp_moe_training_trajectory_matches_one_device(setup, worlds):
    """The reduced DeepSeek-V2-Lite's 5 ZeRO-1 steps at (2, 2): the routed
    experts split on their expert axis, their moments on d_model over the
    data axis.  Its embedding takes few tokens' gradients, and an element
    whose gradient nearly cancels turns the partial sums' last bits into
    a different Adam step (data parallelism alone at (2, 1) does so too),
    so the parameters are held as the int8 trajectory's."""
    cfg = setup[3][td.TP_TRAIN_MOE]["cfg"]
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    for r in worlds[4]:
        t = r["train"]["moe"]
        _trajectory_close(t["losses"], t["params"], setup[6]["moe"],
                          amplified=True)
        assert t["losses"] == worlds[4][0]["train"]["moe"]["losses"]
        assert t["zero"]["blocks.1.moe.w_gate"] == 1
        assert t["moments"]["blocks.1.moe.w_gate"] == (E // 2, d // 2, f)
        assert t["moments"]["blocks.1.moe.w_down"] == (E // 2, f, d // 2)


def test_tp_xlstm_training_trajectory_matches_one_device(setup, worlds):
    """The xLSTM case's 5 ZeRO-1 steps at (2, 2): its roles cut role by
    role (a contiguous cut of ``w_up`` would hand rank 0 every value
    channel and rank 1 every gate), the moments of a role-cut leaf split
    by the data axis on its other dim.  Held as the MoE's trajectory: one
    or two embedding elements whose gradient nearly cancels take another
    Adam step past 1e-3 of the leaf's largest update (data parallelism
    alone at (2, 1) moves them too)."""
    cfg = setup[3][td.TP_XLSTM]["cfg"]
    d, inner = cfg.d_model, 2 * cfg.d_model
    for r in worlds[4]:
        t = r["train"]["xlstm"]
        _trajectory_close(t["losses"], t["params"], setup[6]["xlstm"],
                          amplified=True)
        assert t["losses"] == worlds[4][0]["train"]["xlstm"]["losses"]
        assert t["parts"] == {"blocks.0.mix.w_up": 2, "blocks.0.mix.w_if": 2,
                              "blocks.1.mix.w_gates": 4,
                              "blocks.2.mix.w_up": 2, "blocks.2.mix.w_if": 2,
                              "blocks.3.mix.w_gates": 4}
        assert t["moments"]["blocks.0.mix.w_up"] == (d // 2, inner)
        assert t["moments"]["blocks.1.mix.w_gates"] == (d // 2, 2 * d)


def test_zero1_is_bit_for_bit_with_whole_moments(worlds):
    for r in worlds[2]:
        z = r["zero"]
        assert z["zero_used"] and z["params"] and z["moments"]


def test_tp_learns_as_the_reference_spmd_step(worlds):
    losses = [r["train"]["learn"] for r in worlds[4]]
    assert all(l == losses[0] for l in losses)
    assert losses[0][-1] < losses[0][0] - 0.2, losses[0]


def _restores(setup, worlds, case, ckpt, key, compress):
    """The checkpoint ``ckpt`` written at (2, 2) restored at (1, 2) (the
    world's ``key``) and at world 1, each bit for bit with the file."""
    d = setup[0]
    with np.load(d / ckpt / f"step_{STEPS}" / "arrays.npz") as z:
        saved = {k: z[k] for k in z.files}
    for step, arrays in (r[key] for r in worlds[2]):
        assert step == STEPS
        assert sorted(arrays) == sorted(saved)
        for k, v in saved.items():
            assert arrays[k].dtype == v.dtype
            np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    cfg = setup[3][case]["cfg"]
    state = train_state_init(lm_from_arrays(
        td.load_tree(d / f"{case}.npz"), cfg, "cpu"),
        TrainConfig(compress_grads=compress))
    state, meta = Checkpointer(str(d / ckpt)).restore(state)
    one = train_state_to_arrays(state)
    assert meta["step"] == STEPS and sorted(one) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(one[k], v, err_msg=k)


def test_checkpoint_from_2x2_restores_at_1x2_and_world_one(setup, worlds):
    _restores(setup, worlds, "qwen3-0.6b", "ckpt", "restore", True)


def test_moe_checkpoint_from_2x2_restores_at_1x2_and_world_one(setup,
                                                                worlds):
    _restores(setup, worlds, td.TP_TRAIN_MOE, "ckpt_moe", "restore_moe",
              False)


def test_xlstm_checkpoint_from_2x2_restores_at_1x2_and_world_one(setup,
                                                                  worlds):
    """The role-cut leaves are whole in the file (gathered role by role:
    the trajectory test holds the parameters it holds) and each mesh cuts
    them again role by role."""
    _restores(setup, worlds, td.TP_XLSTM, "ckpt_xlstm", "restore_xlstm",
              False)


@pytest.mark.parametrize("mesh,arch", [
    pytest.param("1x2", None, id="1x2"), pytest.param("2x2", None, id="2x2"),
    *(pytest.param("1x2", arch, id=f"1x2-{arch}")
      for arch in td.TP_LAUNCH_ARCHS)])
def test_launcher_trains_and_resumes_over_a_model_axis(setup, worlds, mesh,
                                                       arch, tmp_path):
    d = setup[0]
    argv = [*LAUNCH, *(["--arch", arch] if arch else [])]
    ckpt = str(tmp_path / "one")
    first = launch.main([*argv, "--steps", "3", "--ckpt-dir", ckpt])
    second = launch.main([*argv, "--steps", "6", "--ckpt-dir", ckpt])
    world = 2 if mesh == "1x2" else 4
    for r in worlds[world]:
        a, b = (r["train"]["launch"] if world == 4 else
                r["launch_arch"][arch] if arch else r["launch"])
        assert len(a) == len(b) == 3
        np.testing.assert_allclose(a, first, rtol=1e-5)
        np.testing.assert_allclose(b, second, rtol=1e-5)
    out = ("launch22" if world == 4 else
           f"launch12_{arch}" if arch else "launch12")
    steps = sorted(p.name for p in (d / out).iterdir())
    assert steps == ["step_3", "step_6"]


def test_tp_with_flash_decoding_is_refused(worlds):
    for shape in SHAPES:
        for arch in ARCHS:
            for r in _models(worlds, shape, arch):
                assert "not combined" in r["flash"]


@pytest.mark.parametrize("M", [2, 4])
def test_every_config_shards_over_the_model_axis(worlds, M):
    """Each of the ten reduced configs shards at a model axis of ``M``
    (nothing is refused: hybrid and xLSTM split too), and its split
    logits are within 1e-5 of the plain model's on the same rank."""
    from repro_torch.configs import ARCH_IDS

    for r in worlds[M]:
        got = r["every_config"]
        assert sorted(got) == sorted(ARCH_IDS)
        for arch, rel in got.items():
            assert isinstance(rel, float), (arch, rel)
            assert rel <= LOGIT_REL, (arch, rel)
