"""The port's training path (``repro_torch.{data,optim,training,checkpoint}``
and ``models.lm.lm_loss``) against the JAX package on the CPU.

Data batches bit for bit (synthetic, file, host sharding); the three
schedules at steps 0-1000 within 1e-7 relative; AdamW fed the same
gradients within 1e-6 relative (params, ``m``, ``v``, the grad norm) and
on the reference's quadratic; the int8 compression with error feedback on
seeded gradients without ``.5`` ties; the loss and every gradient leaf of
all ten reduced configs (``test_torch_train_grads.py``); remat ≡ no
remat bit for bit for all ten, the reference's weights carried by
``lm_from_arrays`` and the gradients brought back by ``lm_to_arrays``; ``microbatches=2`` against 1 and the
learning tests with the reference's bars; five train steps against the
reference's ``make_train_step``; the expert product's backward.  The
checkpoints are in ``test_torch_train_ckpt.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro.training import train_step as jts
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_from_arrays, lm_to_arrays
from repro_torch.data import pipeline as tpipe
from repro_torch.models import lm_loss
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.moe import _expert_mm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tsched
from repro_torch.training import train_step as tts
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_models import CROSS_GATE, LMS

GRAD_REL = 1e-4      # a leaf's error against its largest |g|
LOSS_REL = 1e-5


def _twins(arch, **over):
    """(port cfg, reference cfg, reference params, port model) with the
    reference's weights; the depth overrides of ``test_torch_models`` keep
    every block kind (a global layer, an sLSTM layer, a cross layer with
    its gate opened)."""
    kw = {**LMS.get(arch, {}), **over}
    cfg, jcfg = get_config(arch).reduced(**kw), j_get_config(arch).reduced(
        **kw)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    if "cross" in params["blocks"]:
        attn = params["blocks"]["cross"]["attn"]
        attn["gate"] = jnp.full_like(attn["gate"], CROSS_GATE)
    model = lm_from_arrays(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    return cfg, jcfg, params, model


def _batch(cfg, rng, B=2, S=32):
    """numpy inputs: tokens (or embeds), labels and media where needed."""
    b = {}
    if cfg.embed_inputs:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        b["embeds"] = 0.02 * rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.vision_tokens:
        b["media"] = 0.02 * rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return b


def _port_loss_grads(model, batch, remat=False):
    tts.train_state_init(model, tts.TrainConfig())
    params = dict(model.named_parameters())
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    total, metrics = lm_loss(model, t.get("tokens"), t.get("embeds"),
                             t["labels"], t.get("media"), remat=remat)
    grads = torch.autograd.grad(total, list(params.values()))
    return total, metrics, dict(zip(params, grads))


def _paths(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_paths(tree[k], prefix + (k,)))
    return out


def assert_grads_close(got_tree, want_tree):
    got, want = _paths(got_tree), _paths(jax.tree.map(np.asarray,
                                                      want_tree))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.max(np.abs(got[path] - w)))
        assert err <= GRAD_REL * float(np.max(np.abs(w))), (path, err)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("step", [0, 7, 8, 123])
def test_synthetic_batches_equal_reference(step):
    dc = dict(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    got = tpipe.make_source(tpipe.DataConfig(**dc)).batch(step)
    want = jpipe.make_source(jpipe.DataConfig(**dc)).batch(step)
    assert sorted(got) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])


def test_data_deterministic_and_resumable():
    dc = tpipe.DataConfig(vocab_size=100, seq_len=16, global_batch=8)
    src = tpipe.make_source(dc)
    b1 = src.batch(7)
    np.testing.assert_array_equal(b1["tokens"],
                                  tpipe.make_source(dc).batch(7)["tokens"])
    assert not np.array_equal(b1["tokens"], src.batch(8)["tokens"])


@pytest.mark.parametrize("host", [0, 1])
def test_host_sharding_equals_reference(host):
    dc = dict(vocab_size=50, seq_len=8, global_batch=8, num_hosts=2,
              host_id=host)
    got = tpipe.make_source(tpipe.DataConfig(**dc)).batch(3)["tokens"]
    want = jpipe.make_source(jpipe.DataConfig(**dc)).batch(3)["tokens"]
    np.testing.assert_array_equal(got, want)
    full = tpipe.make_source(tpipe.DataConfig(
        vocab_size=50, seq_len=8, global_batch=8)).batch(3)["tokens"]
    np.testing.assert_array_equal(got, full[host::2])
    with pytest.raises(ValueError, match="divide"):
        tpipe.make_source(tpipe.DataConfig(vocab_size=50, seq_len=8,
                                           global_batch=7, num_hosts=2))


def test_file_source_equals_reference(tmp_path):
    toks = (np.arange(1000, dtype=np.int32) * 7) % 64
    p = str(tmp_path / "tokens.bin")
    tpipe.prepare_tokens(p, toks)
    assert np.array_equal(np.fromfile(p, np.int32), toks)
    dc = dict(vocab_size=64, seq_len=16, global_batch=2, kind="file", path=p)
    for step in (0, 1, 40):
        got = tpipe.make_source(tpipe.DataConfig(**dc)).batch(step)
        want = jpipe.make_source(jpipe.DataConfig(**dc)).batch(step)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="path"):
        tpipe.make_source(tpipe.DataConfig(vocab_size=64, seq_len=16,
                                           global_batch=2, kind="file"))


# --------------------------------------------------------------- schedules
class _TorchCos:
    """``jnp`` with torch's ``cos``: the reference's schedule expression
    evaluated around the port's cosine."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def cos(x):
        return jnp.asarray(torch.cos(torch.tensor(np.asarray(x))).numpy())


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear",
                                  "constant"])
def test_schedules_equal_reference(name, monkeypatch):
    """Within 1e-7 relative at steps 0-1000.  torch's float32 ``cos`` and
    XLA's (glibc's ``cosf``) differ by one ulp at some arguments, and near
    the end of the cosine ``1 + cos`` cancels, so that ulp reaches ~3e-7 of
    the learning rate.  The cosine schedule is therefore held to the
    reference's expression around torch's ``cos``, and the two cosines on
    its arguments to one ulp."""
    kw = dict(peak_lr=1e-3, warmup_steps=100, total_steps=1000)
    steps = np.arange(0, 1001, dtype=np.int32)
    got = getattr(tsched, name)(torch.tensor(steps), **kw)
    if name == "warmup_cosine":
        arg = np.float32(np.pi) * np.clip((steps.astype(np.float32) - 100)
                                          / np.float32(900), 0, 1)
        tc = torch.cos(torch.tensor(arg)).numpy()
        jc = np.asarray(jnp.cos(jnp.asarray(arg)))
        assert np.max(np.abs(tc.view(np.int32) - jc.view(np.int32))) <= 1
        monkeypatch.setattr(jsched, "jnp", _TorchCos())
    want = getattr(jsched, name)(jnp.asarray(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                               atol=0)
    if name == "warmup_cosine":
        assert float(got[0]) == 0.0 and float(got.max()) <= 1e-3 + 1e-9
        assert float(got[100]) == pytest.approx(1e-3, rel=1e-3)
        assert float(got[999]) < 2.1e-4


# ------------------------------------------------------------------- AdamW
def _leaves(rng):
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 6)}
    return ({k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()},
            {k: rng.standard_normal(s).astype(np.float32) * 0.3
             for k, s in shapes.items()})


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_equals_reference_on_the_same_grads(clip):
    """Three updates, each fed the same gradients in both packages; the
    global norm clips in the first case and not in the second."""
    rng = np.random.default_rng(0)
    p0, _ = _leaves(rng)
    cfg = dict(weight_decay=0.1, clip_norm=clip)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    ts, js = tadamw.adamw_init(tp), jadamw.adamw_init(jp)
    for step in range(3):
        _, g = _leaves(np.random.default_rng(step + 1))
        lr = 1e-2 * (step + 1)
        tp, ts, tm = tadamw.adamw_update(
            tadamw.AdamWConfig(**cfg), tp, {k: torch.tensor(v)
                                            for k, v in g.items()},
            ts, torch.tensor(lr, dtype=torch.float32))
        jp, js, jm = jadamw.adamw_update(
            jadamw.AdamWConfig(**cfg), jp, {k: jnp.asarray(v)
                                            for k, v in g.items()},
            js, jnp.float32(lr))
        assert int(ts.step) == int(js.step) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for k in p0:
            for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                              (ts.v[k], js.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)


def test_adamw_bf16_param_is_cast_once():
    """A bf16 parameter takes the float32 update cast once: JAX's bits."""
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((64, 33)).astype(np.float32)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    jp = {"w": jnp.asarray(p0, jnp.bfloat16)}
    tp = {"w": torch.tensor(np.asarray(jp["w"].astype(jnp.float32))).to(
        torch.bfloat16)}
    cfg = dict(clip_norm=1e9)
    tp, _, _ = tadamw.adamw_update(tadamw.AdamWConfig(**cfg), tp,
                                   {"w": torch.tensor(g)},
                                   tadamw.adamw_init(tp),
                                   torch.tensor(0.25))
    jp, _, _ = jadamw.adamw_update(jadamw.AdamWConfig(**cfg), jp,
                                   {"w": jnp.asarray(g)},
                                   jadamw.adamw_init(jp), jnp.float32(0.25))
    assert tp["w"].dtype == torch.bfloat16
    want = np.asarray(jp["w"].astype(jnp.float32))
    np.testing.assert_array_equal(tp["w"].float().numpy(), want)


def test_adamw_reduces_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = tadamw.adamw_init(params)
    cfg = tadamw.AdamWConfig(weight_decay=0.0)
    for _ in range(200):
        g = {"w": 2.0 * (params["w"] - target)}
        params, state, _ = tadamw.adamw_update(cfg, params, g, state,
                                               torch.tensor(0.05))
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-2


def test_clip_by_global_norm_equals_reference():
    _, g = _leaves(np.random.default_rng(9))
    got, gn = tadamw.clip_by_global_norm(
        {k: torch.tensor(v) for k, v in g.items()}, 0.5)
    want, jn = jadamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 0.5)
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-8)


# ------------------------------------------------------------- compression
def test_compress_equals_reference():
    """Two rounds of int8 quantization with error feedback; the seeded
    gradients have no element on a ``.5`` boundary of the scale."""
    rng = np.random.default_rng(12)
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in {"a": (40, 9), "b": (17,)}.items()}
    te = {k: torch.zeros(v.shape) for k, v in g.items()}
    je = {k: jnp.zeros(v.shape, jnp.float32) for k, v in g.items()}
    for _ in range(2):
        for k, v in g.items():
            x = v + np.asarray(je[k])
            frac = np.abs(x / (np.abs(x).max() / 127.0 + 1e-12)) % 1.0
            assert np.abs(frac - 0.5).min() > 1e-3
        td, te = tts._compress({k: torch.tensor(v) for k, v in g.items()},
                               te)
        jd, je = jts._compress({k: jnp.asarray(v) for k, v in g.items()},
                               je)
        for k in g:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
            np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))


def test_quantize_rounds_half_to_even():
    q, scale = tts._quantize_int8(torch.tensor([127.0, 0.5, 1.5, -2.5]))
    assert q.dtype == torch.int8 and q.tolist() == [127, 0, 2, -2]


# ----------------------------------------------------- loss and gradients
def test_softmax_cross_entropy_equals_reference():
    from repro.models.common import softmax_cross_entropy as j_sce

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        got = softmax_cross_entropy(torch.tensor(logits),
                                    torch.tensor(labels),
                                    None if m is None else torch.tensor(m))
        want = j_sce(jnp.asarray(logits), jnp.asarray(labels),
                     None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_equals_no_remat_bit_for_bit(arch):
    cfg, _, _, model = _twins(arch)
    batch = _batch(cfg, np.random.default_rng(4), S=16)
    l1, _, g1 = _port_loss_grads(model, batch, remat=False)
    l2, _, g2 = _port_loss_grads(model, batch, remat=True)
    assert torch.equal(l1, l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def test_lm_to_arrays_inverts_lm_from_arrays():
    cfg, _, params, model = _twins("deepseek-v2-lite-16b")
    back = _paths(lm_to_arrays(model))
    want = _paths(jax.tree.map(np.asarray, params))
    assert sorted(back) == sorted(want)
    for path, w in want.items():
        assert back[path].dtype == w.dtype
        np.testing.assert_array_equal(back[path], w)


def test_lm_to_arrays_gives_bf16_as_its_bits():
    cfg, _, params, model = _twins("qwen3-0.6b", dtype="bfloat16")
    back = _paths(lm_to_arrays(model))
    for path, w in _paths(jax.tree.map(np.asarray, params)).items():
        assert back[path].dtype == np.uint16
        np.testing.assert_array_equal(back[path], w.view(np.uint16))


def test_expert_mm_backward_equals_widened_product():
    """The bf16 expert product's own derivative (the card has none for
    ``bmm(..., out_dtype=float32)``) against autograd of the product of
    the widened operands: bit for bit."""
    rng = np.random.default_rng(6)
    a = torch.tensor(rng.standard_normal((3, 5, 8)), dtype=torch.bfloat16)
    b = torch.tensor(rng.standard_normal((3, 8, 6)), dtype=torch.bfloat16)
    g = torch.tensor(rng.standard_normal((3, 5, 6)), dtype=torch.float32)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = _expert_mm(a1, b1)
    assert out.dtype == torch.float32
    ga, gb = torch.autograd.grad(out, [a1, b1], g)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = torch.bmm(a2.float(), b2.float())
    wa, wb = torch.autograd.grad(want, [a2, b2], g)
    assert torch.equal(out, want)
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, wa) and torch.equal(gb, wb)


# ------------------------------------------------------------- train step
def _tokens(cfg, rng, shape):
    return {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32),
            "labels": rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32)}


def _train(model, tcfg, batches):
    step = tts.make_train_step(model, tcfg)
    state = tts.train_state_init(model, tcfg)
    out = []
    for b in batches:
        state, metrics = step(state, b)
        out.append(metrics)
    return state, out


def test_microbatched_matches_full_batch():
    cfg, _, _, model = _twins("qwen3-0.6b")
    _, _, _, model2 = _twins("qwen3-0.6b")
    b = _tokens(cfg, np.random.default_rng(3), (4, 16))
    micro = {k: v.reshape(2, 2, 16) for k, v in b.items()}
    s1, (m1,) = _train(model, tts.TrainConfig(microbatches=1, peak_lr=1e-3,
                                              remat=False), [b])
    s2, (m2,) = _train(model2, tts.TrainConfig(microbatches=2, peak_lr=1e-3,
                                               remat=False), [micro])
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    p2 = dict(model2.named_parameters())
    d = max(float((p - p2[k]).detach().abs().max())
            for k, p in model.named_parameters())
    assert d < 5e-3


def test_microbatch_grads_accumulate_in_float32():
    """M = 2 of a bf16 model: the gradient the optimizer sees is the
    float32 sum of the two microbatches' bf16 gradients, halved."""
    cfg, _, _, model = _twins("qwen3-0.6b", dtype="bfloat16")
    b = _tokens(cfg, np.random.default_rng(8), (4, 16))
    micro = {k: v.reshape(2, 2, 16) for k, v in b.items()}
    tcfg = tts.TrainConfig(microbatches=2, remat=False)
    step = tts.make_train_step(model, tcfg)
    state = tts.train_state_init(model, tcfg)
    loss, _, grads = step.grads(state, micro)
    parts = [_port_loss_grads(model, {k: v[i] for k, v in micro.items()})
             for i in range(2)]
    for k, g in grads.items():
        assert g.dtype == torch.float32
        want = (parts[0][2][k].float() + parts[1][2][k].float()) * 0.5
        assert torch.equal(g, want), k
    assert torch.equal(loss, (parts[0][0].detach() + parts[1][0].detach())
                       * 0.5)


def test_five_step_trajectory_matches_reference():
    cfg, jcfg, params, model = _twins("qwen3-0.6b")
    kw = dict(microbatches=1, peak_lr=1e-3, warmup_steps=2, total_steps=50,
              remat=False)
    src = tpipe.make_source(tpipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))
    batches = [src.batch(s) for s in range(5)]
    _, got = _train(model, tts.TrainConfig(**kw), batches)
    jstep = jax.jit(jts.make_train_step(jcfg, jts.TrainConfig(**kw)))
    jstate = jts.train_state_init(params, jts.TrainConfig(**kw))
    for b, m in zip(batches, got):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("compress,bar", [(False, 0.5), (True, 0.3)])
def test_train_step_learns(compress, bar):
    """The reference's learning tests: 15 steps on one batch."""
    cfg, _, _, model = _twins("qwen3-0.6b")
    tcfg = tts.TrainConfig(microbatches=1, peak_lr=5e-3, warmup_steps=2,
                           total_steps=50, compress_grads=compress,
                           remat=False)
    b = _tokens(cfg, np.random.default_rng(5), (4, 32))
    state, ms = _train(model, tcfg, [b] * 15)
    assert (state.err is not None) == compress
    assert float(ms[-1]["loss"]) < float(ms[0]["loss"]) - bar


def test_train_state_init_makes_trainable_and_serving_stays_frozen():
    from repro_torch.models import DecoderLM

    cfg = get_config("qwen3-0.6b").reduced(num_layers=2)
    model = DecoderLM(cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    state = tts.train_state_init(model, tts.TrainConfig(compress_grads=True))
    assert all(p.requires_grad for p in model.parameters())
    names = [k for k, _ in model.named_parameters()]
    assert list(state.opt.m) == list(state.opt.v) == list(state.err) == names
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == 0
    assert all(m.dtype == torch.float32 for m in state.opt.m.values())
    assert not any(p.requires_grad
                   for p in DecoderLM(cfg, device="cpu").parameters())
