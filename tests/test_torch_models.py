"""The port's decoder LM (``repro_torch.configs`` and ``repro_torch.models``)
against the JAX package on the CPU.

Configs field for field; the primitives (``rms_norm``, RoPE, the MLP,
``chunked_attention`` at ``tests/test_model_numerics.py``'s shapes, GQA
prefill and ring-buffer decode, the MoE with its aux terms, grouped
routing, int8 dispatch and dropped tokens, MLA prefill and its absorbed
decode over a wrapping ring) within rtol/atol 1e-5 on the same numpy
inputs; whole models (qwen3-0.6b, gemma3-4b with global layers and a
window the replay wraps, musicgen-medium fed embeddings, deepseek-moe-16b,
deepseek-v2-lite-16b, hymba-1.5b with a window the replay wraps,
xlstm-1.3b with its sLSTM layer, llama-3.2-vision-11b with its cross layer
and media) at reduced sizes in float32, the reference's weights carried
by ``lm_from_arrays``: forward with its aux sums, prefill (caches equal,
none for an xLSTM layer in either package) and a 20-step decode replay
with equal argmax ids and logits within 1e-4.  The module tests of the
hybrid, xLSTM and cross blocks are in ``test_torch_blocks.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable_shapes as j_applicable
from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.common import apply_rope as j_apply_rope
from repro.models.common import rms_norm as j_rms_norm
from repro.models.common import rope_angles as j_rope_angles
from repro.models.mlp import mlp_forward as j_mlp_forward
from repro.models import moe as jmoe
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.convert import lm_from_arrays
from repro_torch.models import DecoderLM, layer_runs
from repro_torch.models import attention as tattn
from repro_torch.models.common import apply_rope, rms_norm, rope_angles
from repro_torch.models.mlp import mlp_forward
from repro_torch.models.moe import moe_forward
from tests._torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
# (arch, reduced() overrides): reduced() keeps 4 layers, so gemma3 (a
# global layer every 6th) keeps 6, xlstm (an sLSTM every 8th) 8 and the
# vision config (a cross layer every 5th) 5; gemma3's and hymba's windows
# of 16 wrap in the 20-step replay (64 would not)
LMS = {"qwen3-0.6b": {},
       "gemma3-4b": dict(num_layers=6, window_size=16),
       "musicgen-medium": {},
       "deepseek-moe-16b": {},
       "deepseek-v2-lite-16b": {},
       "hymba-1.5b": dict(window_size=16),
       "xlstm-1.3b": dict(num_layers=8),
       "llama-3.2-vision-11b": dict(num_layers=5)}
CROSS_GATE = 0.5     # the gate starts at 0: a fresh cross layer adds nothing


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_config_equals_reference(arch):
    got, want = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert got.layer_kinds == want.layer_kinds
    assert got.resolved_head_dim == want.resolved_head_dim
    assert (got.active_params(), got.total_params()) == \
        (want.active_params(), want.total_params())
    assert layer_runs(got) == jlm.layer_runs(want)
    assert [s.name for s in applicable_shapes(got)] == \
        [s.name for s in j_applicable(want)]


def test_registry_equals_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


# --------------------------------------------------------------- primitives
@pytest.mark.parametrize("shape", [(3, 5, 16), (2, 7, 4, 32)])
def test_rms_norm_matches_reference(shape):
    rng = np.random.default_rng(0)
    x, w = rand(rng, *shape) * 3.0, rand(rng, shape[-1]) * 0.1
    close(rms_norm(T(x), T(w), 1e-6), j_rms_norm(x, w, 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    pos = np.arange(40, dtype=np.int32)[None, :]
    x = rand(rng, 2, 40, 3, 32)
    sin, cos = rope_angles(T(pos), 32, theta)
    jsin, jcos = j_rope_angles(jnp.asarray(pos), 32, theta)
    close(sin, jsin)
    close(cos, jcos)
    close(apply_rope(T(x), sin, cos), j_apply_rope(x, jsin, jcos))


def test_mlp_forward_matches_reference():
    rng = np.random.default_rng(2)
    p = {"w_gate": rand(rng, 32, 64) * 0.2, "w_up": rand(rng, 32, 64) * 0.2,
         "w_down": rand(rng, 64, 32) * 0.2}
    x = rand(rng, 2, 5, 32)
    close(mlp_forward({k: T(v) for k, v in p.items()}, T(x)),
          j_mlp_forward(p, x))


def _expand(B, H, dk):
    def expand(kvc, j):
        c = kvc.shape[1]
        return (kvc[..., : H * dk].reshape(B, c, H, dk),
                kvc[..., H * dk:].reshape(B, c, H, dk))
    return expand


@pytest.mark.parametrize("S,cq,ck,window", [
    (64, 16, 16, 0), (64, 32, 16, 0), (64, 16, 16, 24), (128, 32, 32, 32),
])
def test_chunked_attention_matches_reference(S, cq, ck, window):
    rng = np.random.default_rng(3)
    B, H, dk = 2, 3, 16
    q, k, v = (rand(rng, B, S, H, dk) for _ in range(3))
    kv_raw = np.concatenate([k.reshape(B, S, -1), v.reshape(B, S, -1)], -1)
    kw = dict(chunk_q=cq, chunk_k=ck, causal=True, window=window)
    got = tattn.chunked_attention(T(q), T(kv_raw), _expand(B, H, dk), **kw)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(kv_raw),
                                   _expand(B, H, dk), **kw)
    close(got, want)


def test_chunked_attention_noncausal_kv_valid_len_matches_reference():
    rng = np.random.default_rng(4)
    B, S, H, dk = 1, 32, 2, 8
    q = rand(rng, B, S, H, dk)
    kv_raw = rand(rng, B, 32, 2 * H * dk)
    kv_raw[:, 24:] = 7.7                      # garbage that must be masked
    kw = dict(chunk_q=16, chunk_k=16, causal=False, kv_valid_len=24)
    got = tattn.chunked_attention(T(q), T(kv_raw), _expand(B, H, dk), **kw)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(kv_raw),
                                   _expand(B, H, dk), **kw)
    close(got, want)


def test_chunked_attention_refuses_indivisible_chunks():
    q = torch.zeros(1, 48, 1, 8)
    with pytest.raises(ValueError, match="not divisible"):
        tattn.chunked_attention(q, torch.zeros(1, 48, 16), _expand(1, 1, 8),
                                chunk_q=32, chunk_k=16, causal=True)


@pytest.mark.parametrize("nq,nk,cq,ck,window,off", [
    (4, 4, 16, 16, 0, 0), (4, 8, 32, 16, 24, 0), (3, 5, 8, 8, 12, 16)])
def test_pair_schedule_equals_reference(nq, nk, cq, ck, window, off):
    kw = dict(cq=cq, ck=ck, causal=True, window=window, q_pos_offset=off)
    for got, want in zip(tattn.make_pair_schedule(nq, nk, **kw),
                         jattn.make_pair_schedule(nq, nk, **kw)):
        np.testing.assert_array_equal(got, want)


def _gqa_world(qk_norm, window):
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              qk_norm=qk_norm, window_size=window)
    jcfg = dataclasses.replace(j_get_config("qwen3-0.6b").reduced(),
                               qk_norm=qk_norm, window_size=window)
    jp = jax.tree.map(np.asarray, jattn.init_gqa_params(
        jlm.Initializer(jax.random.PRNGKey(5)), jcfg, jnp.float32))
    if qk_norm:                    # a non-trivial norm scale
        rng = np.random.default_rng(6)
        jp["q_norm"] = rand(rng, cfg.resolved_head_dim) * 0.2
        jp["k_norm"] = rand(rng, cfg.resolved_head_dim) * 0.2
    return cfg, jcfg, jp, {k: torch.tensor(v) for k, v in jp.items()}


@pytest.mark.parametrize("qk_norm,window", [(True, 0), (False, 24)])
def test_gqa_forward_matches_reference(qk_norm, window):
    cfg, jcfg, jp, tp = _gqa_world(qk_norm, window)
    x = rand(np.random.default_rng(7), 2, 64, cfg.d_model)
    kw = dict(theta=cfg.rope_theta, window=window, chunk_q=16, chunk_k=32,
              return_kv=True)
    out, (k, v) = tattn.gqa_forward(tp, T(x), cfg=cfg, **kw)
    jout, (jk, jv) = jattn.gqa_forward(jp, jnp.asarray(x), cfg=jcfg, **kw)
    close(out, jout)
    close(k, jk)
    close(v, jv)


@pytest.mark.parametrize("window,max_len", [(0, 24), (8, 24)])
def test_gqa_decode_matches_reference(window, max_len):
    """Step by step from empty caches; with a window the ring wraps."""
    cfg, jcfg, jp, tp = _gqa_world(True, window)
    B = 2
    xs = rand(np.random.default_rng(8), 20, B, 1, cfg.d_model)
    cache = tattn.gqa_init_cache(cfg, B, max_len, window, torch.float32,
                                 "cpu")
    jcache = jattn.gqa_init_cache(jcfg, B, max_len, window, jnp.float32)
    step = jax.jit(lambda c, x1, pos: jattn.gqa_decode(
        jp, x1, c, pos, cfg=jcfg, theta=jcfg.rope_theta, window=window))
    for t, x1 in enumerate(xs):
        out, cache = tattn.gqa_decode(tp, T(x1), cache, t, cfg=cfg,
                                      theta=cfg.rope_theta, window=window)
        jout, jcache = step(jcache, jnp.asarray(x1), jnp.int32(t))
        close(out, jout)
    for got, want in zip(cache, jcache):
        close(got, want)


# ---------------------------------------------------------------------- MoE
def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


# (reduced() overrides of the MoE, B, S): deepseek-moe-16b reduced (8
# experts, top-2, 2 shared), DeepSeek-V2's grouped routing, the int8
# dispatch, and a capacity that drops tokens
MOE_CASES = {
    "plain": (dict(), 2, 24),
    "route_groups": (dict(route_groups=2, num_groups=4), 2, 24),
    "quantize_dispatch": (dict(quantize_dispatch=True), 2, 24),
    "drops": (dict(capacity_factor=0.5), 3, 40),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_forward_matches_reference(case):
    over, B, S = MOE_CASES[case]
    cfgs = []
    for get in (get_config, j_get_config):
        base = get("deepseek-moe-16b").reduced()
        cfgs.append(dataclasses.replace(
            base, moe=dataclasses.replace(base.moe, **over)))
    cfg, jcfg = cfgs
    jp = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jlm.Initializer(jax.random.PRNGKey(10)), jcfg, jnp.float32))
    x = rand(np.random.default_rng(11), B, S, cfg.d_model)
    out, aux = moe_forward(_tensors(jp), T(x), cfg)
    jout, jaux = jax.jit(lambda p, a: jmoe.moe_forward(p, a, jcfg))(jp, x)
    close(out, jout)
    for got, want in zip(aux, jaux):
        close(got, want)
    if case == "drops":
        assert float(aux.dropped_fraction) > 0.1


def test_moe_ties_order_as_lax_top_k():
    """Masked groups leave exact zeros that tie; the port's top-k keeps
    ``lax.top_k``'s order (the smaller index first)."""
    from repro_torch.models.moe import _top_k

    rng = np.random.default_rng(12)
    v = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4.0
    v[:, ::3] = 0.0
    got_v, got_i = _top_k(T(v), 6)
    want_v, want_i = jax.lax.top_k(jnp.asarray(v), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------- MLA
def _mla_world():
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    jcfg = j_get_config("deepseek-v2-lite-16b").reduced()
    jp = jax.tree.map(np.asarray, jattn.init_mla_params(
        jlm.Initializer(jax.random.PRNGKey(13)), jcfg, jnp.float32))
    jp["kv_norm"] = rand(np.random.default_rng(14),
                         cfg.mla.kv_lora_rank) * 0.2
    return cfg, jcfg, jp, _tensors(jp)


def test_mla_forward_matches_reference():
    """Chunks smaller than the sequence; values 32 wide against keys of
    48, the scale 48^-0.5."""
    cfg, jcfg, jp, tp = _mla_world()
    x = rand(np.random.default_rng(15), 2, 64, cfg.d_model)
    kw = dict(chunk_q=16, chunk_k=32, return_kv=True)
    out, (c, kr) = tattn.mla_forward(tp, T(x), cfg=cfg, **kw)
    jout, (jc, jkr) = jattn.mla_forward(jp, jnp.asarray(x), cfg=jcfg, **kw)
    close(out, jout)
    close(c, jc)
    close(kr, jkr)


@pytest.mark.parametrize("max_len", [24, 8])
def test_mla_decode_matches_reference(max_len):
    """Step by step from an empty cache; at max_len 8 the ring wraps."""
    cfg, jcfg, jp, tp = _mla_world()
    B = 2
    xs = rand(np.random.default_rng(16), 20, B, 1, cfg.d_model)
    cache = tattn.mla_init_cache(cfg, B, max_len, torch.float32, "cpu")
    jcache = jattn.mla_init_cache(jcfg, B, max_len, jnp.float32)
    step = jax.jit(lambda c, x1, pos: jattn.mla_decode(jp, x1, c, pos,
                                                       cfg=jcfg))
    for t, x1 in enumerate(xs):
        out, cache = tattn.mla_decode(tp, T(x1), cache, t, cfg=cfg)
        jout, jcache = step(jcache, jnp.asarray(x1), jnp.int32(t))
        close(out, jout)
    for got, want in zip(cache, jcache):
        close(got, want)


# ------------------------------------------------------------- whole models
def _lm_twins(arch):
    cfg = get_config(arch).reduced(**LMS[arch])
    jcfg = j_get_config(arch).reduced(**LMS[arch])
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    if "cross" in params["blocks"]:
        attn = params["blocks"]["cross"]["attn"]
        attn["gate"] = jnp.full_like(attn["gate"], CROSS_GATE)
    model = lm_from_arrays(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    return cfg, jcfg, params, model


def _inputs(cfg, rng, B, S):
    """Token ids, or frame embeddings for a model fed embeddings; media
    of ``cfg.vision_tokens`` for a model with cross layers."""
    if cfg.embed_inputs:
        inp = dict(tokens=rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32))
    else:
        inp = dict(embeds=rand(rng, B, S, cfg.d_model))
    if cfg.vision_tokens:
        inp["media"] = rand(rng, B, cfg.vision_tokens, cfg.d_model)
    return inp


def _step_input(inp, t):
    arr = inp["tokens"] if "tokens" in inp else inp["embeds"]
    return arr[:, t:t + 1]


def _leaves(cache):
    """A cache's tensors, nested tuples walked in order (as
    ``jax.tree.leaves`` walks the reference's)."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    return [t for part in cache for t in _leaves(part)]


def _replay(model, jcfg, params, inp, caches, jcaches, steps):
    dec = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, jcfg, t, c, pos))
    for t in range(steps):
        x = _step_input(inp, t)
        logits, caches = model.decode_step(x, caches, t)
        jlogits, jcaches = dec(params, jnp.asarray(x), jcaches, jnp.int32(t))
        close_logits(logits, jlogits)


def close_logits(got: torch.Tensor, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("arch", sorted(LMS))
def test_lm_forward_prefill_decode_match_reference(arch):
    cfg, jcfg, params, model = _lm_twins(arch)
    assert [b.kind for b in model.blocks] == list(cfg.layer_kinds)
    B, S, steps = 2, 40, 20
    inp = _inputs(cfg, np.random.default_rng(9), B, S)
    jinp = {k: jnp.asarray(v) for k, v in inp.items()}
    # one JAX call gives forward's logits and prefill's caches (prefill is
    # forward with the caches, its logits the last position's)
    want, jaux, jcaches = jax.jit(lambda p, a: jlm.forward(
        p, jcfg, want_caches=True, **a))(params, jinp)
    logits, aux = model(**inp, want_aux=True)
    close_logits(logits, want)
    close(aux, jaux)

    logits, caches = model.prefill(**inp)
    close_logits(logits, want[:, -1:])
    for (blk, i), cache in zip(_kind_index(model), caches):
        if blk.kind in ("mlstm", "slstm"):       # no prefill state in either
            assert cache is None and blk.kind not in jcaches
            continue
        got, wanted = _leaves(cache), jax.tree.leaves(jcaches[blk.kind])
        assert len(got) == len(wanted)
        for got_leaf, want_leaf in zip(got, wanted):
            close(got_leaf, want_leaf[i])
    prefilled = caches, jcaches

    caches = model.init_decode_caches(B, max_len=32)
    jcaches = jlm.init_decode_caches(jcfg, B, max_len=32)
    for (blk, _), cache in zip(_kind_index(model), caches):
        assert [tuple(t.shape) for t in _leaves(cache)] == [
            w.shape[1:] for w in jax.tree.leaves(jcaches[blk.kind])]
    _replay(model, jcfg, params, inp, caches, jcaches, steps)
    if cfg.vision_tokens:
        # the cross layers' media K/V from each package's prefill
        caches = model.init_decode_caches(B, max_len=32)
        jcaches = jlm.init_decode_caches(jcfg, B, max_len=32)
        for i, blk in enumerate(model.blocks):
            if blk.kind == "cross":
                caches[i] = prefilled[0][i]
        jcaches["cross"] = prefilled[1]["cross"]
        _replay(model, jcfg, params, inp, caches, jcaches, steps)


def _kind_index(model):
    """(block, its index among its kind's layers), in layer order: the
    reference's per-kind stacks index their layers so."""
    seen: dict = {}
    for blk in model.blocks:
        seen[blk.kind] = seen.get(blk.kind, -1) + 1
        yield blk, seen[blk.kind]


def test_prefill_matches_decode_qwen():
    """The reference's own check on the port: decoding S+1 tokens one by
    one ≡ forward over them (last logits), at its tolerance."""
    cfg = get_config("qwen3-0.6b").reduced()
    model = DecoderLM(cfg, seed=0, device="cpu")
    B, S = 2, 16
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    want = model(tok)[:, -1]
    caches = model.init_decode_caches(B, max_len=S + 8)
    for t in range(S + 1):
        logits, caches = model.decode_step(tok[:, t:t + 1], caches, t)
    np.testing.assert_allclose(logits[:, 0].numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_port_init_is_seeded_and_at_reference_scale():
    cfg = get_config("qwen3-0.6b").reduced()
    a, b = (DecoderLM(cfg, seed=3, device="cpu") for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert not a.blocks[0].attn["wq"].requires_grad
    std = float(a.blocks[0].attn["wq"].std())
    assert abs(std - cfg.d_model ** -0.5 * 0.9866) < 0.01   # 3σ truncation
    assert float(a.embed.abs().max()) <= 3 * cfg.d_model ** -0.5 + 1e-6
    assert a.lm_head is None and a.head is a.embed       # tied embeddings


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_every_config_builds_and_serves(arch):
    """Every config builds at full size (parameters on the meta device,
    its kinds in layer order) and serves at its reduced size: a forward,
    a prefill and two decode steps, all finite."""
    cfg = get_config(arch)
    full = DecoderLM(cfg, seed=None, device="meta")
    assert [b.kind for b in full.blocks] == list(cfg.layer_kinds)
    cfg = cfg.reduced(num_layers=max(cfg.cross_attn_every,
                                     cfg.xlstm_slstm_every, 2))
    model = DecoderLM(cfg, seed=0, device="cpu")
    assert set(b.kind for b in model.blocks) == set(cfg.layer_kinds)
    inp = _inputs(cfg, np.random.default_rng(3), 2, 8)
    logits, caches = model.prefill(**inp)
    assert logits.shape == (2, 1, cfg.vocab_size)
    caches = model.init_decode_caches(2, 8)
    for t in range(2):
        step, caches = model.decode_step(_step_input(inp, t), caches, t)
        assert bool(torch.isfinite(step).all())
    assert bool(torch.isfinite(logits).all())


def test_lm_from_arrays_carries_bf16_weights_bit_for_bit():
    """A bf16 tree (the production dtype) lands unchanged."""
    arch = "qwen3-0.6b"
    cfg = get_config(arch).reduced(num_layers=2, dtype="bfloat16")
    jcfg = j_get_config(arch).reduced(num_layers=2, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(1)))
    model = lm_from_arrays(tree, cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    want = tree["blocks"]["dense"]["attn"]["wq"][1].view(np.uint16)
    got = model.blocks[1].attn["wq"].view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want)
    np.testing.assert_array_equal(
        model.embed.view(torch.int16).numpy().view(np.uint16),
        tree["embed"].view(np.uint16))


def test_lm_from_arrays_carries_moe_and_mla_leaves_bit_for_bit():
    """deepseek-v2-lite in bf16: the float32 router, the bf16 expert
    stacks (one layer of the (n, E, d, f) stack each), the MLA leaves; the
    dense layer is ``dense_layer_ff`` wide (384 here, ``d_ff`` 256)."""
    arch = "deepseek-v2-lite-16b"
    over = dict(dtype="bfloat16", dense_layer_ff=384)
    cfg = get_config(arch).reduced(**over)
    jcfg = j_get_config(arch).reduced(**over)
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(2)))
    model = lm_from_arrays(tree, cfg, device="cpu")
    dense, moe = model.blocks[0], model.blocks[2]
    assert (dense.kind, moe.kind) == ("dense", "moe")
    assert dense.mlp["w_gate"].shape == (cfg.d_model, cfg.dense_layer_ff)
    assert cfg.dense_layer_ff != cfg.d_ff
    jm = tree["blocks"]["moe"]["moe"]
    assert moe.moe["router"].dtype == torch.float32
    np.testing.assert_array_equal(moe.moe["router"].numpy(), jm["router"][1])

    def bits(t):
        return t.view(torch.int16).numpy().view(np.uint16)

    for name in ("w_gate", "w_up", "w_down"):
        assert moe.moe[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(moe.moe[name]),
                                      jm[name][1].view(np.uint16))
    np.testing.assert_array_equal(bits(moe.moe["shared"]["w_up"]),
                                  jm["shared"]["w_up"][1].view(np.uint16))
    ja = tree["blocks"]["moe"]["attn"]
    for name in ("wq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"):
        np.testing.assert_array_equal(bits(moe.attn[name]),
                                      ja[name][1].view(np.uint16))


# the leaves the reference keeps in float32 in a bf16 model
FLOAT32_LEAVES = {"hymba-1.5b": {"ssm.dt_bias", "ssm.a_log", "ssm.d_skip"},
                  "xlstm-1.3b": {"mix.w_if", "mix.f_bias"},
                  "llama-3.2-vision-11b": set()}


@pytest.mark.parametrize("arch", sorted(FLOAT32_LEAVES))
def test_lm_from_arrays_carries_the_new_kinds_bit_for_bit(arch):
    """bf16 trees of the hybrid, xLSTM (both kinds) and cross blocks:
    every leaf of every layer lands with its bits and its dtype, the
    float32 ones float32, the cross ``gate`` 0-d."""
    cfg = get_config(arch).reduced(dtype="bfloat16", **LMS[arch])
    jcfg = j_get_config(arch).reduced(dtype="bfloat16", **LMS[arch])
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(4)))
    if "cross" in tree["blocks"]:
        gate = tree["blocks"]["cross"]["attn"]["gate"]
        tree["blocks"]["cross"]["attn"]["gate"] = np.full_like(gate, 0.5)
    model = lm_from_arrays(tree, cfg, device="cpu")
    f32 = set()
    for blk, i in _kind_index(model):
        for path, t in blk.named_parameters():
            want = tree["blocks"][blk.kind]
            for part in path.split("."):
                want = want[part]
            want = want[i]
            assert tuple(t.shape) == want.shape, path
            if want.dtype == np.float32:
                f32.add(path)
                assert t.dtype == torch.float32, path
                np.testing.assert_array_equal(t.numpy(), want)
            else:
                assert t.dtype == torch.bfloat16, path
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy().view(np.uint16),
                    want.view(np.uint16))
    assert f32 == FLOAT32_LEAVES[arch]


def test_lm_from_arrays_refuses_a_foreign_tree():
    cfg = get_config("qwen3-0.6b").reduced()
    jcfg = dataclasses.replace(j_get_config("qwen3-0.6b").reduced(),
                               qk_norm=False)
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="q_norm"):
        lm_from_arrays(tree, cfg, device="cpu")
