"""The port's remaining block kinds against the JAX package on the CPU.

``repro_torch.models.ssm`` (the SSD core, the Mamba branch),
``repro_torch.models.xlstm`` (mLSTM, sLSTM) and the cross-attention of
``repro_torch.models.attention``, each on the same seeded numpy inputs
and weights as its reference, within rtol/atol 1e-5: forward, the final
state, and decode from that state or from an empty one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.models.common import Initializer
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from tests._torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor
TOL = dict(rtol=1e-5, atol=1e-5)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def tensors(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def cfgs(arch, **over):
    return get_config(arch).reduced(**over), j_get_config(arch).reduced(
        **over)


def jparams(init, jcfg, seed, **nonzero):
    """A reference block's float32 weights as numpy, with the named
    leaves (zeros or ones at init) replaced by seeded values."""
    p = jax.tree.map(np.asarray, init(Initializer(jax.random.PRNGKey(seed)),
                                      jcfg, jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for name, scale in nonzero.items():
        p[name] = (rand(rng, *p[name].shape) * scale).astype(np.float32)
    return p


# ------------------------------------------------------------------ the SSD
def ssd_inputs(rng, B, S, H, P, N):
    return (rand(rng, B, S, H, P),
            rng.uniform(0.1, 1.0, (B, S, H)).astype(np.float32),
            -rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32),
            rand(rng, B, S, H, N), rand(rng, B, S, H, N))


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (48, 48)])
def test_ssd_chunked_matches_reference(S, chunk):
    """``tests/test_model_numerics.py``'s shapes, the final state too."""
    ins = ssd_inputs(np.random.default_rng(0), 2, S, 3, 8, 4)
    y, h = tssm.ssd_chunked(*map(T, ins), chunk=chunk, return_state=True)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk,
                              return_state=True)
    close(y, jy)
    close(h, jh)


def _ssd_scan64(x, dt, log_a, Bm, Cm):
    """The SSD recurrence step by step in float64: h_t = a_t h_{t-1} +
    dt_t B_t x_tᵀ, y_t = C_t · h_t (no decay is ever exponentiated
    above 0)."""
    x, dt, log_a, Bm, Cm = (t.double() for t in (x, dt, log_a, Bm, Cm))
    B, S, H, P = x.shape
    h = torch.zeros(B, H, Bm.shape[-1], P, dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(log_a[:, t])[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bm[:, t] * dt[:, t, :, None], x[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1)


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """A 256-token chunk whose summed log decay passes ~88 (Hymba's dt of
    ~0.7 a step at A = -1): the forward within 1e-5 of its max of the
    reference's and of the float64 recurrence's (256-term float32 sums),
    and the gradient of every input finite and within 1e-5 of its max of
    the float64 recurrence's, where the reference's expression turns
    NaN (``where``'s masked branch passes 0 · exp(decay) = 0 · inf back;
    the port masks the decay before its exp too)."""
    rng = np.random.default_rng(3)
    x, dt, _, Bm, Cm = ssd_inputs(rng, 1, 256, 2, 4, 3)
    log_a = -rng.uniform(0.5, 1.0, dt.shape).astype(np.float32)
    ins = (x, dt, log_a, Bm, Cm)
    w = rand(rng, *x.shape)
    ts = [T(a).requires_grad_(True) for a in ins]
    y = tssm.ssd_chunked(*ts, chunk=256)
    ts64 = [T(a).double().requires_grad_(True) for a in ins]
    y64 = _ssd_scan64(*ts64)
    jy = np.asarray(jssm.ssd_chunked(*map(jnp.asarray, ins), chunk=256))
    for ref in (jy, y64.detach().numpy()):
        err = float(np.max(np.abs(y.detach().numpy() - ref)))
        assert err <= 1e-5 * float(np.max(np.abs(ref))), err
    grads = torch.autograd.grad((y * T(w)).sum(), ts)
    want = torch.autograd.grad((y64 * T(w).double()).sum(), ts64)
    for g, g64 in zip(grads, want):
        assert torch.isfinite(g).all()
        err = float((g.double() - g64).abs().max())
        assert err <= 1e-5 * float(g64.abs().max()), err
    jgrads = jax.grad(lambda *a: jnp.sum(jssm.ssd_chunked(
        *a, chunk=256) * w), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, ins))
    assert np.isnan(np.asarray(jgrads[2])).any()   # the reference's


def test_ssd_decode_step_replays_chunked():
    """Step by step from zeros ≡ the reference's steps ≡ the chunked form
    (last output and final state), with a nonzero initial state too."""
    B, S, H, P, N = 2, 24, 2, 4, 4
    rng = np.random.default_rng(1)
    ins = ssd_inputs(rng, B, S, H, P, N)
    h0 = rand(rng, B, H, N, P)
    full, h_full = tssm.ssd_chunked(*map(T, ins), chunk=8,
                                    initial_state=T(h0), return_state=True)
    jfull, jh_full = jssm.ssd_chunked(*map(jnp.asarray, ins), chunk=8,
                                      initial_state=jnp.asarray(h0),
                                      return_state=True)
    close(full, jfull)
    close(h_full, jh_full)
    h, jh = T(h0), jnp.asarray(h0)
    for t in range(S):
        step = [a[:, t] for a in ins]
        y, h = tssm.ssd_decode_step(h, *map(T, step))
        jy, jh = jssm.ssd_decode_step(jh, *map(jnp.asarray, step))
        close(y, jy)
        close(y, full[:, t], dict(rtol=1e-4, atol=1e-4))
    close(h, jh)
    close(h, h_full, dict(rtol=1e-4, atol=1e-4))


def test_ssd_chunked_refuses_an_indivisible_chunk():
    ins = ssd_inputs(np.random.default_rng(2), 1, 40, 1, 2, 2)
    with pytest.raises(ValueError, match="not divisible by chunk=16"):
        tssm.ssd_chunked(*map(T, ins), chunk=16)


# ---------------------------------------------------------------- the Mamba
def test_mamba_forward_state_and_decode_match_reference():
    """Prefill of 32 with its state (conv tail + SSD state, chunk 8), then
    8 decode steps from that state."""
    cfg, jcfg = cfgs("hymba-1.5b")
    jp = jparams(jssm.init_mamba_params, jcfg, 3, dt_bias=0.5, a_log=0.5,
                 d_skip=1.0, out_norm=0.2)
    tp = tensors(jp)
    rng = np.random.default_rng(4)
    x, xs = rand(rng, 2, 32, cfg.d_model), rand(rng, 8, 2, 1, cfg.d_model)
    out, cache = tssm.mamba_forward(tp, T(x), cfg=cfg, chunk=8,
                                    return_state=True)
    jout, jcache = jssm.mamba_forward(jp, jnp.asarray(x), cfg=jcfg, chunk=8,
                                      return_state=True)
    close(out, jout)
    close(cache.conv, jcache.conv)
    close(cache.state, jcache.state)
    step = jax.jit(lambda c, x1: jssm.mamba_decode(jp, x1, c, cfg=jcfg))
    for x1 in xs:
        out, cache = tssm.mamba_decode(tp, T(x1), cache, cfg=cfg)
        jout, jcache = step(jcache, jnp.asarray(x1))
        close(out, jout)
    close(cache.state, jcache.state)
    fresh = tssm.mamba_init_cache(cfg, 2, torch.float32, "cpu")
    for got, want in zip(fresh, jssm.mamba_init_cache(jcfg, 2, jnp.float32)):
        assert got.shape == want.shape and got.dtype == torch.float32


# ---------------------------------------------------------------- the xLSTM
def test_mlstm_forward_and_decode_match_reference():
    """Forward over 32 (chunk 8); decode 12 steps from an empty memory,
    and against the forward's outputs."""
    cfg, jcfg = cfgs("xlstm-1.3b")
    jp = jparams(jxl.init_mlstm_params, jcfg, 5, out_norm=0.2)
    tp = tensors(jp)
    assert tp["w_if"].dtype == torch.float32
    x = rand(np.random.default_rng(6), 2, 32, cfg.d_model)
    out = txl.mlstm_forward(tp, T(x), cfg=cfg, chunk=8)
    close(out, jxl.mlstm_forward(jp, jnp.asarray(x), cfg=jcfg, chunk=8))
    cache = txl.mlstm_init_cache(cfg, 2, "cpu")
    jcache = jxl.mlstm_init_cache(jcfg, 2)
    step = jax.jit(lambda c, x1: jxl.mlstm_decode(jp, x1, c, cfg=jcfg))
    for t in range(12):
        y, cache = txl.mlstm_decode(tp, T(x[:, t:t + 1]), cache, cfg=cfg)
        jy, jcache = step(jcache, jnp.asarray(x[:, t:t + 1]))
        close(y, jy)
        close(y, out[:, t:t + 1], dict(rtol=1e-4, atol=1e-4))
    close(cache.state, jcache.state)


def slstm_world(seed):
    cfg, jcfg = cfgs("xlstm-1.3b")
    jp = jparams(jxl.init_slstm_params, jcfg, seed, f_bias=1.0,
                 out_norm=0.2)
    return cfg, jcfg, jp, tensors(jp)


def test_slstm_forward_and_decode_match_reference():
    """Forward over 20 steps of the recurrence; decode 20 steps from the
    stabiliser's -1e30 start, each ≡ the reference's and the forward's."""
    cfg, jcfg, jp, tp = slstm_world(7)
    assert tp["f_bias"].dtype == torch.float32
    x = rand(np.random.default_rng(8), 2, 20, cfg.d_model)
    out = txl.slstm_forward(tp, T(x), cfg=cfg)
    close(out, jxl.slstm_forward(jp, jnp.asarray(x), cfg=jcfg))
    cache = txl.slstm_init_cache(cfg, 2, "cpu")
    jcache = jxl.slstm_init_cache(jcfg, 2)
    for got, want in zip(cache, jcache):
        close(got, want)
    step = jax.jit(lambda c, x1: jxl.slstm_decode(jp, x1, c, cfg=jcfg))
    for t in range(20):
        y, cache = txl.slstm_decode(tp, T(x[:, t:t + 1]), cache, cfg=cfg)
        jy, jcache = step(jcache, jnp.asarray(x[:, t:t + 1]))
        close(y, jy)
        close(y, out[:, t:t + 1])
    for got, want in zip(cache, jcache):
        close(got, want)


def test_slstm_mlp_is_the_tanh_gelu():
    """``jax.nn.gelu`` defaults to the tanh form: exact GELU (torch's
    default) in the post-block MLP fails the 1e-5 these tests hold."""
    cfg, jcfg, jp, tp = slstm_world(9)
    tp["w_ff1"] = tp["w_ff1"] * 8.0          # push the GELU off its origin
    jp["w_ff1"] = jp["w_ff1"] * 8.0
    x = rand(np.random.default_rng(10), 2, 6, cfg.d_model)
    want = np.asarray(jxl.slstm_forward(jp, jnp.asarray(x), cfg=jcfg))
    close(txl.slstm_forward(tp, T(x), cfg=cfg), want)
    gelu = torch.nn.functional.gelu
    exact = lambda a, approximate="none": gelu(a)            # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(txl.F, "gelu", exact)
        wrong = txl.slstm_forward(tp, T(x), cfg=cfg).numpy()
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        close(wrong, want)


# ---------------------------------------------------------- cross-attention
def cross_world(dtype=jnp.float32, seed=11):
    """The vision config's cross layer, its gate and norms nonzero (the
    gate starts at 0, so a fresh layer adds nothing)."""
    cfg, jcfg = cfgs("llama-3.2-vision-11b")
    p = jattn.init_cross_params(Initializer(jax.random.PRNGKey(seed)), jcfg,
                                jnp.float32)
    rng = np.random.default_rng(seed + 1)
    hd = cfg.resolved_head_dim
    p.update(gate=jnp.float32(0.5), q_norm=rand(rng, hd) * 0.2,
             k_norm=rand(rng, hd) * 0.2)
    jp = jax.tree.map(lambda a: np.asarray(a, dtype), p)
    tp = {k: torch.tensor(np.asarray(v.astype(np.float32)))
          for k, v in jp.items()}
    if dtype != jnp.float32:
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    return cfg, jcfg, jp, tp


def test_cross_forward_and_decode_match_reference():
    """T = 20 media tokens, padded to a chunk of 32 and masked by
    ``kv_valid_len``; queries in 2 chunks of 16; decode over the media's
    K/V from ``_cross_kv``."""
    cfg, jcfg, jp, tp = cross_world()
    rng = np.random.default_rng(12)
    x, media = rand(rng, 2, 32, cfg.d_model), rand(rng, 2, 20, cfg.d_model)
    out = tattn.cross_forward(tp, T(x), T(media), cfg=cfg, chunk_q=16)
    want = jattn.cross_forward(jp, jnp.asarray(x), jnp.asarray(media),
                               cfg=jcfg, chunk_q=16)
    close(out, want)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2      # gate open
    k, v = tattn._cross_kv(tp, T(media), cfg)
    jk, jv = jattn._cross_kv(jp, jnp.asarray(media), jcfg)
    close(k, jk)
    close(v, jv)
    for t in (0, 17):
        x1 = x[:, t:t + 1]
        got = tattn.cross_decode(tp, T(x1), k, v, cfg=cfg)
        close(got, jattn.cross_decode(jp, jnp.asarray(x1), jk, jv,
                                      cfg=jcfg))
        close(got, out[:, t:t + 1])


def test_cross_bf16_weights_float32_media_promote_as_jax():
    """bf16 weights against float32 media: JAX's K/V come out float32,
    and so do the port's, within the same tolerance; the layer's output is
    the queries' bf16."""
    cfg, jcfg, jp, tp = cross_world(jnp.bfloat16)
    rng = np.random.default_rng(13)
    media = rand(rng, 2, 20, cfg.d_model)
    x = rand(rng, 2, 16, cfg.d_model).astype(jnp.bfloat16)
    k, v = tattn._cross_kv(tp, T(media), cfg)
    jk, jv = jattn._cross_kv(jp, jnp.asarray(media), jcfg)
    assert (k.dtype, v.dtype) == (torch.float32, torch.float32)
    assert (jk.dtype, jv.dtype) == (jnp.float32, jnp.float32)
    close(k, jk)
    close(v, jv)
    xt = torch.tensor(np.asarray(x.astype(np.float32))).to(torch.bfloat16)
    out = tattn.cross_forward(tp, xt, T(media), cfg=cfg)
    jout = jattn.cross_forward(jp, jnp.asarray(x), jnp.asarray(media),
                               cfg=jcfg)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    # bf16 outputs: one rounding of the float32 result apart at most
    close(out, jout.astype(jnp.float32), dict(rtol=1e-2, atol=1e-2))
