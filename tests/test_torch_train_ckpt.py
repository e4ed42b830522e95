"""The port's checkpointer (``repro_torch.checkpoint``) and
``convert.train_state_from_arrays`` against the JAX package on the CPU:
the round trip bit for bit (params, ``m``, ``v``, step, the error
residual), GC and atomicity, the reference's keys and shapes, refusals,
a failed async save surfacing on ``wait``, and a checkpoint the
reference's ``Checkpointer`` wrote (bf16, compressed gradients) resumed
by the port, whose next step matches JAX's within 1e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.training import train_step as jts
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_to_arrays, train_state_from_arrays
from repro_torch.data import pipeline as tpipe
from repro_torch.training import train_step as tts
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_training import _paths, _tokens, _twins


def _state(arch="qwen3-0.6b", **tkw):
    _, _, _, model = _twins(arch)
    tcfg = tts.TrainConfig(remat=False, **tkw)
    state = tts.train_state_init(model, tcfg)
    b = _tokens(model.cfg, np.random.default_rng(1), (2, 16))
    state, _ = tts.make_train_step(model, tcfg)(state, b)
    return state


def _same_state(a, b):
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert pa.keys() == pb.keys()
    for k in pa:
        for x, y in ((pa[k], pb[k]), (a.opt.m[k], b.opt.m[k]),
                     (a.opt.v[k], b.opt.v[k])):
            assert x.dtype == y.dtype and torch.equal(x, y), k
    assert torch.equal(a.opt.step, b.opt.step)
    if a.err is not None:
        for k in a.err:
            assert torch.equal(a.err[k], b.err[k]), k


def _fresh(state, compress=False):
    from repro_torch.models import DecoderLM

    model = DecoderLM(state.model.cfg, seed=5, device="cpu")
    return tts.train_state_init(model, tts.TrainConfig(
        compress_grads=compress))


def test_checkpoint_roundtrip_and_gc(tmp_path):
    state = _state(compress_grads=True)
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        ck.save(s, state, extra={"data_step": s}, block=True)
    assert latest_step(str(tmp_path)) == 30
    assert not (tmp_path / "step_10").exists()     # GC'd
    assert (tmp_path / "step_20").exists()
    assert ck.last_bytes > 0 and ck.last_save_s >= ck.last_blocked_s > 0
    restored, meta = ck.restore(_fresh(state, compress=True))
    assert meta["data_step"] == 30 and meta["step"] == 30
    assert meta["dtypes"][".opt.step"] == "int32"
    _same_state(state, restored)


def test_checkpoint_atomicity(tmp_path):
    """tmp dirs never count as checkpoints."""
    ck = Checkpointer(str(tmp_path))
    os.makedirs(tmp_path / "tmp.99")               # simulated dead write
    ck.save(5, _state(), block=True)
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "nowhere")) is None
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(_state())


def test_checkpoint_keys_are_the_references(tmp_path):
    """The port's npz keys and shapes are the reference's for the same
    config (the reference's own ``Checkpointer`` of a compressed state)."""
    state = _state(compress_grads=True)
    Checkpointer(str(tmp_path / "port")).save(1, state, block=True)
    jcfg = j_get_config("qwen3-0.6b").reduced()
    jstate = jts.train_state_init(jlm.init_params(jcfg, jax.random.PRNGKey(0)),
                                  jts.TrainConfig(compress_grads=True))
    JCheckpointer(str(tmp_path / "ref")).save(1, jstate, block=True)
    got = np.load(tmp_path / "port" / "step_1" / "arrays.npz")
    want = np.load(tmp_path / "ref" / "step_1" / "arrays.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k


def test_restore_checks_keys_and_shapes(tmp_path):
    state = _state()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state, block=True)
    with pytest.raises(KeyError, match="err"):
        ck.restore(_fresh(state, compress=True))
    _, _, _, other = _twins("qwen3-0.6b", num_layers=3)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(tts.train_state_init(other, tts.TrainConfig()))


def test_async_save_failure_surfaces_on_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    (tmp_path / "tmp.3").write_text("a file where the save makes a dir")
    ck.save(3, state)
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        ck.wait()


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains a bf16 model two steps with compressed
    gradients and saves with its own ``Checkpointer``; the port restores it
    through ``train_state_from_arrays`` (bf16 leaves bit for bit) and its
    step 3 matches JAX's step 3 within 1e-3."""
    arch = "qwen3-0.6b"
    cfg = get_config(arch).reduced(dtype="bfloat16")
    jcfg = j_get_config(arch).reduced(dtype="bfloat16")
    kw = dict(microbatches=1, peak_lr=1e-3, warmup_steps=2, total_steps=20,
              compress_grads=True, remat=False)
    src = tpipe.make_source(tpipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))
    jstep = jax.jit(jts.make_train_step(jcfg, jts.TrainConfig(**kw)))
    jstate = jts.train_state_init(jlm.init_params(jcfg,
                                                  jax.random.PRNGKey(0)),
                                  jts.TrainConfig(**kw))
    for s in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in src.batch(s).items()})
    JCheckpointer(str(tmp_path)).save(2, jstate, block=True)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                for k, v in src.batch(2).items()})

    flat = np.load(tmp_path / "step_2" / "arrays.npz")
    state = train_state_from_arrays(flat, cfg, device="cpu")
    assert int(state.opt.step) == 2 and state.err is not None
    got = _paths(lm_to_arrays(state.model))
    for path, w in got.items():
        want = flat[".params" + "".join(f"['{p}']" for p in path)]
        assert w.dtype == np.uint16
        np.testing.assert_array_equal(w, want.view(np.uint16))
    m = _paths(lm_to_arrays(state.opt.m, cfg))
    for path, w in m.items():
        np.testing.assert_array_equal(
            w, flat[".opt.m" + "".join(f"['{p}']" for p in path)])
    state, metrics = tts.make_train_step(state.model, tts.TrainConfig(**kw))(
        state, src.batch(2))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    assert int(state.opt.step) == 3
