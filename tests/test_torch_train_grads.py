"""The loss and gradients of the port's ``lm_loss`` against the JAX
package's ``jax.value_and_grad(lm.lm_loss)`` on the CPU, for the dense
configs reduced, in float32 (B = 2, S = 32): the loss and its metrics
within 1e-5 relative, each gradient leaf (the port's gradients stacked
into the reference's tree by ``lm_to_arrays``) within 1e-4 of its largest
|g|; gemma3 keeps its global layer and a window of 16
(``test_torch_models``' depth overrides).  The other five configs are
in ``test_torch_train_grads_kinds.py``.  Then the MoE layer's gradients
in ``test_torch_models``' cases, its int8 dispatch (which no config
turns on) among them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_to_arrays
from repro_torch.models.moe import moe_forward
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_models import MOE_CASES, _tensors
from tests.test_torch_training import (LOSS_REL, _batch, _paths,
                                       _port_loss_grads, _twins,
                                       assert_grads_close)


def _check(cfg, jcfg, params, model):
    batch = _batch(cfg, np.random.default_rng(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, **jb), has_aux=True))(params)
    total, metrics, grads = _port_loss_grads(model, batch)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=LOSS_REL)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=LOSS_REL, atol=1e-7)
    assert_grads_close(lm_to_arrays(grads, cfg), jg)


# the configs whose blocks are attention and an MLP; the other kinds'
# are in test_torch_train_grads_kinds.py (a file each keeps them apart
# under the suite's workers)
DENSE = ("qwen3-0.6b", "yi-34b", "glm4-9b", "musicgen-medium",
         "gemma3-4b")


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    _check(*_twins(arch))


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_grads_match_reference(case):
    """The MoE layer's gradients (to its input and every parameter) on
    the same inputs, ``test_torch_models``' cases: grouped routing,
    dropped tokens and the int8 dispatch, which no config turns on.
    Through the int8 cast JAX's gradient is zero and flows only through
    the rows' float32 scales; the port's is the same.  (In a whole model
    the int8 codes flip where roundoff crosses a ``.5``, so the layer is
    held on identical inputs.)"""
    over, B, S = MOE_CASES[case]
    cfgs = []
    for get in (get_config, j_get_config):
        base = get("deepseek-moe-16b").reduced()
        cfgs.append(dataclasses.replace(
            base, moe=dataclasses.replace(base.moe, **over)))
    cfg, jcfg = cfgs
    jp = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jlm.Initializer(jax.random.PRNGKey(10)), jcfg, jnp.float32))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def jloss(p, a):
        out, aux = jmoe.moe_forward(p, a, jcfg)
        return (jnp.sum(out * w) + 0.01 * aux.load_balance_loss
                + 1e-4 * aux.router_z_loss)

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    tp = _tensors(jp)
    leaves = {}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}.")
            else:
                leaves[prefix + k] = v.requires_grad_()

    flat(tp)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe_forward(tp, tx, cfg)
    loss = (torch.sum(out * torch.tensor(w)) + 0.01 * aux.load_balance_loss
            + 1e-4 * aux.router_z_loss)
    grads = torch.autograd.grad(loss, [tx, *leaves.values()])
    got = {("x",): grads[0].numpy()}
    got.update({tuple(k.split(".")): g.numpy()
                for k, g in zip(leaves, grads[1:])})
    want = {("x",): np.asarray(jg_x)}
    want.update({k: np.asarray(v) for k, v in _paths(jax.tree.map(
        np.asarray, jg_p)).items()})
    assert sorted(got) == sorted(want)
    for k, wv in want.items():
        err = float(np.max(np.abs(got[k] - wv)))
        assert err <= 1e-4 * float(np.max(np.abs(wv))), (k, err)


def test_the_two_files_cover_every_config():
    from tests.test_torch_train_grads_kinds import KINDS

    assert sorted(DENSE + KINDS) == sorted(ARCH_IDS)
