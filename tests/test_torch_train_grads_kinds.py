"""The loss and gradients of the port's ``lm_loss`` against the JAX
package's ``jax.value_and_grad(lm.lm_loss)`` on the CPU, for the configs
with other block kinds (MoE, MLA, hybrid, cross, xLSTM), reduced, in
float32, at the bars of ``test_torch_train_grads.py``.
``test_torch_models``' depth overrides keep every kind: an sLSTM layer
(xlstm), a cross layer with its gate opened to 0.5 (llama-3.2-vision), a
window of 16 (hymba).  The MoE layer's own gradients are in
``test_torch_train_grads.py``."""

import pytest

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train_grads import _check
from tests.test_torch_training import _twins

KINDS = ("deepseek-moe-16b", "deepseek-v2-lite-16b", "hymba-1.5b",
         "llama-3.2-vision-11b", "xlstm-1.3b")


@pytest.mark.parametrize("arch", KINDS)
def test_loss_and_grads_match_reference(arch):
    _check(*_twins(arch))
