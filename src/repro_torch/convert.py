"""Carry DQF state from a reference checkpoint into the port.

:func:`dqf_from_arrays` takes a mapping of numpy arrays under the reference
checkpoint's own keys (``repro.core.DQF.save`` writes them; ``np.load`` of
its ``.npz`` is such a mapping) and returns a port :class:`DQF` that
searches the same graph, hot index, tree and quantizer.  Only the
default tenant is carried; the port's other slices add the rest.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.decision_tree import DecisionTree, tree_arrays
from repro_torch.core.dqf import DQF, _to_free_slots
from repro_torch.core.hot_index import HotIndex
from repro_torch.core.ssg import SSGIndex
from repro_torch.core.types import DQFConfig
from repro_torch.quant import QuantState

__all__ = ["dqf_from_arrays"]


def dqf_from_arrays(arrays, cfg: DQFConfig | None = None,
                    device=None) -> DQF:
    """A port :class:`DQF` over the state saved under the reference keys
    ``x``, ``store_alive``, ``store_capacity``, ``full_adj``,
    ``full_entries``, ``counts``, ``counter_since``, ``hot_adj``,
    ``hot_entries``, ``hot_ids``, ``hot_version``, ``tree_*`` and
    ``quant_*`` (``quant_mode``, ``quant_codes``, ``quant_scale``,
    ``quant_zero``, ``quant_centroids``).

    As the reference's ``DQF.load``: saved codes are used only when
    ``cfg.quant`` asks for a quantized index, and then their mode must
    match it.
    """
    has = lambda key: key in arrays
    dqf = DQF(cfg, device=device)
    x = np.ascontiguousarray(arrays["x"], np.float32)
    n = x.shape[0]
    alive = (np.asarray(arrays["store_alive"], bool) if has("store_alive")
             else np.ones(n, bool))
    capacity = int(arrays["store_capacity"]) if has("store_capacity") else n
    quant = None
    if dqf.cfg.quant.enabled:
        quant = QuantState.from_arrays(arrays)
        if quant is None:
            raise ValueError(f"cfg requests quant mode "
                             f"{dqf.cfg.quant.mode!r} but the arrays hold "
                             f"no quantizer")
        if quant.mode != dqf.cfg.quant.mode:
            raise ValueError(f"cfg quant mode {dqf.cfg.quant.mode!r} != "
                             f"saved {quant.mode!r}")
    dqf._install(x, alive, capacity,
                 _to_free_slots(np.asarray(arrays["full_adj"]), n),
                 np.asarray(arrays["full_entries"], np.int32), quant)
    dqf.counter.counts = np.asarray(arrays["counts"], np.float64).copy()
    if has("counter_since"):
        dqf.counter.since_rebuild = int(arrays["counter_since"])
    if has("hot_ids"):
        hot_ids = np.asarray(arrays["hot_ids"], np.int32)
        graph = SSGIndex(adj=np.asarray(arrays["hot_adj"], np.int32),
                         entries=np.asarray(arrays["hot_entries"], np.int32),
                         n=int(hot_ids.shape[0]))
        dqf.set_hot(HotIndex(graph=graph, ids=hot_ids, build_seconds=0.0,
                             version=int(arrays["hot_version"])))
    if has("tree_feature"):
        dqf.tree = DecisionTree(
            arrays=tree_arrays(arrays["tree_feature"],
                               arrays["tree_threshold"], arrays["tree_left"],
                               arrays["tree_right"], arrays["tree_value"],
                               device=dqf.device),
            depth=int(arrays["tree_depth"]),
            feature_importance=np.asarray(arrays["tree_importance"]))
    return dqf
