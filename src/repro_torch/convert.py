"""Carry DQF state from a reference checkpoint into the port.

:func:`dqf_from_arrays` takes a mapping of numpy arrays under the reference
checkpoint's own keys (``repro.core.DQF.save`` writes them; ``np.load`` of
its ``.npz`` is such a mapping) and returns a port :class:`DQF` that
searches the same store, graph, tenants' hot indexes, tree and quantizer.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.decision_tree import DecisionTree, tree_arrays
from repro_torch.core.dqf import DQF, _to_free_slots
from repro_torch.core.hot_index import HotIndex
from repro_torch.core.ssg import SSGIndex
from repro_torch.core.types import DQFConfig
from repro_torch.store import VectorStore

__all__ = ["dqf_from_arrays"]


def _hot_index(arrays, prefix: str) -> HotIndex:
    ids = np.asarray(arrays[f"{prefix}hot_ids"], np.int32)
    graph = SSGIndex(adj=np.asarray(arrays[f"{prefix}hot_adj"], np.int32),
                     entries=np.asarray(arrays[f"{prefix}hot_entries"],
                                        np.int32),
                     n=int(ids.shape[0]))
    return HotIndex(graph=graph, ids=ids, build_seconds=0.0,
                    version=int(arrays[f"{prefix}hot_version"]))


def dqf_from_arrays(arrays, cfg: DQFConfig | None = None,
                    device=None) -> DQF:
    """A port :class:`DQF` over the state saved under the reference keys:

    * the store: ``x``, ``store_alive``, ``store_ext_ids``,
      ``store_next_ext``, ``store_capacity`` and ``quant_*``
      (``quant_mode``, ``quant_codes``, ``quant_scale``, ``quant_zero``,
      ``quant_centroids``);
    * the graph: ``full_adj``, ``full_entries``;
    * the default tenant: ``counts``, ``counter_since``, ``hot_adj``,
      ``hot_entries``, ``hot_ids``, ``hot_version``;
    * every other tenant, in ``tenant_names`` order: ``tenant{i}_counts``,
      ``tenant{i}_since`` and ``tenant{i}_hot_*``;
    * the tree: ``tree_*``.

    As the reference's ``DQF.load``: saved codes are used only when
    ``cfg.quant`` asks for a quantized index, and then their mode must
    match it.  Missing store keys default as the reference's do.
    """
    dqf = DQF(cfg, device=device)
    store = VectorStore.from_arrays(arrays, registry=dqf.registry)
    if not dqf.cfg.quant.enabled:
        store.drop_quant()
    elif store.quant is None:
        raise ValueError(f"cfg requests quant mode {dqf.cfg.quant.mode!r} "
                         f"but the arrays hold no quantizer")
    elif store.quant.mode != dqf.cfg.quant.mode:
        raise ValueError(f"cfg quant mode {dqf.cfg.quant.mode!r} != "
                         f"saved {store.quant.mode!r}")
    dqf._install(store, _to_free_slots(np.asarray(arrays["full_adj"]),
                                       store.n),
                 np.asarray(arrays["full_entries"], np.int32))
    dqf.counter.counts = np.asarray(arrays["counts"], np.float64).copy()
    if "counter_since" in arrays:
        dqf.counter.since_rebuild = int(arrays["counter_since"])
    if "hot_ids" in arrays:
        dqf.set_hot(_hot_index(arrays, ""))
    if "tenant_names" in arrays:
        for i, name in enumerate(str(s) for s in arrays["tenant_names"]):
            t = dqf.create_tenant(name)
            t.counter.counts = np.asarray(arrays[f"tenant{i}_counts"],
                                          np.float64).copy()
            t.counter.since_rebuild = int(arrays[f"tenant{i}_since"])
            if f"tenant{i}_hot_ids" in arrays:
                t.set_hot(_hot_index(arrays, f"tenant{i}_"))
    if "tree_feature" in arrays:
        dqf.tree = DecisionTree(
            arrays=tree_arrays(arrays["tree_feature"],
                               arrays["tree_threshold"], arrays["tree_left"],
                               arrays["tree_right"], arrays["tree_value"],
                               device=dqf.device),
            depth=int(arrays["tree_depth"]),
            feature_importance=np.asarray(arrays["tree_importance"]))
    return dqf
