"""Carry DQF state from a checkpoint of either package into the port.

:func:`dqf_from_arrays` takes a mapping of numpy arrays under the reference
checkpoint's own keys (``repro.core.DQF.save`` and the port's
:meth:`~repro_torch.core.dqf.DQF.save` write them; ``np.load`` of either
``.npz`` is such a mapping) and returns a port :class:`DQF` that searches
the same store, graph, tenants' hot indexes, tree and quantizer.  It is
the code path of :meth:`DQF.load`, so a checkpoint loads the same way
either way.  :func:`sharded_from_arrays` does the same for a sharded
index, one such mapping a shard, and :func:`lm_from_arrays` carries the
reference decoder LM's parameter tree into a port ``DecoderLM``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dqf import DQF
from repro_torch.core.types import DQFConfig

__all__ = ["dqf_from_arrays", "sharded_from_arrays", "lm_from_arrays"]


def dqf_from_arrays(arrays, cfg: DQFConfig | None = None,
                    device=None) -> DQF:
    """A port :class:`DQF` over the state saved under the reference keys:

    * the store: ``x``, ``store_alive``, ``store_ext_ids``,
      ``store_next_ext``, ``store_capacity`` and ``quant_*``
      (``quant_mode``, ``quant_codes``, ``quant_scale``, ``quant_zero``,
      ``quant_centroids``);
    * the graph: ``full_adj``, ``full_entries``; the ``metric``;
    * the default tenant: ``counts``, ``counter_since``, ``hot_adj``,
      ``hot_entries``, ``hot_ids``, ``hot_version``;
    * every other tenant, in ``tenant_names`` order: ``tenant{i}_counts``,
      ``tenant{i}_since`` and ``tenant{i}_hot_*``;
    * the tree: ``tree_*``.

    As :meth:`DQF.from_arrays` (and the reference's ``DQF.load``): saved
    codes are used only when ``cfg.quant`` asks for a quantized index, and
    a dim, metric or quantizer that does not match ``cfg`` is refused.
    With ``cfg.tier`` enabled the rows and codes go to block files in
    ``cfg.tier.dir`` (else a fresh temp dir) behind device block caches.
    """
    return DQF.from_arrays(arrays, cfg, device=device)


def sharded_from_arrays(per_shard_arrays, owner, tree, cfg: DQFConfig | None,
                        scfg, *, device=None):
    """A port :class:`~repro_torch.sharding.ShardedDQF` over a sharded
    index's saved state: one mapping a shard under the keys above (each
    shard's ``DQF.save`` of a reference ``ShardedDQF``, or the port's
    ``DQF.to_arrays``), the global ext id → shard map (the reference's
    ``_owner``; None derives it from the live rows) and the shared tree
    (a mapping with the ``tree_*`` keys, or None for the one the first
    shard carries).  ``scfg`` is a ``ShardConfig``, a shard count, or None
    for one shard a mapping.  See :meth:`ShardedDQF.from_arrays`."""
    from repro_torch.sharding import ShardedDQF

    return ShardedDQF.from_arrays(per_shard_arrays, cfg, scfg, owner=owner,
                                  tree=tree, device=device)


def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 ones from JAX included) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.uint16)).view(torch.bfloat16)
    return torch.tensor(a)


def lm_from_arrays(params, cfg, device=None):
    """A port :class:`~repro_torch.models.DecoderLM` over the reference's
    parameter tree (``repro.models.lm.init_params``), its leaves numpy
    arrays: ``embed``, ``lm_head`` (absent under ``tie_embeddings``),
    ``final_norm`` and ``blocks[kind][path][i]``, the i-th layer of that
    kind, unstacked onto the port's blocks in layer order: ``ln1``,
    ``ln2``, ``attn.*`` (GQA; MLA's ``wq``, ``w_dkv``, ``kv_norm``,
    ``w_uk``, ``w_uv``, ``wo``; cross's ``wq``, ``wk``, ``wv``, ``wo``,
    the 0-d ``gate``, ``q_norm``, ``k_norm``), ``mlp.*``, ``moe.*`` (the
    router, the ``(E, d, f)`` expert stacks, ``shared.*``), a hybrid
    layer's ``ssm.*`` and an xLSTM layer's ``mix.*``.  Weights keep the
    reference's ``(d_in, d_out)`` layout; each is cast to its parameter's
    dtype, the config's but for the leaves the reference keeps in float32
    (the router, ``ssm.dt_bias``, ``ssm.a_log``, ``ssm.d_skip``,
    ``mix.w_if`` and both ``mix.f_bias``).  A tree whose leaves do not
    match the port's parameters is refused."""
    from repro_torch.models import DecoderLM

    model = DecoderLM(cfg, seed=None, device=device)
    taken: dict[str, int] = {}

    def leaf(tree, path):
        for part in path.split("."):
            tree = tree[part]
        return tree

    def paths(tree, prefix=""):
        if not isinstance(tree, dict):
            return [prefix[:-1]]
        return [p for k in sorted(tree)
                for p in paths(tree[k], f"{prefix}{k}.")]

    with torch.no_grad():
        for name in ("final_norm", "embed", "lm_head"):
            t = getattr(model, name)
            if (t is None) != (name not in params):
                raise ValueError(f"{name}: the tree and the config disagree")
            if t is not None:
                t.copy_(_tensor(params[name]))
        for blk in model.blocks:
            i = taken.get(blk.kind, 0)
            taken[blk.kind] = i + 1
            tree = params["blocks"][blk.kind]
            names = dict(blk.named_parameters())
            if sorted(names) != sorted(paths(tree)):
                raise ValueError(
                    f"{blk.kind} block: the tree holds {sorted(paths(tree))}"
                    f", the port {sorted(names)}")
            for path, t in names.items():
                t.copy_(_tensor(leaf(tree, path)[i]))
    return model
