"""Carry DQF state from a checkpoint of either package into the port.

:func:`dqf_from_arrays` takes a mapping of numpy arrays under the reference
checkpoint's own keys (``repro.core.DQF.save`` and the port's
:meth:`~repro_torch.core.dqf.DQF.save` write them; ``np.load`` of either
``.npz`` is such a mapping) and returns a port :class:`DQF` that searches
the same store, graph, tenants' hot indexes, tree and quantizer.  It is
the code path of :meth:`DQF.load`, so a checkpoint loads the same way
either way.  :func:`sharded_from_arrays` does the same for a sharded
index, one such mapping a shard, and :func:`lm_from_arrays` carries the
reference decoder LM's parameter tree into a port ``DecoderLM``;
:func:`lm_to_arrays` is its inverse.  :func:`train_state_from_arrays`
carries a training checkpoint of either package (the flat keys that the
reference's ``Checkpointer`` writes, e.g.
``.params['blocks']['dense']['attn']['wq']``, ``.opt.step``,
``.opt.m[...]``, ``.err[...]``) into a port ``TrainState``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dqf import DQF
from repro_torch.core.types import DQFConfig

__all__ = ["dqf_from_arrays", "sharded_from_arrays", "lm_from_arrays",
           "lm_to_arrays", "train_state_from_arrays", "train_state_leaves",
           "train_state_to_arrays", "load_train_state_"]


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


def _tensor(a, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array as a CPU tensor, in ``dtype`` if given.  A bfloat16
    array from JAX (``ml_dtypes``; ``np.load`` of one from an ``.npz``
    gives 2-byte void) is read as bfloat16, and so is a ``uint16`` array
    bound for a bfloat16 tensor: the 16 bits the port stores a bfloat16
    leaf as (:func:`train_state_to_arrays`)."""
    a = np.asarray(a)
    bits = (a.dtype.name == "bfloat16"
            or (a.dtype.kind == "V" and a.dtype.itemsize == 2)
            or (a.dtype == np.uint16 and dtype == torch.bfloat16))
    if bits:
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t if dtype is None else t.to(dtype)


def _host_array(tensors: list, stacked: bool) -> np.ndarray:
    """The tensors (one a layer when ``stacked``) as one numpy array on
    the host, copied leaf by leaf; a bfloat16 leaf as its 16 bits
    (``uint16``), which numpy without ``ml_dtypes`` can hold."""
    t0 = tensors[0]
    store = torch.int16 if t0.dtype == torch.bfloat16 else t0.dtype
    shape = (len(tensors), *t0.shape) if stacked else tuple(t0.shape)
    out = torch.empty(shape, dtype=store)
    with torch.no_grad():
        for j, t in enumerate(tensors):
            (out[j] if stacked else out).copy_(t.detach().view(store))
    a = out.numpy()
    return a.view(np.uint16) if store == torch.int16 else a


def _lm_layout(cfg, names) -> dict[tuple, tuple[list[str], bool]]:
    """The reference's tree path of each port parameter: ``blocks.{i}.
    {leaf}`` is row j of ``("blocks", kind, *leaf)``, the i-th layer
    being the j-th of its kind; ``embed``, ``lm_head`` and
    ``final_norm`` are their own paths.  Path → (port names in stack
    order, stacked)."""
    kinds = cfg.layer_kinds
    out: dict[tuple, tuple[list[str], bool]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "blocks":
            path = ("blocks", kinds[int(parts[1])], *parts[2:])
            out.setdefault(path, ([], True))[0].append(name)
        else:
            out[tuple(parts)] = ([name], False)
    for ns, stacked in out.values():
        if stacked:
            ns.sort(key=lambda n: int(n.split(".")[1]))
    return out


def _keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a dict path: ``['blocks']['dense']``."""
    return "".join(f"['{p}']" for p in path)


def lm_to_arrays(src, cfg=None) -> dict:
    """The inverse of :func:`lm_from_arrays`: a ``DecoderLM``'s parameters,
    or a mapping keyed by its parameter names (its gradients, AdamW's
    ``m`` or ``v``; ``cfg`` then names the model's config), as the
    reference's per-kind stacked tree of numpy arrays
    (``blocks[kind][path]`` of shape ``(n_kind, ...)``).  A bfloat16 leaf
    comes out as its 16 bits (``uint16``; ``.view(ml_dtypes.bfloat16)``
    where that package is installed)."""
    if isinstance(src, torch.nn.Module):
        cfg = src.cfg
        src = dict(src.named_parameters())
    if cfg is None:
        raise ValueError("lm_to_arrays of a mapping needs its cfg")
    tree: dict = {}
    for path, (names, stacked) in _lm_layout(cfg, src).items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _host_array([src[n] for n in names], stacked)
    return tree


def _state_layout(state) -> dict:
    """A ``TrainState``'s checkpoint keys: key → (kind, parameter names
    in stack order, stacked); kind ``param``, ``m``, ``v``, ``err`` or
    ``step``."""
    params = [n for n, _ in state.model.named_parameters()]
    layout = _lm_layout(state.model.cfg, params)
    kinds = [(".params", "param"), (".opt.m", "m"), (".opt.v", "v")]
    if state.err is not None:
        kinds.append((".err", "err"))
    out = {prefix + _keystr(path): (kind, names, stacked)
           for prefix, kind in kinds
           for path, (names, stacked) in layout.items()}
    out[".opt.step"] = ("step", None, False)
    return out


def _state_tensors(state) -> dict:
    return {"param": dict(state.model.named_parameters()),
            "m": state.opt.m, "v": state.opt.v, "err": state.err}


def train_state_leaves(state, whole: dict | None = None
                       ) -> dict[str, tuple[list, bool]]:
    """A port ``TrainState``'s tensors under the reference checkpoint's
    flat keys: key → (tensors, one a layer when stacked).  ``whole``
    (``{kind: {name: tensor}}``, :func:`repro_torch.distributed.
    tensor_parallel.whole_state`) stands for a sharded state's tensors."""
    tensors = whole if whole is not None else _state_tensors(state)
    return {key: (([state.opt.step], False) if kind == "step" else
                  ([tensors[kind][n] for n in names], stacked))
            for key, (kind, names, stacked) in _state_layout(state).items()}


def train_state_to_arrays(state, whole: dict | None = None
                          ) -> dict[str, np.ndarray]:
    """The flat arrays a checkpoint holds (:func:`train_state_leaves`'
    keys), copied to the host; bfloat16 leaves as their 16 bits."""
    return {k: _host_array(ts, stacked)
            for k, (ts, stacked) in train_state_leaves(state, whole).items()}


def _shape_of(flat, key: str) -> tuple:
    """A leaf's shape; from an ``.npz``'s header without reading it."""
    if isinstance(flat, np.lib.npyio.NpzFile):
        with flat.zip.open(key + ".npy") as f:
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            return tuple(read(f)[0])
    return tuple(np.shape(flat[key]))


def load_train_state_(state, flat):
    """Copy a flat checkpoint mapping into ``state`` in place (params,
    ``m``, ``v``, step and, if ``state`` carries one, the error residual),
    every key and shape checked before anything is written; each leaf is
    cast to its tensor's dtype.  A sharded state (tensor parallelism or
    ZeRO-1) takes this rank's block of each whole leaf.  Returns
    ``state``."""
    from repro_torch.distributed import tensor_parallel as tpar

    sharded = tpar.is_sharded(state)
    local = _state_tensors(state)
    layout = _state_layout(state)

    def whole_shape(kind, name):
        t = local[kind][name]
        return (tpar.whole_shape(state, name, kind, t) if sharded
                else tuple(t.shape))

    for key, (kind, names, stacked) in layout.items():
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        if kind == "step":
            want = tuple(state.opt.step.shape)
        else:
            one = whole_shape(kind, names[0])
            want = (len(names), *one) if stacked else one
        got = _shape_of(flat, key)
        if got != want:
            raise ValueError(f"{key}: checkpoint shape {got} != {want}")
    with torch.no_grad():
        for key, (kind, names, stacked) in layout.items():
            if kind == "step":
                state.opt.step.copy_(_tensor(flat[key],
                                             state.opt.step.dtype))
                continue
            ts = [local[kind][n] for n in names]
            src = _tensor(flat[key], ts[0].dtype)
            for j, (n, t) in enumerate(zip(names, ts)):
                leaf = src[j] if stacked else src
                if sharded:
                    leaf = tpar.local_block(state, n, kind, leaf)
                t.copy_(leaf)
    return state


def train_state_from_arrays(flat, cfg, device=None):
    """A port ``TrainState`` (``repro_torch.training``) over a flat
    checkpoint mapping of either package (``np.load`` of its
    ``arrays.npz``): a ``DecoderLM`` of ``cfg`` with the checkpoint's
    parameters, AdamW's ``m``, ``v`` and step, and the error residual
    when the checkpoint holds one (``.err[...]``); on the card unless
    ``device`` says otherwise."""
    from repro_torch.models import DecoderLM
    from repro_torch.training.train_step import TrainConfig, train_state_init

    model = DecoderLM(cfg, seed=None, device=device)
    compress = any(k.startswith(".err") for k in flat)
    state = train_state_init(model, TrainConfig(compress_grads=compress))
    return load_train_state_(state, flat)


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
    match the port's parameters is refused.  :func:`lm_to_arrays` is the
    inverse."""
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
