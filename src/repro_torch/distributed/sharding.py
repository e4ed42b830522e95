"""Parameter/activation sharding rules (DP × TP × EP × ZeRO-1), the port's
copy of ``repro/distributed/sharding.py``.

Rules map parameter-tree paths to specs over the production mesh axes
(``pod``, ``data``, ``model``):

* TP ("model"): attention head dims, FFN hidden dims, vocab dim, MoE expert
  axis (expert parallelism), xLSTM/SSM inner dims;
* DP ("pod" + "data"): the batch axis of activations; gradients all-reduce
  over it (pods only see gradient traffic);
* ZeRO-1: optimizer moments additionally shard their largest replicated
  axis over "data";
* anything whose dim is not divisible by the axis size falls back to
  replication on that axis (checked per leaf, so e.g. hymba's vocab 32001
  replicates while its d_model shards).

A spec is a plain tuple with one entry a dim, as a reference
``PartitionSpec``: None (replicated), an axis name, or a tuple of axis
names.  The rules read the reference's tree paths (``['blocks']['dense']
['attn']['wq']``, leaves stacked a layer kind); :func:`param_shapes` and
:func:`cache_shapes` lay a port ``DecoderLM``'s parameters and decode
caches out under those paths with the stacked shapes, through the key
map of :func:`repro_torch.convert.lm_to_arrays`, so the rules below are
the reference's verbatim.  Trees are flat dicts ``{path: shape}`` and
the specs ``{path: spec}``.

A mesh is anything with ``axis_names`` and ``shape`` (a dict of axis
sizes): a :class:`repro_torch.distributed.mesh.Mesh` or a stand-in.
:func:`shard_tensor` and :func:`gather_tensor` move one tensor between
its whole and this rank's block of a spec on a ``Mesh``; a leaf that puts
several roles side by side on its model-cut dim (``ssm.w_in``'s [x |
gate], mLSTM's ``w_up`` [value | gate], sLSTM's ``w_gates`` [i f z o])
is cut role by role (``parts``), a departure from the reference's
contiguous cut that keeps each of a rank's channels beside its gate.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import torch

__all__ = ["param_specs", "param_shapes", "cache_shapes", "cache_specs",
           "zero1_specs", "batch_spec", "activation_spec", "data_size",
           "shard_tensor", "gather_tensor", "MODEL_AXIS", "DATA_AXES"]

MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")   # pod may be absent from the mesh


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _data_axes(mesh):
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def _fits(dim: int, mesh, axis: Optional[str]) -> bool:
    if axis is None:
        return True
    return dim % _axis_size(mesh, axis) == 0


# Ordered (path regex, axis-per-dim template) rules.  Templates are applied
# right-aligned to the leaf shape (layer-stack leading axes stay None) and
# each entry is divisibility-checked.  "model" on a dim means TP there.
_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    (r"\bembed\b", ("model", None)),
    (r"\blm_head\b", ("model", None)),
    # attention
    (r"attn.*\bwq\b", (None, "model")),
    (r"attn.*\bwk\b", (None, "model")),
    (r"attn.*\bwv\b", (None, "model")),
    (r"attn.*\bwo\b", ("model", None)),
    (r"attn.*\bw_dkv\b", (None, None)),
    (r"attn.*\bw_uk\b", (None, "model")),
    (r"attn.*\bw_uv\b", (None, "model")),
    # dense mlp
    (r"mlp.*\bw_gate\b", (None, "model")),
    (r"mlp.*\bw_up\b", (None, "model")),
    (r"mlp.*\bw_down\b", ("model", None)),
    # moe: expert parallelism over the expert axis
    (r"moe.*\brouter\b", (None, None)),
    (r"moe.*shared.*\bw_gate\b", (None, "model")),
    (r"moe.*shared.*\bw_up\b", (None, "model")),
    (r"moe.*shared.*\bw_down\b", ("model", None)),
    (r"moe.*\bw_gate\b", ("model", None, None)),
    (r"moe.*\bw_up\b", ("model", None, None)),
    (r"moe.*\bw_down\b", ("model", None, None)),
    # mamba branch
    (r"ssm.*\bw_in\b", (None, "model")),
    (r"ssm.*\bconv\b", (None, "model")),
    (r"ssm.*\bw_bc\b", ("model", None)),
    (r"ssm.*\bw_dt\b", ("model", None)),
    (r"ssm.*\bw_out\b", ("model", None)),
    (r"ssm.*\bout_norm\b", ("model",)),
    # xlstm
    (r"mix.*\bw_up\b", (None, "model")),
    (r"mix.*\bw_q\b", ("model", None)),
    (r"mix.*\bw_k\b", ("model", None)),
    (r"mix.*\bw_v\b", ("model", None)),
    (r"mix.*\bw_if\b", ("model", None)),
    (r"mix.*\bw_down\b", ("model", None)),
    (r"mix.*\bout_norm\b", ("model",)),
    (r"mix.*\bw_ff1\b", (None, "model")),
    (r"mix.*\bw_ff2\b", ("model", None)),
    (r"mix.*\bw_gates\b", (None, "model")),
]


def _spec_for(path: str, shape: tuple[int, ...], mesh) -> tuple:
    for pat, tmpl in _RULES:
        if re.search(pat, path):
            axes: list[Optional[str]] = [None] * len(shape)
            # right-align the template (leading dims are layer stacks)
            for i, ax in enumerate(tmpl):
                pos = len(shape) - len(tmpl) + i
                if pos < 0:
                    continue
                axes[pos] = ax if _fits(shape[pos], mesh, ax) else None
            # fallback: vocab-style tables that can't shard dim0 try dim1
            if tmpl[0] == "model" and axes[len(shape) - len(tmpl)] is None \
                    and len(shape) >= 2 and len(tmpl) == 2 \
                    and axes[-1] is None and _fits(shape[-1], mesh, "model"):
                axes[-1] = "model"
            return tuple(axes)
    return ()  # norms, biases, scalars: replicated


# ------------------------------------------------------------ tree layout
def _keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys (str), tuple
    indices (int) and NamedTuple fields (``.name``)."""
    return "".join(p if isinstance(p, str) and p.startswith(".")
                   else f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def param_shapes(model) -> dict:
    """A ``DecoderLM``'s parameters under the reference's tree paths, with
    the reference's stacked shapes ``(n_kind, ...)``: ``{path: shape}``."""
    from repro_torch.convert import _lm_layout

    params = dict(model.named_parameters())
    out = {}
    for path, (names, stacked) in _lm_layout(model.cfg, params).items():
        shape = tuple(params[names[0]].shape)
        out[_keystr(path)] = (len(names), *shape) if stacked else shape
    return dict(sorted(out.items()))


def _leaves(obj, prefix: tuple):
    if isinstance(obj, torch.Tensor):
        yield prefix, tuple(obj.shape)
    elif hasattr(obj, "_fields"):                    # a NamedTuple cache
        for f in obj._fields:
            yield from _leaves(getattr(obj, f), prefix + (f".{f}",))
    else:                                            # a tuple of caches
        for i, o in enumerate(obj):
            yield from _leaves(o, prefix + (i,))


def cache_shapes(cfg, caches: list) -> dict:
    """A ``DecoderLM``'s decode caches (one a layer, the list of
    ``init_decode_caches``) under the reference's tree paths
    (``['dense'].k``, ``['hybrid'][1].state``), stacked a layer kind:
    ``{path: shape}``."""
    kinds = cfg.layer_kinds
    out = {}
    for kind in sorted(set(kinds)):
        layers = [c for k, c in zip(kinds, caches) if k == kind]
        for path, shape in _leaves(layers[0], (kind,)):
            out[_keystr(path)] = (len(layers), *shape)
    return out


def _shapes(tree) -> dict:
    return param_shapes(tree) if isinstance(tree, torch.nn.Module) \
        else dict(tree)


# ----------------------------------------------------------------- specs
def param_specs(params, mesh) -> dict:
    """``{path: spec}`` for a ``DecoderLM`` or a ``{path: shape}`` tree."""
    return {p: _spec_for(p, tuple(s), mesh)
            for p, s in _shapes(params).items()}


def zero1_specs(params, mesh) -> dict:
    """Optimizer-moment specs: param spec + 'data' on the largest free dim."""
    daxes = _data_axes(mesh)
    dsize = math.prod(_axis_size(mesh, a) for a in daxes) if daxes else 1

    def fn(path, shape):
        spec = _spec_for(path, shape, mesh)
        axes = list(spec) + [None] * (len(shape) - len(spec))
        best, best_dim = -1, 0
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if ax is None and dim % dsize == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best >= 0 and dsize > 1:
            axes[best] = daxes if len(daxes) > 1 else daxes[0]
        return tuple(axes)
    return {p: fn(p, tuple(s)) for p, s in _shapes(params).items()}


def cache_specs(caches, mesh, strategy: str = "sequence") -> dict:
    """Decode-cache specs (``caches`` a ``{path: shape}`` tree, see
    :func:`cache_shapes`): layer axis unsharded, batch over data axes, one
    model-sharded dim chosen per leaf.

    ``strategy`` picks which dim carries the model axis:
      * "sequence": kv heads → window/seq dim → feature (the baseline);
      * "feature": trailing feature dim (head_dim / rank / state) first,
        so a cache write indexes only unsharded dims.
    """
    daxes = _data_axes(mesh)
    dlead = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    dsz = data_size(mesh)

    def fn(name, shape):
        ndim = len(shape)
        if re.search(r"\bpos\b", name) or ndim <= 2:
            return ()                       # (L, W) position rings etc.
        axes: list = [None] * ndim
        if ndim >= 3 and shape[1] % max(dsz, 1) == 0:
            axes[1] = dlead                 # (L, B, ...)
        if strategy == "feature":
            prefer = list(range(ndim - 1, 1, -1))
        else:  # "sequence" (baseline)
            prefer = ([3, 2, 4] if ndim == 5 else
                      [2, ndim - 1] if ndim == 4 else
                      [ndim - 1])
        for i in prefer:
            if i < ndim and shape[i] >= 16 \
                    and _fits(shape[i], mesh, MODEL_AXIS):
                axes[i] = MODEL_AXIS
                break
        return tuple(axes)
    return {p: fn(p, tuple(s)) for p, s in dict(caches).items()}


def data_size(mesh) -> int:
    daxes = _data_axes(mesh)
    return math.prod(_axis_size(mesh, a) for a in daxes) if daxes else 1


def batch_spec(mesh, extra_dims: int = 1,
               batch: Optional[int] = None) -> tuple:
    """Tokens/labels: batch over all data axes, rest replicated.

    If ``batch`` is given and not divisible by the data-axis product, the
    batch dim replicates (e.g. long_500k's global_batch=1)."""
    daxes = _data_axes(mesh)
    if batch is not None and (not daxes or batch % data_size(mesh)):
        return (None,) * (extra_dims + 1)
    lead = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    return (lead, *([None] * extra_dims))


def activation_spec(mesh, *, seq_sharded: bool = False) -> tuple:
    """(B, S, d) activations: batch over data axes, optionally SP on S."""
    daxes = _data_axes(mesh)
    lead = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    return (lead, "model" if seq_sharded else None, None)


# ------------------------------------------------------------- placement
def _dim_axes(entry) -> tuple:
    return () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)


def _roles(dim: int, entry, parts: int) -> int:
    """How many roles lie side by side on ``dim``: ``parts`` on the dim
    cut over the model axis, else one."""
    return parts if MODEL_AXIS in _dim_axes(entry) else 1


def shard_tensor(full: torch.Tensor, spec: tuple, mesh,
                 parts: int = 1) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` on ``mesh``: each dim
    with axes is cut into as many equal blocks as the axes have ranks,
    and the block at this rank's row-major index along them is kept.

    ``parts``: the dim cut over the model axis holds that many equal
    roles side by side (``[x | gate]``, ``[i f z o]``); each role is cut
    into blocks and this rank keeps its block of every role, in role
    order, so a rank's channels of each role stay together."""
    out = full
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        n = mesh.size(axes) if axes else 1
        if n == 1:
            continue
        k = _roles(dim, entry, parts)
        if out.shape[dim] % (n * k):
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide into {k} roles over {axes} ({n} "
                             f"ranks)")
        i = mesh.index(axes)
        out = out.unflatten(dim, (k, -1)).chunk(n, dim + 1)[i] \
            .flatten(dim, dim + 1)
    return out.contiguous()


def gather_tensor(local: torch.Tensor, spec: tuple, mesh,
                  parts: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (and
    ``parts``, as :func:`shard_tensor`'s): one ``all_gather`` a sharded
    dim over the group of its axes (collective on every rank of the
    mesh)."""
    import torch.distributed as dist

    out = local.contiguous()
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        n = mesh.size(axes) if axes else 1
        if n == 1:
            continue
        blocks = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(blocks, out, group=mesh.group(axes))
        k = _roles(dim, entry, parts)
        out = torch.cat([b.unflatten(dim, (k, -1)) for b in blocks],
                        dim + 1).flatten(dim, dim + 1)
    return out
