"""Tensor parallelism over a mesh's model axis, for every block kind.

The reference trains and serves with ``param_shardings`` over a ``(data,
model)`` mesh and lets GSPMD partition the one-device program; this
module does by hand what that partitioning computes, Megatron-style, for
every block kind: ``dense``, ``local``, ``global``, ``moe`` and ``cross``
(GQA, MLA and cross-attention, the SwiGLU MLP, the MoE with expert
parallelism), ``hybrid`` (its attention as GQA's, the Mamba branch by
channels, :mod:`repro_torch.models.ssm`) and xLSTM's ``mlstm`` and
``slstm`` (by heads, :mod:`repro_torch.models.xlstm`): so a sharded model
computes the one-device model's function, to the rounding of its partial
sums.  A layer makes one ``all_reduce`` for its attention and one for its
MLP or MoE (the routed experts' float32 partial combine and the shared
experts' partial output summed together); a Mamba branch three (B, C and
dt; its norm; ``w_out``), an mLSTM block three (u gathered; its norm;
``w_down``) and an sLSTM block one ``all_gather`` of h and one
``all_reduce`` for its MLP.

* The collectives under autograd: :func:`copy_to_model` (identity
  forward, ``all_reduce`` of the gradient over the model group backward)
  at a column-parallel input, :func:`reduce_from_model` (``all_reduce``
  forward, identity backward) at a row-parallel output,
  :func:`gather_from_model` (the ranks' last-dim blocks ``all_gather``-ed
  forward, this rank's block of the gradient backward: the vocabulary
  logits, sLSTM's h) and :func:`sum_parts` (row-parallel partials summed
  forward and their gradients summed backward, one float32
  ``all_reduce`` each way: the Mamba branch's B, C and dt).  A
  replicated parameter used inside a split region (QK-norm's scales, a
  replicated ``wk``, the Mamba branch's ``dt_bias``, ``a_log`` and
  ``d_skip``, sLSTM's ``r_gates`` and ``f_bias``) passes through
  :func:`copy_to_model`, so its gradient is whole on every rank; so does
  a value that every rank holds whole but reads only through its own
  heads, channels or experts: the outputs of MLA's replicated ``w_dkv``
  and ``kv_norm``, a MoE layer's combine weights, a split norm's summed
  mean of squares and mLSTM's gathered u (the Mamba branch's B, C and dt
  through :func:`sum_parts`).  What every rank computes whole and uses
  whole (the MoE router, its aux losses) is not summed.
* :func:`shard_lm` cuts a one-device ``DecoderLM``'s parameters in place
  into this rank's blocks by
  :func:`repro_torch.distributed.sharding.param_specs` (the reference's
  rules on the reference's paths), one spec a layer's leaf (the layer
  stack's axis dropped).  Where a rule would cut inside an attention
  head, the leaf is replicated over the model axis instead (glm4-9b's 2
  kv heads at M = 4: ``wk``'s 256 columns divide by 4, its heads do not),
  a MoE layer whose routed experts or shared width do not divide is
  replicated whole, and so is an xLSTM block whose heads do not divide
  (or an sLSTM MLP whose width does not: xlstm-1.3b's 2730 at M = 4); a
  vocabulary table the rules would cut along ``d_model`` is replicated
  too, and so is sLSTM's ``out_norm`` (it acts on h gathered whole).
  :attr:`TensorParallel.replicated` lists those leaves.  Three leaves put
  roles side by side on their cut dim (``ssm.w_in`` [x | gate], mLSTM's
  ``w_up`` [value | gate], sLSTM's ``w_gates`` [i f z o]) and mLSTM's
  ``w_if`` [i | f]: they are cut role by role (:attr:`TensorParallel.
  parts`).  mLSTM's ``w_q``, ``w_k``, ``w_v`` and ``w_if`` are cut by
  columns, where the rules cut their rows: u is gathered whole instead
  of q, k, v and the gate logits being summed (a third of the bytes).
  :func:`gather_lm` is the inverse: every parameter whole.
* :class:`Zero1`: AdamW's moments split over the data axes on each
  leaf's largest dim the model axis leaves free (``zero1_specs``' choice,
  made on the port's per-layer leaf: the reference's layer-stack axis is
  not a port dim); a dim cut role by role is the model axis's, never
  ZeRO-1's.
* The checkpoint helpers: :func:`whole_state` gathers a sharded
  ``TrainState`` whole (collective on every rank), :func:`local_block`
  cuts a whole checkpoint leaf into this rank's block, both role by role
  where a leaf has roles, so a checkpoint does not depend on the mesh it
  was written on.

At a model axis of one rank every collective still runs (over a group of
one) and the sharded model equals the plain one bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .sharding import (DATA_AXES, MODEL_AXIS, gather_tensor, param_specs,
                       shard_tensor)

__all__ = ["TensorParallel", "HeadSplit", "Zero1", "copy_to_model",
           "reduce_from_model", "gather_from_model", "sum_parts",
           "head_split",
           "shard_lm", "gather_lm", "zero1_plan", "is_sharded",
           "whole_state", "whole_shape", "local_block"]


def _dist():
    import torch.distributed as dist
    return dist


# ------------------------------------------------------------ collectives
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        _dist().all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.index, ctx.n = index, n
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        _dist().all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.index].contiguous(), None, None, \
            None


def _sum_cat(parts, group) -> tuple:
    """``parts`` (…, n_i each) summed over ``group`` in one float32
    ``all_reduce`` of their concatenation, each cast back to its dtype
    once and contiguous."""
    flat = torch.cat([p.float() for p in parts], dim=-1)
    _dist().all_reduce(flat, group=group)
    outs = flat.split([p.shape[-1] for p in parts], dim=-1)
    return tuple(o.to(p.dtype).contiguous() for o, p in zip(outs, parts))


class _SumParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *parts):
        ctx.group = group
        return _sum_cat(parts, group)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_sum_cat(grads, ctx.group))


def sum_parts(parts, group) -> tuple:
    """Row-parallel partials that feed only this rank's heads: each
    summed over ``group`` forward and its gradient summed backward (a
    ``reduce_from_model`` then a ``copy_to_model``), all of them in one
    float32 ``all_reduce`` each way, cast back once.  Every output and
    gradient is contiguous, as the plain products' are: a gradient that
    reached a product as a slice of a wider buffer would change the
    card's GEMM (its leading dimension) and its bits."""
    return _SumParts.apply(group, *parts)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward; the gradient as it is backward."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group, n: int, index: int
                      ) -> torch.Tensor:
    """The ranks' last-dim slices concatenated in rank order forward; this
    rank's slice of the gradient backward."""
    return _GatherFromModel.apply(x, group, n, index)


# ------------------------------------------------------------------ plans
class HeadSplit(NamedTuple):
    """One GQA layer's heads on this rank: ``hq`` query heads (block
    ``index`` of the query heads); kv heads ``kv_lo .. kv_lo+hkv-1`` held
    (their ``wk``/``wv`` columns when ``kv_split``; else the leaves are
    replicated and the heads selected), and ``kv_map`` (hq,), each local
    query head's held kv head (None when ``kv_split``: the usual repeat
    by the group size)."""

    hq: int
    kv_lo: int
    hkv: int
    kv_split: bool
    kv_map: Optional[torch.Tensor]


def head_split(cfg, size: int, index: int, device=None
               ) -> Optional[HeadSplit]:
    """This rank's heads at a model axis of ``size``; None when the query
    heads do not divide (the layer's attention is then replicated)."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if H % size:
        return None
    hq = H // size
    q0 = index * hq
    if Hkv % size == 0:
        n = Hkv // size
        return HeadSplit(hq, index * n, n, True, None)
    groups = H // Hkv
    lo, hi = q0 // groups, (q0 + hq - 1) // groups
    kv_map = torch.arange(q0, q0 + hq, device=device) // groups - lo
    return HeadSplit(hq, lo, hi - lo + 1, False, kv_map)


class TensorParallel:
    """A model's split over ``mesh``'s model axis: the group, this rank's
    index, each parameter's per-layer spec (``specs``), the roles side by
    side on a leaf's model-cut dim (``parts``, names absent have one),
    the leaves replicated against the rules (``replicated``) and whether
    the vocabulary tables are split (``vocab``)."""

    def __init__(self, mesh, specs: dict, replicated: list, vocab: bool,
                 parts: dict):
        self.mesh = mesh
        self.size = mesh.size(MODEL_AXIS)
        self.index = mesh.index(MODEL_AXIS) if MODEL_AXIS in mesh.shape \
            else 0
        self.group = mesh.group(MODEL_AXIS)
        self.specs = specs
        self.replicated = replicated
        self.vocab = vocab
        self.parts = parts

    def __repr__(self) -> str:
        return (f"TensorParallel(model axis {self.size}, index "
                f"{self.index}, {len(self.replicated)} leaves replicated)")

    def copy(self, x):
        return copy_to_model(x, self.group)

    def reduce(self, x):
        return reduce_from_model(x, self.group)

    def gather(self, x):
        return gather_from_model(x, self.group, self.size, self.index)

    def sum_parts(self, *parts):
        return sum_parts(parts, self.group)

    def sharded(self, name: str) -> bool:
        """Whether this rank holds a block of ``name``, not all of it."""
        return MODEL_AXIS in self.specs[name]

    def whole(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """Parameter ``name`` (or a tensor of its shape) whole from every
        rank's block (collective on every rank of the mesh)."""
        return gather_tensor(local, self.specs[name], self.mesh,
                             self.parts.get(name, 1))

    def block(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of parameter ``name`` (or a tensor of its
        shape) from the whole."""
        return shard_tensor(whole, self.specs[name], self.mesh,
                            self.parts.get(name, 1))


# mLSTM's projections of u: cut by this rank's heads' columns (u
# gathered whole), where the rules cut their rows
_MLSTM_HEAD_COLUMNS = ("w_q", "w_k", "w_v", "w_if")
# leaves with roles side by side on their model-cut dim: [x | gate],
# [value | gate], [i | f], [i f z o]
_ROLES = {("ssm", "w_in"): 2, ("mlstm", "w_up"): 2, ("mlstm", "w_if"): 2,
          ("slstm", "w_gates"): 4}


def _plan(model, mesh) -> tuple[dict, list, bool]:
    """Per-layer spec of each parameter name, the leaves replicated
    against the rules, and whether the vocabulary tables are split."""
    from repro_torch.convert import _keystr, _lm_layout

    cfg = model.cfg
    size = mesh.size(MODEL_AXIS)
    ref = param_specs(model, mesh)
    params = dict(model.named_parameters())
    heads_ok = cfg.num_heads % size == 0
    kv_ok = heads_ok and cfg.num_kv_heads % size == 0
    moe = cfg.moe
    moe_ok = moe is not None and moe.num_experts % size == 0 and \
        (moe.num_shared * moe.d_expert) % size == 0
    ssm_ok = cfg.ssm is not None and \
        (cfg.ssm.expand * cfg.d_model) % size == 0
    ff_ok = ((4 * cfg.d_model) // 3) % size == 0       # sLSTM's MLP
    specs, replicated, vocab = {}, [], True
    for path, (names, stacked) in _lm_layout(cfg, params).items():
        spec = ref[_keystr(path)]
        spec = tuple(spec[1:]) if stacked and spec else tuple(spec)
        leaf = path[-1]
        kind = path[1] if path[0] == "blocks" else None
        rep = False
        if path[0] in ("embed", "lm_head"):
            rep = spec != ("model", None)
            vocab = vocab and not rep
        elif path[-2:-1] == ("attn",) and leaf in ("wq", "wo", "w_uk",
                                                   "w_uv"):
            rep = not heads_ok
        elif path[-2:-1] == ("attn",) and leaf in ("wk", "wv"):
            rep = not kv_ok
        elif path[2:3] == ("moe",):     # the experts, shared and routed
            rep = not moe_ok
        elif path[2:3] == ("ssm",):
            rep = not ssm_ok
        elif kind == "mlstm":
            rep = not heads_ok
            if leaf in _MLSTM_HEAD_COLUMNS and not rep:
                spec = (None, MODEL_AXIS)
        elif kind == "slstm":
            rep = (not ff_ok if leaf in ("w_ff1", "w_ff2") else
                   not heads_ok or leaf == "out_norm")
        if rep:
            if MODEL_AXIS in spec:
                replicated += names
            spec = ()
        for n in names:
            specs[n] = spec
    return specs, replicated, vocab


def _role_parts(cfg, specs: dict) -> dict:
    """The roles of each leaf the model axis cuts role by role
    (``_ROLES``), by parameter name."""
    out = {}
    for name, spec in specs.items():
        path = name.split(".")
        if path[0] != "blocks" or MODEL_AXIS not in spec:
            continue
        kind = cfg.layer_kinds[int(path[1])]
        k = _ROLES.get((path[2] if kind == "hybrid" else kind, path[-1]), 1)
        if k > 1:
            out[name] = k
    return out


@torch.no_grad()
def shard_lm(model, mesh) -> TensorParallel:
    """Cut ``model``'s parameters in place into this rank's blocks over
    ``mesh``'s model axis and wire its blocks for the split; returns (and
    sets as ``model.tp``) the :class:`TensorParallel`.  Every rank of the
    mesh calls it on the same whole model."""
    cfg = model.cfg
    if MODEL_AXIS not in mesh.shape:
        raise ValueError(f"shard_lm needs a mesh with a {MODEL_AXIS!r} "
                         f"axis, got {mesh}")
    size = mesh.size(MODEL_AXIS)
    if model.tp is not None:
        raise ValueError("the model is already sharded")
    specs, replicated, vocab = _plan(model, mesh)
    tp = TensorParallel(mesh, specs, replicated, vocab,
                        _role_parts(cfg, specs))
    for name, p in model.named_parameters():
        local = tp.block(name, p.data)
        if local.data_ptr() != p.data.data_ptr() or \
                local.shape != p.shape:
            p.data = local.clone()
    heads = head_split(cfg, size, tp.index, model.device)

    def split(i, leaf):
        return tp if tp.sharded(f"blocks.{i}.{leaf}") else None

    for i, blk in enumerate(model.blocks):
        if blk.kind == "mlstm":
            blk.tp_mix = split(i, "mix.w_up")
            continue
        if blk.kind == "slstm":
            blk.tp_mix = split(i, "mix.w_gates")
            blk.tp_ffn = split(i, "mix.w_ff1")
            continue
        blk.tp_attn = (tp, heads) if heads is not None else None
        if blk.kind == "hybrid":
            blk.tp_mix = split(i, "ssm.w_in")
        blk.tp_ffn = split(i, "moe.w_down" if blk.kind == "moe"
                           else "mlp.w_down")
    model.tp = tp
    return tp


@torch.no_grad()
def gather_lm(model) -> dict:
    """Every parameter of a sharded ``model`` whole, by name (collective
    on every rank of its mesh); a plain model's parameters as they are."""
    tp = model.tp
    return {n: (p.detach() if tp is None else tp.whole(n, p.detach()))
            for n, p in model.named_parameters()}


# ----------------------------------------------------------------- ZeRO-1
class Zero1:
    """AdamW's moments split over ``mesh``'s data axes: ``dims`` maps a
    parameter name to the dim its moments are cut along (names absent
    keep whole moments); this rank holds block ``index`` of ``size``."""

    def __init__(self, mesh, dims: dict):
        self.mesh = mesh
        self.axes = tuple(a for a in DATA_AXES if a in mesh.shape)
        self.size = mesh.size(self.axes)
        self.index = mesh.index(self.axes)
        self.dims = dims

    def group(self):
        return self.mesh.group(self.axes)

    def spec(self, name: str, tp_spec: tuple, ndim: int) -> tuple:
        """A moment's spec: the parameter's, with the data axes on its
        ZeRO dim."""
        axes = list(tp_spec) + [None] * (ndim - len(tp_spec))
        if name in self.dims:
            axes[self.dims[name]] = (self.axes if len(self.axes) > 1
                                     else self.axes[0])
        return tuple(axes)

    def cut(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's block of a moment-shaped tensor (a view)."""
        d = self.dims.get(name)
        return t if d is None else t.chunk(self.size, d)[self.index]


def zero1_plan(model, mesh) -> Optional[Zero1]:
    """The ZeRO-1 split of ``model``'s moments over ``mesh``'s data axes
    (None at one data rank): each leaf's largest dim, of this rank's
    block, that the model axis leaves whole and the data axes divide."""
    axes = tuple(a for a in DATA_AXES if a in mesh.shape)
    D = mesh.size(axes) if axes else 1
    if D == 1:
        return None
    tp = model.tp
    dims = {}
    for name, p in model.named_parameters():
        spec = tp.specs[name] if tp is not None else ()
        spec = list(spec) + [None] * (p.dim() - len(spec))
        best, best_dim = -1, 0
        for i, (ax, n) in enumerate(zip(spec, p.shape)):
            if ax is None and n % D == 0 and n > best_dim:
                best, best_dim = i, n
        if best >= 0:
            dims[name] = best
    return Zero1(mesh, dims)


# ------------------------------------------------------------ checkpoints
def is_sharded(state) -> bool:
    """Whether a ``TrainState`` holds blocks: a model split by
    :func:`shard_lm`, or ZeRO-1 moments."""
    return (getattr(state.model, "tp", None) is not None
            or getattr(state.opt, "zero", None) is not None)


def _mesh_of(state):
    return (state.model.tp.mesh if state.model.tp is not None
            else state.opt.zero.mesh)


def _parts(state) -> dict:
    tp = state.model.tp
    return tp.parts if tp is not None else {}


def _leaf_spec(state, name: str, what: str, ndim: int) -> tuple:
    tp = state.model.tp
    spec = tp.specs[name] if tp is not None else ()
    zero = state.opt.zero
    if what in ("m", "v") and zero is not None:
        return zero.spec(name, spec, ndim)
    return spec


def _kinds(state):
    params = dict(state.model.named_parameters())
    out = [("param", params), ("m", state.opt.m), ("v", state.opt.v)]
    if state.err is not None:
        out.append(("err", state.err))
    return out


@torch.no_grad()
def whole_state(state) -> dict:
    """A sharded ``TrainState``'s parameters, moments and residual whole:
    ``{kind: {name: tensor}}``, kind ``param``, ``m``, ``v``, ``err``
    (collective on every rank of the mesh)."""
    mesh = _mesh_of(state)
    parts = _parts(state)
    return {what: {n: gather_tensor(t.detach(), _leaf_spec(
        state, n, what, t.dim()), mesh, parts.get(n, 1))
        for n, t in tensors.items()} for what, tensors in _kinds(state)}


def whole_shape(state, name: str, what: str, local: torch.Tensor) -> tuple:
    """The whole shape of a sharded state's leaf (``local``, of kind
    ``what``)."""
    mesh = _mesh_of(state)
    shape = list(local.shape)
    for i, entry in enumerate(_leaf_spec(state, name, what, local.dim())):
        if entry is not None:
            shape[i] *= mesh.size(entry)
    return tuple(shape)


def local_block(state, name: str, what: str, whole: torch.Tensor
                ) -> torch.Tensor:
    """This rank's block of a whole leaf of a sharded state."""
    return shard_tensor(whole, _leaf_spec(state, name, what, whole.dim()),
                        _mesh_of(state), _parts(state).get(name, 1))
