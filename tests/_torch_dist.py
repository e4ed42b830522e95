"""Real ``torch.distributed`` worlds for the port's multi-rank tests.

:func:`run_world` spawns ``world`` processes (``torch.multiprocessing``,
spawn start), each joins a gloo group through a ``file://`` store under
the test's temporary directory (no ports to clash between xdist workers),
with a 120 s collective timeout and one torch thread, runs
``fn(rank, world, *args)`` and saves its result with ``torch.save``.  The
parent returns the ranks' results in rank order.  A rank that raises
fails the run at once (the others are killed) with its traceback; a world
still running at ``timeout`` is killed and fails its own test, so a hung
rank never holds the suite.  No process group is ever made in the pytest
process.

The rank bodies below, and each test file's world (``decode_world``,
``train_world``, ``index_world``, ``engine_world``, ``tp_world``), import
the port only: no ``jax``, no ``repro``.  Their inputs come from ``.npz``
files the tests write from seeded numpy.
"""

from __future__ import annotations

import datetime
import hashlib
import importlib
import time
import traceback
import uuid
from pathlib import Path

import numpy as np
import torch

__all__ = ["run_world", "save_tree", "load_tree"]

PG_TIMEOUT_S = 120


def _rank_main(rank, world, out, module, name, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{out}/store", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        res = getattr(importlib.import_module(module), name)(
            rank, world, *args)
        torch.save(res, f"{out}/rank{rank}.pt")
    except BaseException:
        Path(out, f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, tmp_path, *args, timeout: float = 240.0):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; their results."""
    out = Path(tmp_path) / f"{fn.__name__}_w{world}_{uuid.uuid4().hex[:8]}"
    out.mkdir(parents=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, str(out), fn.__module__,
                               fn.__name__, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.exitcode for p in procs]
        if all(c is not None for c in codes) or any(c for c in codes):
            break
        time.sleep(0.05)
    hung = [r for r, p in enumerate(procs) if p.exitcode is None]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errs = [Path(out, f"rank{r}.err") for r in range(world)]
    msgs = [f"rank {r}:\n{e.read_text()}" for r, e in enumerate(errs)
            if e.exists()]
    if msgs or any(p.exitcode for p in procs):
        raise AssertionError(f"{fn.__name__} at world {world} failed "
                             f"(killed: {hung})\n" + "\n".join(msgs))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def save_tree(path, tree: dict) -> None:
    """A nested dict of arrays as one ``.npz`` ('/'-joined keys)."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *head, last = key.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = z[key]
    return out


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


# ===================================================== pipeline and decode
def pipeline_world(rank, world, path):
    """GPipe over a (world, 1) (pod, model) mesh on ``path``'s inputs."""
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.mesh import Mesh

    z = np.load(path)
    mesh = Mesh((world, 1), ("pod", "model"))
    Ws, bs, x = (torch.as_tensor(z[k]) for k in ("Ws", "bs", "x"))

    def stage(params, h):
        W, b = params
        return torch.tanh(h @ W + b)

    return pipeline_forward(stage, (Ws, bs), x, mesh, axis="pod").numpy()


def placement_world(rank, world):
    """``shard_tensor`` then ``gather_tensor`` over every spec form on a
    (2, world/2) mesh, and the flattened data group's ranks."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import gather_tensor, shard_tensor
    from repro_torch.distributed.mesh import Mesh, make_test_mesh

    data = 2 if world % 2 == 0 else 1
    mesh = make_test_mesh(data, world // data)
    full = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    out = {}
    for spec in [(), ("data", None), (None, "model"), ("data", "model"),
                 (("data", "model"), None), (None, None, None)]:
        local = shard_tensor(full, spec, mesh)
        out[str(spec)] = (tuple(local.shape),
                          bool(torch.equal(gather_tensor(local, spec, mesh),
                                           full)))
    from repro_torch.sharding.merge import gather_candidates, merge_topk

    tied = torch.ones(3, 4)                      # every rank's keys equal
    ids = (rank * 100 + torch.arange(12)).view(3, 4).to(torch.int32)
    merged = merge_topk(*gather_candidates(tied, ids, dist.group.WORLD,
                                           world), 4)
    out["tie_ids"] = merged[0].numpy()
    pods = Mesh((2, 1, world // 2), ("pod", "data", "model"))
    g = pods.group(("pod", "data"))
    out["pod_data_ranks"] = dist.get_process_group_ranks(g)
    out["coordinate"] = pods.coordinate
    return out


def flash_layer_world(rank, world, path):
    """``_flash_decode`` on one GQA layer over a (1, world) mesh: every
    case of ``path`` from its whole cache, each step's output, and the
    ranks' cache blocks gathered whole at the end."""
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import gather_tensor
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.models.attention import (KVCache, _flash_decode,
                                              flash_cache_shard)

    z = np.load(path)
    mesh = make_test_mesh(1, world)
    cfg = SimpleNamespace(num_heads=int(z["num_heads"]),
                          num_kv_heads=int(z["num_kv_heads"]))
    res = {}
    for window in z["windows"].tolist():
        t = lambda k: torch.as_tensor(z[f"{k}_{window}"])   # noqa: E731
        cache = flash_cache_shard(KVCache(t("k"), t("v"), t("pos")), mesh)
        outs = []
        for i, pos in enumerate(z["steps"].tolist()):
            o, cache = _flash_decode(t("q")[i], t("kn")[i], t("vn")[i],
                                     cache, pos, cfg=cfg, window=window,
                                     mesh=mesh)
            outs.append(o.numpy())
        whole = [gather_tensor(c, spec, mesh).numpy() for c, spec in
                 zip(cache, ((None, "model"), (None, "model"), ("model",)))]
        res[window] = (np.stack(outs), whole)
    try:
        bad = KVCache(torch.zeros(1, 7, 1, 2), torch.zeros(1, 7, 1, 2),
                      torch.zeros(7, dtype=torch.int32))
        flash_cache_shard(bad, make_test_mesh(1, world))
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def flash_model_world(rank, world, params_path, tokens, max_len):
    """The reduced Qwen3 decoding ``tokens`` (T, B, 1) with flash decoding
    over a (1, world) mesh: each step's logits."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_from_arrays
    from repro_torch.distributed.mesh import make_test_mesh

    cfg = get_config("qwen3-0.6b").reduced()
    model = lm_from_arrays(load_tree(params_path), cfg, device="cpu")
    mesh = make_test_mesh(1, world)
    caches = model.init_decode_caches(tokens.shape[1], max_len,
                                      flash_mesh=mesh)
    out = []
    with torch.no_grad():
        for t in range(tokens.shape[0]):
            logits, caches = model.decode_step(
                torch.as_tensor(tokens[t]), caches, t, flash_mesh=mesh)
            out.append(logits.numpy())
    return np.stack(out)


# ================================================================ training
def _reduced_lm(params_path, arch="qwen3-0.6b"):
    """The reduced ``arch`` (float32) on the reference's saved weights."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_from_arrays

    cfg = get_config(arch).reduced()
    return lm_from_arrays(load_tree(params_path), cfg, device="cpu")


def _local(batch: dict, rank: int, world: int, M: int) -> dict:
    """This rank's rows ``rank::world`` (the data pipeline's host split),
    with a leading microbatch axis when ``M > 1``."""
    out = {k: torch.as_tensor(v[rank::world]) for k, v in batch.items()}
    if M > 1:
        out = {k: v.reshape(M, -1, *v.shape[1:]) for k, v in out.items()}
    return out


def dp_world(rank, world, params_path, batches, combos, ckpt_dir=None,
             arch="qwen3-0.6b"):
    """Data-parallel train steps of the reduced ``arch`` over a (world, 1)
    mesh.

    For each ``(microbatches, compress)`` of ``combos``, from the same
    weights: every step's parameters before it, loss, metrics and
    averaged gradients (rank 0; every rank's loss), and a digest of the
    final parameters, moments and residual on every rank.  At world 1 each step
    is also run by the one-device step on a twin and compared bit for
    bit.  With ``ckpt_dir`` the last state is saved there (rank 0 writes).
    """
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.training.train_step import (TrainConfig,
                                                 make_train_step,
                                                 train_state_init)

    mesh = make_test_mesh(world, 1)
    res = {}
    for M, compress in combos:
        tcfg = TrainConfig(microbatches=M, peak_lr=1e-3, warmup_steps=2,
                           total_steps=50, compress_grads=compress,
                           remat=False)
        model = _reduced_lm(params_path, arch)
        state = train_state_init(model, tcfg)
        step = make_train_step(model, tcfg, mesh=mesh)
        if world == 1:
            twin = _reduced_lm(params_path, arch)
            tstate = train_state_init(twin, tcfg)
            tstep = make_train_step(twin, tcfg)
        rec = {"params": [], "loss": [], "metrics": [], "grads": [],
               "same": []}
        for b in batches:
            if rank == 0:
                rec["params"].append({k: p.detach().numpy().copy() for k, p
                                      in model.named_parameters()})
            loss, metrics, grads = step.grads(state, _local(b, rank, world,
                                                            M))
            rec["loss"].append(float(loss))
            rec["metrics"].append({k: float(v) for k, v in metrics.items()})
            if rank == 0:
                rec["grads"].append({k: g.numpy().copy()
                                     for k, g in grads.items()})
            state, _ = step.update(state, loss, metrics, grads)
            if world == 1:
                tstate, tm = tstep(tstate, _local(b, 0, 1, M))
                rec["same"].append(
                    float(tm["loss"]) == rec["loss"][-1] and all(
                        torch.equal(p, q) for p, q in
                        zip(model.parameters(), twin.parameters())))
        tensors = [*model.parameters(), *state.opt.m.values(),
                   *state.opt.v.values(), state.opt.step]
        if state.err is not None:
            tensors += list(state.err.values())
        rec["digest"] = _digest(tensors)
        res[(M, compress)] = rec
    if ckpt_dir is not None:
        Checkpointer(ckpt_dir).save(
            7, state, extra={"world": world}, block=True)
    return res


def learn_world(rank, world, params_path, batch):
    """The reference's SPMD contract: 8 steps at lr 5e-3 on one batch."""
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.training.train_step import (TrainConfig,
                                                 make_train_step,
                                                 train_state_init)

    tcfg = TrainConfig(microbatches=1, peak_lr=5e-3, warmup_steps=1,
                       remat=False)
    model = _reduced_lm(params_path)
    state = train_state_init(model, tcfg)
    step = make_train_step(model, tcfg, mesh=make_test_mesh(world, 1))
    losses = []
    for _ in range(8):
        state, m = step(state, _local(batch, rank, world, 1))
        losses.append(float(m["loss"]))
    return losses


def restore_world(rank, world, params_path, ckpt_dir):
    """Every rank restores the latest checkpoint into a fresh state."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.convert import train_state_to_arrays
    from repro_torch.training.train_step import TrainConfig, train_state_init

    state = train_state_init(_reduced_lm(params_path),
                             TrainConfig(compress_grads=True))
    state, meta = Checkpointer(ckpt_dir).restore(state)
    return meta["step"], train_state_to_arrays(state)


def launcher_world(rank, world, ckpt_dir, argv):
    """``launch.train.main`` over a (world, 1) mesh: a first run to step
    3, then the same command to step 6, which resumes."""
    from repro_torch.launch import train

    first = train.main([*argv, "--steps", "3", "--ckpt-dir", ckpt_dir])
    second = train.main([*argv, "--steps", "6", "--ckpt-dir", ckpt_dir])
    return first, second


# =================================================================== index
def sharded_dqf_world(rank, world, path, cfg_kw):
    """``ShardedDQF(use_mesh=True)`` at S = world over the reference's
    saved shards, beside a one-card twin (``use_mesh=False``): searches,
    the oracle's, through one insert and one delete, then both served
    through ``ShardedEngine``; then the port's own build at S = world on
    the mesh against its oracle."""
    from repro_torch.core import DQFConfig
    from repro_torch.sharding import ShardConfig, ShardedDQF, ShardedEngine

    z = load_tree(path)
    S = world
    cfg = DQFConfig(**cfg_kw)
    arrays = [z[f"shard{s}"] for s in range(S)]
    owner = dict(zip(z["owner_ext"].tolist(), z["owner_shard"].tolist()))
    sds = {mesh: ShardedDQF.from_arrays(
        arrays, cfg, ShardConfig(num_shards=S, use_mesh=mesh), owner=owner,
        device="cpu") for mesh in (True, False)}
    q = z["q"]
    out = {"rows": int(sds[True]._sync_stacked()["x_pad"].shape[0]),
           "coordinate": sds[True]._mesh.coordinate}

    def searches(tag):
        for mesh, sd in sds.items():
            r = sd.search(q, record=False)
            out[(tag, mesh)] = (r.ids, r.dists)
        o = sds[True].search_oracle(q)
        out[(tag, "oracle")] = (o.ids, o.dists)

    searches("before")
    for sd in sds.values():
        out["inserted"] = sd.insert(z["new_rows"])
        sd.delete(z["delete_ids"])
    searches("after")
    for mesh, sd in sds.items():
        eng = ShardedEngine(sd, wave_size=8, tick_hops=4)
        rids = eng.submit(q)
        res = eng.run_until_drained()["results"]
        out[("engine", mesh)] = (np.stack([res[r]["ids"] for r in rids]),
                                 np.stack([res[r]["dists"] for r in rids]),
                                 eng.stats.ticks, eng.stats.completed)
    own = ShardedDQF(cfg, ShardConfig(num_shards=S, use_mesh=True),
                     device="cpu").build(z["x"])
    own.warm(q[:8])
    a, b = own.search(q, record=False), own.search_oracle(q)
    out["own"] = (a.ids, a.dists, b.ids, b.dists)
    return out


def segments_world(rank, world, cases, cfg_kw):
    """``sharded_search`` over port meshes on the reference's segment
    indexes: ``cases`` maps a (data, model) shape to an index's ``.npz``;
    a model axis unequal to S raises."""
    from repro_torch.core import DQFConfig
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.serving.sharded import ShardedIndex, sharded_search

    cfg = DQFConfig(**cfg_kw)
    out = {}
    for shape, path in cases:
        z = np.load(path)
        index = ShardedIndex(x_pad=z["x_pad"], adj_pad=z["adj_pad"],
                             entries=z["entries"], offsets=z["offsets"],
                             n_total=int(z["n_total"]))
        mesh = make_test_mesh(*shape)
        out[shape] = sharded_search(index, z["q"], mesh, cfg=cfg,
                                    device="cpu")
        out[(shape, "odd")] = sharded_search(index, z["q"][:7], mesh,
                                             cfg=cfg, device="cpu")
        out[(shape, "keys")] = sorted(index._tables)
        out[(shape, "one card")] = sharded_search(index, z["q"], cfg=cfg,
                                                  device="cpu")
        try:
            sharded_search(index, z["q"], make_test_mesh(world, 1),
                           cfg=cfg, device="cpu")
            out[(shape, "model_axis")] = None
        except ValueError as e:
            out[(shape, "model_axis")] = str(e)
    return out


# ================================================================== engine
class StepClock:
    """A clock the caller moves (``t``), read by this rank at ``t`` plus
    its own ``offset``: ranks whose clocks disagree."""

    def __init__(self, offset: float = 0.0):
        self.t = 0.0
        self.offset = offset

    def __call__(self) -> float:
        return self.t + self.offset


def _engine_run(eng, plan, *, on_step=None, clock=None, dt=0.0):
    """Serve ``plan`` (tenant, queries, steps after submitting) one
    ``step()`` at a time and drain; ``on_step(eng, i)`` after step i, and
    ``clock.t`` moved by ``dt`` before each step.  Returns the results in
    submission order, the ticks, and the collectives made while ticking
    (all of them less one broadcast a ``submit``)."""
    rids, steps = [], [0]
    c0 = eng.collectives

    def step():
        if clock is not None:
            clock.t += dt
        eng.step()
        if on_step is not None:
            on_step(eng, steps[0])
        steps[0] += 1

    submits = 0
    for tenant, q, n in plan:
        rids += eng.submit(q, tenant=tenant)
        submits += 1
        for _ in range(n):
            step()
    while eng.queue or eng._any_live():
        step()
    res = [eng._results[r] for r in rids]
    keys = ("ids", "dists", "hops", "status", "degraded",
            "shards_responding", "tenant")
    return ([{k: r[k] for k in keys} for r in res], eng.stats.ticks,
            eng.collectives - c0 - (submits if eng._group is not None
                                    else 0))


def _counters(sd) -> list:
    """Every shard's tenants' counts and Alg-2 clocks, and the owner map."""
    return [{t.name: (t.counter.counts[:sh.dqf.store.n].copy(),
                      t.counter.since_rebuild) for t in sh.dqf.tenants}
            for sh in sd.shards] + [dict(sorted(sd._owner.items()))]


def engine_world(rank, world, path, cfg_kw):
    """The placed ``ShardedEngine`` at S = world and a one-process twin
    (``use_mesh=False``) over the same saved shards, case by case: each
    case's results, ticks, counters and collectives, both ways."""
    import dataclasses

    from repro_torch.chaos import FaultPlan, install_chaos
    from repro_torch.core import DQFConfig
    from repro_torch.serving.status import EngineConfig
    from repro_torch.sharding import ShardConfig, ShardedDQF, ShardedEngine

    z = load_tree(path)
    S = world
    base = DQFConfig(**cfg_kw)
    owner = dict(zip(z["owner_ext"].tolist(), z["owner_shard"].tolist()))
    q, qa, hot = z["q"], z["qa"], z["hot_q"]

    def index(placed, cfg):
        arrays = [{k: np.array(v) for k, v in z[f"shard{s}"].items()}
                  for s in range(S)]
        return ShardedDQF.from_arrays(
            arrays, cfg, ShardConfig(num_shards=S, use_mesh=placed),
            owner=dict(owner), device="cpu")

    two = [("default", q[:16], 1), ("a", qa[:12], 2), ("default", q[16:],
                                                       0)]
    chaos = FaultPlan(seed=3, shard_fail_ticks={1: frozenset(range(2, 6))},
                      shard_stall_ticks={0: frozenset({3, 7})})
    cases = {
        "fixed fused": (dict(fused=True), {}, two),
        "fixed composed": (dict(fused=False), {}, two),
        "paged": (dict(fused=True), dict(paged=True, page_cols=128), two),
        "chaos fixed": (dict(fused=True), dict(chaos=chaos), two),
        "chaos paged": (dict(fused=True),
                        dict(chaos=chaos, paged=True, page_cols=128), two),
        "churn": (dict(fused=True), dict(churn=True),
                  [("default", hot, 2), ("default", q, 1)]),
        "churn paged": (dict(fused=True),
                        dict(churn=True, paged=True, page_cols=128),
                        [("default", hot, 2), ("default", q, 1)]),
        "deadline": (dict(fused=True), dict(deadline=True),
                     [("default", q, 0)]),
    }
    out = {}
    for name, (cfg_over, kw, plan) in cases.items():
        cfg = dataclasses.replace(base, **cfg_over)
        res = {}
        for placed in (True, False):
            sd = index(placed, cfg)
            opts = dict(kw)
            chaos_plan = opts.pop("chaos", None)
            churn = opts.pop("churn", False)
            deadline = opts.pop("deadline", False)
            clock, on_step, dt = None, None, 0.0
            ekw = dict(wave_size=8, tick_hops=4, **opts)
            if chaos_plan is not None:
                ekw["engine_cfg"] = EngineConfig(quarantine_after=2,
                                                 recover_after=2)
            if deadline:
                clock = StepClock(rank * 0.003 if placed else 0.0)
                ekw.update(tick_hops=2, clock=clock,
                           engine_cfg=EngineConfig(default_deadline_ms=10.0))
                dt = 0.004
            if churn:
                ekw.update(auto_compact=True, compact_ratio=0.005)

                def on_step(eng, i, new=z["new_rows"], dead=z["delete_ids"],
                            donor=z["donor_ext"]):
                    if i == 1:       # writes, and traffic pinned to shard 0
                        sd = eng.sharded
                        sd.insert(new)
                        sd.delete(dead)
                        for _ in range(5):
                            sd.record(np.tile(donor, (20, 1)))
                        sd.rebuild_hot()
            eng = ShardedEngine(sd, **ekw)
            if chaos_plan is not None:
                install_chaos(eng, dataclasses.replace(chaos_plan))
            results, ticks, coll = _engine_run(eng, plan, on_step=on_step,
                                               clock=clock, dt=dt)
            res[placed] = {
                "results": results, "ticks": ticks, "collectives": coll,
                "counters": _counters(sd),
                "compactions": eng.stats.compactions,
                "rebalanced": sd.scrape().get(
                    "shard_rebalanced_rows_total", 0.0),
                "quarantines": eng.health.quarantines,
                "rows": int(eng._stk["x_pad"].shape[0]),
                "lanes": (int(eng._state.active.shape[0])
                          if eng._state is not None else None)}
        out[name] = res
    # one rank's own clock against the shared one, at the deadline case's
    # submission and ticks: the deadline falls between the ranks' readings
    out["offset"] = rank * 0.003
    return out


# ====================================================== tensor parallelism
# The reduced configs the TP worlds cut, by case: the arch (before a "+"),
# its ``reduced`` overrides, and (key "moe") overrides of its MoE config.
# The vision config keeps its cross layer (every 5th); "+int8" sends the
# MoE dispatch in int8, "+routed" limits routing to 2 of 4 expert groups
# at a capacity that drops tokens.  The reduced hymba-1.5b's 4 heads
# divide, so its attention splits; "+odd" has 5 heads of 64 Mamba
# channels (inner 320), which straddle the ranks at M = 2 and 4 as the
# full width's 25 do, and its attention is replicated.  xlstm-1.3b takes
# an sLSTM layer every 2nd (the plain reduced config has none); its
# sLSTM MLP (170 wide) splits at M = 2 and stays whole at M = 4, as the
# full width's 2730.
TP_ARCHS = {"qwen3-0.6b": {}, "gemma3-4b": dict(num_layers=6, window_size=16),
            "glm4-9b": {}, "deepseek-moe-16b": {}, "deepseek-v2-lite-16b": {},
            "llama-3.2-vision-11b": dict(num_layers=5),
            "deepseek-moe-16b+int8": dict(moe=dict(quantize_dispatch=True)),
            "deepseek-v2-lite-16b+routed": dict(moe=dict(
                route_groups=2, num_groups=4, capacity_factor=0.5)),
            "hymba-1.5b": {},
            "hymba-1.5b+odd": dict(d_model=160, num_heads=5, num_kv_heads=1,
                                   head_dim=32),
            "xlstm-1.3b": dict(xlstm_slstm_every=2)}
TP_MOE = tuple(c for c in TP_ARCHS if c.startswith("deepseek"))
TP_TRAIN_MOE = "deepseek-v2-lite-16b"   # ZeRO-1, the checkpoint, launcher
TP_XLSTM = "xlstm-1.3b"                 # its ZeRO-1 steps and checkpoint
TP_LAUNCH_ARCHS = (TP_TRAIN_MOE, "hymba-1.5b", "xlstm-1.3b")   # at 1x2


def tp_config(get_config, case: str):
    """The reduced config of ``case`` from a package's ``get_config`` (the
    port's or the reference's)."""
    import dataclasses

    over = dict(TP_ARCHS[case])
    moe = over.pop("moe", None)
    cfg = get_config(case.split("+")[0]).reduced(**over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _tp_model(path, case, mesh=None):
    """``case``'s reduced config (float32) on ``path``'s reference weights,
    cut over ``mesh``'s model axis: (model, its TensorParallel; None
    without ``mesh``)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_from_arrays
    from repro_torch.distributed.tensor_parallel import shard_lm

    model = lm_from_arrays(load_tree(path), tp_config(get_config, case),
                           device="cpu")
    return model, (shard_lm(model, mesh) if mesh is not None else None)


def media_kw(model, media) -> dict:
    """``media=`` for a model with cross layers, else nothing."""
    return ({"media": torch.as_tensor(media)} if model.cfg.cross_attn_every
            else {})


def decode_caches(model, tokens, media, max_len, mesh=None) -> list:
    """Empty decode caches, a cross layer's holding the media K/V of the
    prefill of ``tokens`` (a zero K/V would make the layer add nothing)."""
    caches = model.init_decode_caches(tokens.shape[0], max_len, mesh=mesh)
    kw = media_kw(model, media)
    if kw:
        _, pre = model.prefill(tokens, **kw)
        caches = [p if blk.kind == "cross" else c
                  for blk, c, p in zip(model.blocks, caches, pre)]
    return caches


def _cache_widths(model, caches) -> dict:
    """What this rank's caches hold: the kv heads of every GQA, cross and
    hybrid attention cache, the latent width of every MLA cache, a hybrid
    layer's SSM (conv channels, sub-heads, N, P′), an mLSTM memory's
    heads and an sLSTM state's (channels, heads), each a sorted list."""
    out = {k: set() for k in ("kv_heads", "latent", "ssm", "mlstm",
                              "slstm")}
    for blk, c in zip(model.blocks, caches):
        if blk.kind == "mlstm":
            out["mlstm"].add(int(c.state.shape[1]))
            continue
        if blk.kind == "slstm":
            out["slstm"].add((int(c.h.shape[1]), int(c.m.shape[1])))
            continue
        if blk.kind == "hybrid":
            c, s = c
            out["ssm"].add((int(s.conv.shape[-1]),
                            *(int(n) for n in s.state.shape[1:])))
        if hasattr(c, "c_kv"):
            out["latent"].add(int(c.c_kv.shape[-1]))
        else:
            k = c.k if hasattr(c, "k") else c[0]
            out["kv_heads"].add(int(k.shape[2]))
    return {k: sorted(v) for k, v in out.items()}


def tp_model_world(rank, world, d, shapes, tokens, labels, media, steps,
                   max_len):
    """Each case of :data:`TP_ARCHS` on each mesh of ``shapes``: the
    prefill logits, the loss and its metrics, every gradient leaf
    (gathered whole), ``steps`` decode steps' logits, the leaves
    replicated against the rules, the caches' widths, the round trip of
    ``gather_lm`` and the refusal of flash decoding on the same axis."""
    from repro_torch.convert import lm_to_arrays
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.distributed.tensor_parallel import gather_lm
    from repro_torch.models.lm import lm_loss

    out = {}
    tok = torch.as_tensor(tokens)
    for shape in shapes:
        mesh = make_test_mesh(*shape)
        for case in TP_ARCHS:
            model, tp = _tp_model(f"{d}/{case}.npz", case, mesh)
            whole = load_tree(f"{d}/{case}.npz")
            kw = media_kw(model, media)
            r = {"replicated": list(tp.replicated)}
            with torch.no_grad():
                r["logits"] = model(tok, mesh=mesh, **kw).numpy()
                caches = decode_caches(model, tok, media, max_len, mesh)
                r.update(_cache_widths(model, caches))
                dec = []
                for t in range(steps):
                    lg, caches = model.decode_step(tok[:, t:t + 1], caches,
                                                   t, mesh=mesh)
                    dec.append(lg.numpy())
                r["decode"] = np.stack(dec)
            for p in model.parameters():
                p.requires_grad_(True)
            loss, metrics = lm_loss(model, tok, labels=labels, mesh=mesh,
                                    **kw)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            r["loss"] = float(loss.detach())
            r["metrics"] = {k: float(v) for k, v in metrics.items()}
            names = [n for n, _ in model.named_parameters()]
            r["grads"] = {n: tp.whole(n, g).numpy()
                          for n, g in zip(names, grads)}
            try:
                model.init_decode_caches(tok.shape[0], max_len, mesh=mesh,
                                         flash_mesh=mesh)
                r["flash"] = None
            except ValueError as e:
                r["flash"] = str(e)
            back = lm_to_arrays(gather_lm(model), model.cfg)
            r["round_trip"] = all(
                np.array_equal(a, b) for a, b in zip(
                    _flat_leaves(back), _flat_leaves(whole)))
            out[(shape, case)] = r
    return out


def tp_one_rank_world(rank, world, d, tokens, labels, media, steps,
                      max_len):
    """Each case cut over a (world, 1) mesh, a model axis of one rank,
    against the plain model on the same rank and inputs: whether the
    logits, the loss, every gradient leaf and ``steps`` decode steps are
    equal bit for bit (the names of the leaves that are not)."""
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.models.lm import lm_loss

    mesh = make_test_mesh(world, 1)
    tok = torch.as_tensor(tokens)
    out = {}
    for case in TP_ARCHS:
        res = []
        for m in (None, mesh):
            model, _ = _tp_model(f"{d}/{case}.npz", case, m)
            kw = media_kw(model, media)
            with torch.no_grad():
                logits = model(tok, mesh=m, **kw)
                caches = decode_caches(model, tok, media, max_len, m)
                dec = torch.stack([model.decode_step(
                    tok[:, t:t + 1], caches, t, mesh=m)[0]
                    for t in range(steps)])
            for p in model.parameters():
                p.requires_grad_(True)
            loss, _ = lm_loss(model, tok, labels=labels, mesh=m, **kw)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            res.append((logits, loss.detach(), dec, dict(zip(
                [n for n, _ in model.named_parameters()], grads))))
        (l0, s0, d0, g0), (l1, s1, d1, g1) = res
        out[case] = {"logits": torch.equal(l0, l1),
                     "loss": torch.equal(s0, s1),
                     "decode": torch.equal(d0, d1),
                     "grads": [n for n in g0 if not torch.equal(g0[n],
                                                                g1[n])]}
    return out


def tp_data_group_world(rank, world, d, tokens, labels):
    """Each MoE case over a (2, 2) mesh: the data-parallel mean of the
    loss, its metrics and the gradients (gathered whole over the model
    axis) of this data rank's rows, the MoE statistics taken over the
    data group (``make_train_step(...).grads``)."""
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.training.train_step import (TrainConfig, TrainState,
                                                 make_train_step)

    mesh = make_test_mesh(2, 2)
    di = mesh.index("data")
    out = {}
    for case in TP_MOE:
        model, tp = _tp_model(f"{d}/{case}.npz", case, mesh)
        for p in model.parameters():
            p.requires_grad_(True)
        step = make_train_step(model, TrainConfig(microbatches=1,
                                                  remat=False), mesh=mesh)
        loss, metrics, grads = step.grads(
            TrainState(model, None, None),
            _local({"tokens": tokens, "labels": labels}, di, 2, 1))
        out[case] = {"loss": float(loss),
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": {n: tp.whole(n, g).numpy()
                               for n, g in grads.items()}}
    return out


def _flat_leaves(tree) -> list:
    return [v for k in sorted(tree) for v in
            (_flat_leaves(tree[k]) if isinstance(tree[k], dict)
             else [np.asarray(tree[k])])]


def _trajectory(path, case, mesh, batches, tcfg):
    """``case`` cut over ``mesh`` trained on this data rank's rows of
    ``batches``: (the state, each step's loss, the parameters whole
    after the last)."""
    from repro_torch.distributed.tensor_parallel import gather_lm
    from repro_torch.training.train_step import (make_train_step,
                                                 train_state_init)

    D, di = mesh.size("data"), mesh.index("data")
    model, _ = _tp_model(path, case, mesh)
    state = train_state_init(model, tcfg, mesh=mesh)
    step = make_train_step(model, tcfg, mesh=mesh)
    losses = []
    for b in batches:
        state, m = step(state, _local(b, di, D, 1))
        losses.append(float(m["loss"]))
    return state, losses, {n: t.numpy() for n, t in gather_lm(model).items()}


def tp_train_world(rank, world, d, mesh_shape, batches, learn_batch,
                   launch_argv):
    """Over a ``mesh_shape`` mesh: the reduced Qwen3's train steps with
    ZeRO-1, without and with int8 compression (each step's loss and the
    parameters whole after the last), the moments' ZeRO dims, a
    checkpoint of the compressed state (``d``/ckpt), the reduced
    :data:`TP_TRAIN_MOE`'s and :data:`TP_XLSTM`'s steps without
    compression and their checkpoints (``d``/ckpt_moe, ``d``/ckpt_xlstm),
    the learning contract, and the launcher (``d``/launch22)."""
    import dataclasses

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.training.train_step import (TrainConfig,
                                                 make_train_step,
                                                 train_state_init)

    mesh = make_test_mesh(*mesh_shape)
    D, di = mesh_shape[0], mesh.index("data")
    qwen = f"{d}/qwen3-0.6b.npz"
    out = {"traj": {}}
    for compress in (False, True):
        tcfg = TrainConfig(microbatches=1, peak_lr=1e-3, warmup_steps=2,
                           total_steps=50, compress_grads=compress,
                           remat=False)
        state, losses, params = _trajectory(qwen, "qwen3-0.6b", mesh,
                                            batches, tcfg)
        out["traj"][compress] = (losses, params)
    out["zero"] = (dict(state.opt.zero.dims) if state.opt.zero is not None
                   else None)
    out["moments"] = {n: tuple(t.shape) for n, t in state.opt.m.items()}
    Checkpointer(f"{d}/ckpt").save(len(batches), state, block=True)
    state, losses, params = _trajectory(
        f"{d}/{TP_TRAIN_MOE}.npz", TP_TRAIN_MOE, mesh, batches,
        dataclasses.replace(tcfg, compress_grads=False))
    out["moe"] = {"losses": losses, "params": params,
                  "zero": dict(state.opt.zero.dims),
                  "moments": {n: tuple(t.shape)
                              for n, t in state.opt.m.items()}}
    Checkpointer(f"{d}/ckpt_moe").save(len(batches), state, block=True)
    state, losses, params = _trajectory(
        f"{d}/{TP_XLSTM}.npz", TP_XLSTM, mesh, batches,
        dataclasses.replace(tcfg, compress_grads=False))
    out["xlstm"] = {"losses": losses, "params": params,
                    "parts": dict(state.model.tp.parts),
                    "moments": {n: tuple(t.shape)
                                for n, t in state.opt.m.items()}}
    Checkpointer(f"{d}/ckpt_xlstm").save(len(batches), state, block=True)
    # the reference's SPMD contract: 8 steps at lr 5e-3 on one batch
    lcfg = TrainConfig(microbatches=1, peak_lr=5e-3, warmup_steps=1,
                       remat=False)
    model, _ = _tp_model(qwen, "qwen3-0.6b", mesh)
    state = train_state_init(model, lcfg, mesh=mesh)
    step = make_train_step(model, lcfg, mesh=mesh)
    learn = []
    for _ in range(8):
        state, m = step(state, _local(learn_batch, di, D, 1))
        learn.append(float(m["loss"]))
    out["learn"] = learn
    out["launch"] = launcher_world(rank, world, f"{d}/launch22", [
        *launch_argv, "--mesh", f"{mesh_shape[0]}x{mesh_shape[1]}"])
    return out


def zero_world(rank, world, qwen, batches):
    """Data-parallel steps over a (world, 1) mesh with ZeRO-1 moments and
    without, from the same weights: the parameters after each step and
    the moments gathered whole, both ways (bit for bit expected)."""
    from repro_torch.convert import lm_from_arrays
    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.distributed.tensor_parallel import Zero1
    from repro_torch.distributed.sharding import gather_tensor
    from repro_torch.training.train_step import (TrainConfig,
                                                 make_train_step,
                                                 train_state_init)

    mesh = make_test_mesh(world, 1)
    tcfg = TrainConfig(microbatches=1, peak_lr=1e-3, warmup_steps=2,
                       total_steps=50, compress_grads=True, remat=False)
    res = {}
    for zero in (True, False):
        model = lm_from_arrays(load_tree(qwen),
                               get_config("qwen3-0.6b").reduced(), "cpu")
        state = train_state_init(model, tcfg, mesh=mesh if zero else None)
        step = make_train_step(model, tcfg, mesh=mesh)
        params = []
        for b in batches:
            state, _ = step(state, _local(b, rank, world, 1))
            params.append([p.detach().clone() for p in model.parameters()])
        z = state.opt.zero
        m = {n: (gather_tensor(t, z.spec(n, (), t.dim()), mesh)
                 if isinstance(z, Zero1) else t)
             for n, t in state.opt.m.items()}
        res[zero] = (params, m, z is not None and bool(z.dims))
    a, b = res[True], res[False]
    return {"zero_used": a[2],
            "params": all(torch.equal(x, y) for s, t in zip(a[0], b[0])
                          for x, y in zip(s, t)),
            "moments": all(torch.equal(a[1][n], b[1][n]) for n in a[1])}


def tp_restore_world(rank, world, path, case, ckpt_dir, compress):
    """The reduced ``case`` cut over a (1, world) mesh restores a
    checkpoint (written on another mesh); its state gathered whole, as
    arrays."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.convert import train_state_to_arrays
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.distributed.tensor_parallel import whole_state
    from repro_torch.training.train_step import TrainConfig, train_state_init

    mesh = make_test_mesh(1, world)
    model, _ = _tp_model(path, case, mesh)
    state = train_state_init(model, TrainConfig(compress_grads=compress),
                             mesh=mesh)
    state, meta = Checkpointer(ckpt_dir).restore(state)
    return meta["step"], train_state_to_arrays(state, whole_state(state))


def tp_every_config(rank, world, tokens):
    """``shard_lm`` on a (1, world) mesh of each of the ten reduced
    configs (the vision config with its cross layer, fed seeded media;
    musicgen-medium fed seeded embeddings): the largest |Δ| of the split
    forward's logits against the plain model's on this rank, over the
    plain logits' max |logits| (an exception's text when it does not
    shard)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.distributed.tensor_parallel import shard_lm
    from repro_torch.models import DecoderLM

    mesh = make_test_mesh(1, world)
    tok = torch.as_tensor(tokens)
    out = {}
    for arch in ARCH_IDS:   # the vision config keeps its cross layer
        over = dict(num_layers=5) if arch == "llama-3.2-vision-11b" else {}
        cfg = get_config(arch).reduced(**over)
        gen = torch.Generator().manual_seed(3)
        kw = ({"media": torch.randn(
            (tok.shape[0], cfg.vision_tokens, cfg.d_model), generator=gen)}
            if cfg.cross_attn_every else {})
        if not cfg.embed_inputs:
            kw["embeds"] = torch.randn((*tok.shape, cfg.d_model),
                                       generator=gen)
        try:
            logits = []
            for m in (None, mesh):
                model = DecoderLM(cfg, seed=0, device="cpu")
                if m is not None:
                    shard_lm(model, m)
                with torch.no_grad():
                    logits.append(model(None if "embeds" in kw else tok,
                                        mesh=m, **kw))
            plain, split = logits
            out[arch] = float((split - plain).abs().max()
                              / plain.abs().max())
        except Exception as e:          # noqa: BLE001 - reported whole
            out[arch] = f"{type(e).__name__}: {e}"
    return out


def roles_world(rank, world):
    """``shard_tensor`` and ``gather_tensor`` with roles side by side
    (``parts`` 2: [a | b]; 4: [i f z o]) over (2, 2) and (1, 4) meshes:
    per (M, parts) this rank's block and the round trip."""
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.distributed.sharding import gather_tensor, shard_tensor

    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_test_mesh(*shape)
        for parts in (2, 4):
            full = torch.arange(3 * parts * 8, dtype=torch.float32) \
                .reshape(3, parts * 8)
            local = shard_tensor(full, (None, "model"), mesh, parts)
            back = gather_tensor(local, (None, "model"), mesh, parts)
            out[(shape[1], parts)] = (mesh.index("model"), local.numpy(),
                                      bool(torch.equal(back, full)))
    return out


# ============================================== one world of each test file
def decode_world(rank, world, d, qwen_path, tokens, max_len):
    """``test_torch_dist_decode``: one layer's and the model's flash
    decode, placement, and (world 2) the pipeline."""
    res = {"layer": flash_layer_world(rank, world, f"{d}/layer.npz"),
           "model": flash_model_world(rank, world, qwen_path, tokens,
                                      max_len),
           "placement": placement_world(rank, world)}
    if world == 2:
        res["pipe"] = pipeline_world(rank, world, f"{d}/pipe.npz")
    return res


def train_world(rank, world, qwen, batches, ckpt_dir, learn_batch, combos,
                launch_argv, moe, moe_combos):
    """``test_torch_dist_train``: DP steps (and, at worlds above 1, the
    reduced DeepSeek-V2-Lite's from ``moe``); world 4 saves a checkpoint
    and runs the learning contract; world 2 restores it and runs the
    launcher."""
    res = {"dp": dp_world(rank, world, qwen, batches, combos,
                          ckpt_dir if world == 4 else None)}
    if world > 1:
        res["moe"] = dp_world(rank, world, moe, batches, moe_combos,
                              arch="deepseek-v2-lite-16b")
    if world == 4:
        res["learn"] = learn_world(rank, world, qwen, learn_batch)
    if world == 2:
        res["restore"] = restore_world(rank, world, qwen, ckpt_dir)
        res["launch"] = launcher_world(rank, world, f"{ckpt_dir}_launch",
                                       [*launch_argv, "--mesh", "2x1"])
    return res


def tp_world(rank, world, d, tokens, labels, media, steps, max_len,
             batches, learn_batch, launch_argv):
    """``test_torch_dist_tp``: the models on the world's meshes ((1, 2) at
    world 2; (2, 2) and (1, 4) at world 4); world 4 also takes the MoE
    statistics over the data group at (2, 2), trains at (2, 2) and writes
    ``d``/ckpt, ``d``/ckpt_moe and ``d``/ckpt_xlstm, which world 2
    restores at (1, 2); world 2 also checks a model axis of one rank bit
    for bit, ZeRO-1 against whole moments at (2, 1) and the launcher; each
    world shards the ten reduced configs at M = world."""
    shapes = [(1, 2)] if world == 2 else [(2, 2), (1, 4)]
    res = {"models": tp_model_world(rank, world, d, shapes, tokens, labels,
                                    media, steps, max_len)}
    qwen = f"{d}/qwen3-0.6b.npz"
    if world == 4:
        res["data_group"] = tp_data_group_world(rank, world, d, tokens,
                                                labels)
        res["train"] = tp_train_world(rank, world, d, (2, 2), batches,
                                      learn_batch, launch_argv)
    else:
        res["one_rank"] = tp_one_rank_world(rank, world, d, tokens, labels,
                                            media, steps, max_len)
        res["zero"] = zero_world(rank, world, qwen, batches)
        res["restore"] = tp_restore_world(rank, world, qwen, "qwen3-0.6b",
                                          f"{d}/ckpt", True)
        res["restore_moe"] = tp_restore_world(
            rank, world, f"{d}/{TP_TRAIN_MOE}.npz", TP_TRAIN_MOE,
            f"{d}/ckpt_moe", False)
        res["restore_xlstm"] = tp_restore_world(
            rank, world, f"{d}/{TP_XLSTM}.npz", TP_XLSTM, f"{d}/ckpt_xlstm",
            False)
        res["launch"] = launcher_world(rank, world, f"{d}/launch12",
                                       [*launch_argv, "--mesh", "1x2"])
        res["launch_arch"] = {arch: launcher_world(
            rank, world, f"{d}/launch12_{arch}",
            [*launch_argv, "--arch", arch, "--mesh", "1x2"])
            for arch in TP_LAUNCH_ARCHS}
    res["every_config"] = tp_every_config(rank, world, tokens[:, :8])
    return res


def index_world(rank, world, d, seg_cases, cfg_kw, seg_cfg_kw):
    """``test_torch_dist_index``: the placed ShardedDQF at S = world and
    (world 4) the segment search over meshes."""
    res = {"dqf": sharded_dqf_world(rank, world, f"{d}/port{world}.npz",
                                    cfg_kw)}
    if world == 4:
        res["seg"] = segments_world(rank, world, seg_cases, seg_cfg_kw)
    return res
