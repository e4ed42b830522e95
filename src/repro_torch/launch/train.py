"""Training launcher of the port.

Wires together: config → process group and mesh → model → AdamW state →
data pipeline → train loop with async checkpointing and restart-resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 100 --batch 8 --seq 256 --ckpt-dir <dir> [--reduced]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 20 --batch 2 --seq 32

It runs on the CUDA card unless ``--device`` names another device.
Fault tolerance: kill it at any step and rerun the same command — it
resumes from the latest atomic checkpoint (params, optimizer state; the
step is the data cursor).

Data parallelism: under torchrun (or inside an initialised process
group) each rank runs this same entry point, one card a rank over NCCL
(gloo with ``--device cpu``); ``--mesh Dx1`` trains over a world of D
ranks and no ``--mesh`` spans the whole world with the data axis.  Each
rank reads its rows of the global batch (``DataConfig(num_hosts=D,
host_id=rank)``) and the step averages the gradients over the data axis
(:func:`repro_torch.training.train_step.make_train_step`); rank 0 writes
the checkpoints.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 4x1 ...

Tensor parallelism: ``--mesh DxM`` with M > 1 trains any config over a
world of D·M ranks, the model cut over the model axis
(:func:`repro_torch.distributed.tensor_parallel.shard_lm`); ranks with
the same data index read the same rows.  Any mesh places AdamW's moments
by ZeRO-1 over the data axis.  A mesh that is not the world's size raises
``ValueError`` before any process group is made.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 ...
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU demo)")
    ap.add_argument("--data", default="synthetic", choices=("synthetic",
                                                            "file"))
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--mesh", default="",
                    help="(data)x(model), their product the world's size")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
    from repro_torch.configs import get_config
    from repro_torch.core.dqf import resolve_device
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.distributed.mesh import init_distributed, make_test_mesh
    from repro_torch.distributed.tensor_parallel import shard_lm
    from repro_torch.models import DecoderLM
    from repro_torch.training.train_step import (TrainConfig,
                                                 make_train_step,
                                                 train_state_init)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    data, model_axis = None, 1
    if args.mesh:
        data, model_axis = (int(v) for v in args.mesh.split("x"))
        world = (dist.get_world_size() if dist.is_initialized() else
                 int(os.environ.get("WORLD_SIZE", "1")))
        if data * model_axis != world:
            raise ValueError(f"--mesh {args.mesh} needs a world of "
                             f"{data * model_axis} ranks; the world has "
                             f"{world}")

    dev = resolve_device(None if args.device == "cuda" else args.device,
                         what="launch.train")
    mesh, rank = None, 0
    if (data or 1) * model_axis > 1 or dist.is_initialized() or \
            "WORLD_SIZE" in os.environ:
        dev = init_distributed(dev)
        data = dist.get_world_size() if data is None else data
        mesh = make_test_mesh(data, model_axis)
        rank = mesh.index("data")

    tcfg = TrainConfig(microbatches=args.microbatches, peak_lr=args.lr,
                       warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps,
                       compress_grads=args.compress_grads,
                       remat=not args.reduced)
    model = DecoderLM(cfg, seed=0, device=dev)
    if model_axis > 1:
        shard_lm(model, mesh)
    state = train_state_init(model, tcfg, mesh=mesh)
    step_fn = make_train_step(model, tcfg, mesh=mesh)

    source = make_source(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        kind=args.data, path=args.data_path,
        num_hosts=data or 1, host_id=rank))

    start = 0
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck is not None and latest_step(args.ckpt_dir) is not None:
        state, meta = ck.restore(state)
        start = int(meta["step"])
        print(f"[train] resumed from step {start}")

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in source.batch(step).items()}
        if tcfg.microbatches > 1:
            batch = {k: v.reshape(tcfg.microbatches, -1, *v.shape[1:])
                     for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            dt = time.time() - t0
            tok_s = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"[train] step={step:5d} loss={loss:.4f} "
                  f"gnorm={gn:.3f} tok/s={tok_s:.0f}", flush=True)
        if ck is not None and (step + 1) % args.ckpt_every == 0:
            ck.save(step + 1, state, extra={"arch": args.arch})
    if ck is not None:
        ck.save(args.steps, state, extra={"arch": args.arch}, block=True)
    print("[train] done")
    return [float(v) for v in losses]


if __name__ == "__main__":
    main()
