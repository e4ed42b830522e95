"""Where a train step of the port's training path spends its time.

    PYTHONPATH=src python scripts/torch_train_profile.py [--layers 28]
    PYTHONPATH=src python scripts/torch_train_profile.py --device cpu \\
        --reduced --batch 4 --seq 32

Runs ``chip_smoke.py`` phase 19 A's step (Qwen3-0.6B, bf16, remat,
microbatches 2, 16 x 1024 synthetic tokens; ``--layers`` cuts depth) for
``--warmup`` steps, then ``--steps`` steps under ``torch.profiler``, and
prints: the step's wall time (host clock, the card synchronized; the
profiler's own cost included), the device's busy time (the
sum of the kernels' own times; one stream) and its idle share, and the
top kernels and operators by device time.  On the CPU the operators'
host times stand in for the device's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (0: the config's)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.dqf import resolve_device
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import DecoderLM
    from repro_torch.training import (TrainConfig, make_train_step,
                                      train_state_init)

    dev = resolve_device(None if args.device == "cuda" else args.device,
                         what="torch_train_profile")
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = DecoderLM(cfg, seed=0, device=dev)
    tcfg = TrainConfig(microbatches=args.microbatches, peak_lr=1e-3,
                       warmup_steps=3, total_steps=30, remat=True)
    state = train_state_init(model, tcfg)
    step_fn = make_train_step(model, tcfg)
    src = make_source(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq, global_batch=args.batch))
    M = args.microbatches

    def batch_at(s):
        return {k: torch.as_tensor(v, device=dev).reshape(
            M, -1, args.seq) for k, v in src.batch(s).items()}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for s in range(args.warmup):
        state, _ = step_fn(state, batch_at(s))
    sync()
    batches = [batch_at(args.warmup + s) for s in range(args.steps)]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, metrics = step_fn(state, b)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events
           if e.device_type != torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return e.self_device_time_total if cuda else e.self_cpu_time_total

    # kernels' own times (one stream: their sum is the busy time); on the
    # CPU the operators' own host times
    busy_ms = sum(dev_us(e) for e in (kernels if cuda else ops)) / 1e3 \
        / args.steps
    smi = ""
    if cuda:
        import subprocess

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}; batch {args.batch} x {args.seq}, microbatches {M}, "
          f"remat; {dev} {smi}")
    print(f"a step: {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
          f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.4f}); loss "
          f"{float(metrics['loss']):.4f}")
    for title, group in (("kernels", kernels), ("operators", ops)):
        if not group:
            continue
        print(f"{title}:\n{'device ms a step':>17} {'share':>6} "
              f"{'calls':>7}  name")
        for e in sorted(group, key=dev_us, reverse=True)[:args.top]:
            ms = dev_us(e) / 1e3 / args.steps
            print(f"{ms:17.3f} {ms / busy_ms:6.3f} "
                  f"{e.count // args.steps:7d}  {e.key[:110]}")


if __name__ == "__main__":
    main()
