"""End-to-end training: train a small LM for a few hundred steps.

Uses the port's training path: a ``DecoderLM``, AdamW, deterministic
resumable data, async checkpointing.  The demo preset trains a ~6M-param
qwen3-family model sized for a CPU; ``--preset full`` is the
~100M-param, few-hundred-step configuration (run it on the card).  Exit
code 0 when the loss fell by more than 0.5 nats (``LEARNED``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
          [--preset demo|full] [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.models import DecoderLM
from repro_torch.training.train_step import (TrainConfig, make_train_step,
                                             train_state_init)


def preset(name: str):
    base = get_config("qwen3-0.6b")
    if name == "demo":      # ~6M params
        cfg = dataclasses.replace(
            base, num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
            head_dim=64, d_ff=1024, vocab_size=4096, dtype="float32",
            max_seq_len=512)
        return cfg, dict(steps=150, batch=8, seq=128, lr=5e-3)
    cfg = dataclasses.replace(  # ~100M params
        base, num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=32_768, dtype="bfloat16")
    return cfg, dict(steps=300, batch=32, seq=1024, lr=1e-3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="demo", choices=("demo", "full"))
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--steps", type=int, default=None,
                    help="override the preset's step count")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg, hp = preset(args.preset)
    if args.steps is not None:
        hp["steps"] = args.steps

    model = DecoderLM(cfg, seed=0, device=None if args.device == "cuda"
                      else args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"== training {cfg.name}-{args.preset}: {n_params / 1e6:.1f}M "
          f"params, {hp['steps']} steps on {model.device} ==")

    tcfg = TrainConfig(microbatches=1, peak_lr=hp["lr"],
                       warmup_steps=hp["steps"] // 10,
                       total_steps=hp["steps"], remat=False)
    state = train_state_init(model, tcfg)
    step_fn = make_train_step(model, tcfg)
    source = make_source(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=hp["seq"],
                                    global_batch=hp["batch"]))
    ck = Checkpointer(args.ckpt_dir)
    t0 = time.time()
    first = None
    for step in range(hp["steps"]):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in source.batch(step).items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        if step % 10 == 0 or step == hp["steps"] - 1:
            tok_s = (step + 1) * hp["batch"] * hp["seq"] / (time.time() - t0)
            print(f"step={step:4d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} tok/s={tok_s:.0f}")
        if (step + 1) % 50 == 0:
            ck.save(step + 1, state)
    ck.wait()
    print(f"\nloss {first:.3f} -> {loss:.3f} "
          f"({'LEARNED' if loss < first - 0.5 else 'check hyperparams'})")
    return 0 if loss < first - 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
