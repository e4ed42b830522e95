"""Serving example: LM decode with DQF retrieval (kNN-LM interpolation).

A small decoder LM (Qwen3-0.6B's layout at reduced width) decodes a batch;
at each step the DQF-backed ``RetrievalService`` returns the nearest
datastore entries, whose payload tokens the ``KNNLMHead`` interpolates
into the LM distribution.  The kNN query is the embedding row of the
step's argmax token (a demo query); with ``fused=True`` every lookup runs
the ``fused_hop`` kernel on the card for its hot and full phase.  The
datastore's traffic is Zipf-skewed, so the hot index absorbs most lookups.

Run on the card (the default) or on the CPU::

    PYTHONPATH=src python -m repro_torch.examples.serve_knnlm
    PYTHONPATH=src python -m repro_torch.examples.serve_knnlm --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import DQFConfig
from repro_torch.models import DecoderLM
from repro_torch.serving.retrieval import KNNLMHead, RetrievalService


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n-store", type=int, default=5000,
                    help="datastore entries")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b"), num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=1024,
        dtype="float32", max_seq_len=512)
    model = DecoderLM(cfg, seed=0, device=args.device)

    # --- datastore: (hidden-state embedding -> next token) pairs ---------
    rng = np.random.default_rng(0)
    n_store = args.n_store
    store_embeds = rng.standard_normal((n_store, cfg.d_model)) \
        .astype(np.float32)
    store_tokens = rng.integers(0, cfg.vocab_size, n_store).astype(np.int32)
    svc = RetrievalService.build(
        store_embeds, store_tokens,
        DQFConfig(knn_k=16, out_degree=16, index_ratio=0.01, hot_pool=16,
                  full_pool=48, max_hops=200, fused=True),
        history=None, device=model.device)
    head = KNNLMHead(service=svc, vocab_size=cfg.vocab_size, lam=0.3)
    print(f"datastore: {n_store} entries, hot index {svc.dqf.hot.size}, "
          f"on {svc.device}")

    # --- batched decode with retrieval ----------------------------------
    B, steps = args.batch, args.steps
    caches = model.init_decode_caches(B, max_len=64)
    tok = torch.zeros((B, 1), dtype=torch.long, device=model.device)
    t0 = time.time()
    generated = []
    for t in range(steps):
        logits, caches = model.decode_step(tok, caches, t)
        # the demo query: the embedding row of the argmax token
        q = model.embed[logits[:, 0].argmax(-1)]
        probs = head(logits[:, 0], q)
        tok = probs.argmax(-1)[:, None]
        generated.append(tok[:, 0].cpu().numpy())
    wall = time.time() - t0
    gen = np.stack(generated, 1)
    print(f"generated {B}x{steps} tokens in {wall:.2f}s "
          f"({B * steps / wall:.1f} tok/s incl. retrieval)")
    print("sequences:\n", gen)
    stats = svc.dqf.counter.counts
    top = stats[np.argsort(-stats)[: max(n_store // 100, 1)]].sum()
    print(f"datastore hot traffic: top-1% of entries got "
          f"{top / max(stats.sum(), 1):.0%} of accesses")
    return gen, probs


if __name__ == "__main__":
    main()
