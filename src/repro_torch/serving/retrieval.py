"""DQF as the retrieval service of an LM serving stack (kNN-LM glue).

The LM side produces query embeddings at each decode step; DQF serves
neighbours from a datastore of (embedding → token) pairs.  The torch
counterpart of the reference's ``serving/retrieval.py``: the same
interface, on tensors on the service's device (the card unless the
service was built with ``device="cpu"``), so a decode loop on the card
hands its queries to the search and takes the mixed distribution back
without a copy to the host.  With ``DQFConfig(fused=True)`` every lookup
runs the hand-written ``fused_hop`` kernel for its hot and its full phase.

:class:`KNNLMHead` is the classic kNN-LM interpolation
    p(y) = λ · softmax_knn(y) + (1 − λ) · p_LM(y)
with softmax_knn built from the retrieved neighbours' distances.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import DQF, DQFConfig

__all__ = ["RetrievalService", "KNNLMHead"]


@dataclasses.dataclass
class RetrievalService:
    """Owns a DQF over an embedding datastore and its payload table."""

    dqf: DQF
    payload: torch.Tensor        # (n,) int32 on the DQF's device

    @classmethod
    def build(cls, embeddings: np.ndarray, payload,
              cfg: Optional[DQFConfig] = None,
              history: Optional[np.ndarray] = None, *,
              device=None) -> "RetrievalService":
        dqf = DQF(cfg or DQFConfig(), device=device).build(
            np.ascontiguousarray(embeddings, np.float32))
        if history is not None:
            dqf.warm(history)
        else:
            # neutral warm-up: uniform counts → hot set = arbitrary head
            dqf.counter.record(np.arange(min(dqf.hot_size * 4,
                                             embeddings.shape[0])))
            dqf.rebuild_hot()
        return cls(dqf=dqf, payload=torch.as_tensor(
            np.asarray(payload, np.int32), device=dqf.device))

    @property
    def device(self) -> torch.device:
        return self.dqf.device

    def lookup(self, query_embeddings):
        """(payload tokens, dists, ids), each (B, k), of the queries'
        neighbours; an id past the payload (the search's sentinel) reads
        the last payload entry, as the reference's clamp does."""
        res = self.dqf.search(query_embeddings)
        safe = torch.clamp(res.ids, max=self.payload.shape[0] - 1)
        return self.payload[safe.long()], res.dists, res.ids


@dataclasses.dataclass
class KNNLMHead:
    service: RetrievalService
    vocab_size: int
    lam: float = 0.25
    temperature: float = 10.0

    def __call__(self, lm_logits, query_embeddings) -> torch.Tensor:
        """Interpolate LM logits with retrieved-neighbour token mass."""
        tokens, dists, _ = self.service.lookup(query_embeddings)  # (B, k)
        return self.mix(lm_logits, tokens, dists)

    def mix(self, lm_logits, tokens: torch.Tensor, dists: torch.Tensor
            ) -> torch.Tensor:
        """The interpolation of one lookup's (tokens, dists) into the LM's
        distribution: (B, vocab) float32 on the service's device."""
        w = torch.exp(-dists / self.temperature)
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
        p_knn = torch.zeros((tokens.shape[0], self.vocab_size),
                            dtype=torch.float32, device=w.device)
        p_knn.scatter_add_(1, tokens.long(), w)
        p_lm = torch.as_tensor(lm_logits, device=w.device).float()
        p_lm = torch.exp(p_lm - p_lm.amax(dim=-1, keepdim=True))
        p_lm = p_lm / p_lm.sum(dim=-1, keepdim=True)
        return self.lam * p_knn + (1.0 - self.lam) * p_lm
