"""Serving engines of the port: continuous batching of a query stream.

:class:`~repro_torch.serving.engine.WaveEngine` holds a fixed wave of
lanes; :class:`~repro_torch.serving.paged_engine.PagedWaveEngine` keeps
per-lane state in slot arrays and the ``seen`` bitmaps in a page pool
(:mod:`repro_torch.serving.paged`).  Both refill lanes through the stacked
multi-tenant hot phase and tick through the fused hop kernel (dense or
paged mode); :mod:`repro_torch.serving.status` holds the shared result
statuses and admission control.
"""
