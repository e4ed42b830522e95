"""Async, atomic checkpointing of a port ``TrainState``.

The reference's contract:

* **atomic**: writes go to ``<dir>/tmp.<step>``, ``meta.json`` is fsynced,
  and the directory is renamed to ``<dir>/step_<step>``: a crash mid-write
  never corrupts the latest checkpoint, and a ``tmp.*`` never counts;
* **async**: the device→host copy happens on the caller's thread, the
  ``.npz`` and its rename on a background thread, one save in flight at a
  time, so the train loop runs on while the file is written;
* the newest ``keep`` checkpoints are kept;
* ``restore(template)`` checks every key and shape before it writes.

The arrays are the reference checkpoint's: the flat keys of its
``_flatten`` (``.params['blocks']['dense']['attn']['wq']`` of shape
``(n_dense, ...)``, ``.opt.step``, ``.opt.m[...]``, ``.opt.v[...]``,
``.err[...]``; :func:`repro_torch.convert.train_state_leaves`), so one
loader (:func:`repro_torch.convert.train_state_from_arrays`) reads a
checkpoint of either package.  A bfloat16 leaf is stored as its 16 bits
(``uint16``) and ``meta.json`` names each leaf's dtype under ``dtypes``.
The data cursor is the step: the data pipeline is stateless.

Inside an initialised process group of more than one rank (data
parallelism keeps the state replicated) every rank calls ``save`` and
``restore``: the ranks
meet at a barrier, rank 0 alone writes, and a blocking save ends at a
second barrier, after the directory is published; every rank restores
from the same files, so a checkpoint written by a world of 4 restores
onto a world of 2 bit for bit.  A sharded state (tensor parallelism over
the model axis, ZeRO-1 moments over the data axes) is first gathered
whole on every rank (:func:`repro_torch.distributed.tensor_parallel.
whole_state`), so rank 0 writes whole tensors under the reference's keys
and a checkpoint does not depend on the mesh; ``restore`` cuts each
whole leaf into the blocks of the mesh it runs on.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.convert import (load_train_state_, train_state_leaves,
                                 train_state_to_arrays)

__all__ = ["Checkpointer", "latest_step"]


def _group():
    """``torch.distributed`` when a process group of more than one rank
    is initialised, else None."""
    import torch.distributed as dist
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return dist
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


class Checkpointer:
    """``save`` / ``wait`` / ``restore`` over ``directory``.  After a save
    has been waited for, ``last_blocked_s`` is the seconds the caller was
    held (the device→host copy) and ``last_save_s`` the seconds from the
    call to the published directory; ``last_bytes`` is the arrays'
    bytes."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_blocked_s = self.last_save_s = 0.0
        self.last_bytes = 0

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, extra: Optional[dict] = None,
             block: bool = False) -> None:
        """Snapshot (device→host now, IO async); over a process group
        rank 0 writes after a barrier (see the module docstring)."""
        self.wait()                         # one in-flight save at a time
        from repro_torch.distributed import tensor_parallel as tpar

        t0 = time.perf_counter()
        whole = tpar.whole_state(state) if tpar.is_sharded(state) else None
        dist = _group()
        if dist is not None:
            dist.barrier()
            if dist.get_rank() != 0:
                if block:
                    dist.barrier()
                return
        host = train_state_to_arrays(state, whole)
        meta = {"step": step, "time": time.time(),
                "dtypes": {k: str(ts[0].dtype).removeprefix("torch.")
                           for k, (ts, _) in
                           train_state_leaves(state, whole).items()},
                **(extra or {})}
        del whole
        self.last_blocked_s = time.perf_counter() - t0
        self.last_bytes = sum(a.nbytes for a in host.values())

        def work():
            try:
                tmp = os.path.join(self.dir, f"tmp.{step}")
                final = os.path.join(self.dir, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **host)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)       # atomic publish
                self._gc()
                self.last_save_s = time.perf_counter() - t0
            except BaseException as e:      # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()
            if dist is not None:
                dist.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint failed") from err

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def restore(self, template, step: Optional[int] = None):
        """Restore into ``template`` (a ``TrainState``: its tensors are
        overwritten in place, on their own device) and return
        ``(template, meta)``."""
        step = step if step is not None else latest_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(final, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(final, "arrays.npz")) as arrays:
            load_train_state_(template, arrays)
        return template, meta
