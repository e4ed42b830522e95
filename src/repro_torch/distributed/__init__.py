"""Distribution of the port over ``torch.distributed``: meshes
(:mod:`repro_torch.distributed.mesh`, re-exported at the reference's path
:mod:`repro_torch.launch.mesh`), the sharding rules
(:mod:`repro_torch.distributed.sharding`), the GPipe pipeline
(:mod:`repro_torch.distributed.pipeline`) and tensor parallelism over the
model axis with ZeRO-1 (:mod:`repro_torch.distributed.tensor_parallel`)."""

from . import sharding  # noqa: F401
