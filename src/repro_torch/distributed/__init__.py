"""Distribution of the port over ``torch.distributed``: meshes
(:mod:`repro_torch.distributed.mesh`, re-exported at the reference's path
:mod:`repro_torch.launch.mesh`), the sharding rules
(:mod:`repro_torch.distributed.sharding`) and the GPipe pipeline
(:mod:`repro_torch.distributed.pipeline`)."""

from . import sharding  # noqa: F401
