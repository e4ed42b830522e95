"""Device meshes, at the reference's path (``repro/launch/mesh.py``): the
definitions are in :mod:`repro_torch.distributed.mesh`."""

from repro_torch.distributed.mesh import (Mesh, init_distributed,  # noqa: F401
                                          make_production_mesh,
                                          make_test_mesh)

__all__ = ["Mesh", "make_production_mesh", "make_test_mesh",
           "init_distributed"]
