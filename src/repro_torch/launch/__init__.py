"""Launch layer (``repro/launch``): the step builders, the LM training
and serving launchers, a launched job's environment, device meshes
(one process a device), FedPhD's hierarchy on a mesh and the sharding
rules.  Expert parallelism and the dry run are not ported yet (ROADMAP
A.13)."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_host_mesh"]
