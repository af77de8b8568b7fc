"""Domain-decomposed engines on ``torch.distributed`` (the counterpart of
``pypic_tpu/parallel``): ``mesh`` (the slab mesh and the bootstrap),
``domain`` (halo exchange, migration, the explicit carrier) and
``domain_implicit`` (BASELINE configs[4]). ``dataparallel``,
``distributed_poisson``, ``domain_sheath``, ``domain_magnetized`` and the
two-axis mesh come with ROADMAP queue 1 item 17."""

from .mesh import SlabMesh, make_mesh, maybe_initialize_distributed  # noqa: F401
