"""Domain-decomposed engines on ``torch.distributed`` (the counterpart of
``pypic_tpu/parallel``): ``mesh`` (the slab mesh and the bootstrap),
``domain`` (halo exchange, migration, the explicit carrier) and
``domain_implicit`` (BASELINE configs[4]), ``distributed_poisson`` (the
substructured solves) and ``spawn`` (gloo ranks on one host).
``dataparallel`` and the two-axis mesh come with ROADMAP queue 1 item 17a,
``domain_sheath`` and ``domain_magnetized`` with item 17b."""

from .mesh import SlabMesh, make_mesh, maybe_initialize_distributed  # noqa: F401
