"""Domain-decomposed engines on ``torch.distributed`` (the counterpart of
``pypic_tpu/parallel``): ``mesh`` (the slab mesh and the bootstrap),
``domain`` (halo exchange, migration, the explicit carrier) and
``domain_implicit`` (BASELINE configs[4]), ``distributed_poisson`` (the
substructured solves) and ``spawn`` (gloo ranks on one host).
``dataparallel`` (particles split over the ranks, the fields replicated)
and ``make_mesh2`` (slabs x replicas); the bounded engines on a chain of
slabs, ``domain_sheath`` (the absorbing-wall sheath) and
``domain_magnetized`` (pic_iead, its Newton solve slab-sharded)."""

from .dataparallel import (gather_state, make_data_parallel_step,  # noqa: F401
                           shard_state)
from .mesh import (Mesh2, SlabMesh, make_mesh, make_mesh2,  # noqa: F401
                   maybe_initialize_distributed)
from . import (domain, domain_implicit, domain_magnetized,  # noqa: F401
               domain_sheath)
