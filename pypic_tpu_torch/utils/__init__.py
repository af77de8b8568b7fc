"""Fixed-shape row utilities (the counterpart of ``pypic_tpu/utils``).
Ported so far: ``compact_rows``; ``pack_rows`` and ``place_rows`` come
with the BCA coupling."""

from .packing import compact_rows  # noqa: F401
