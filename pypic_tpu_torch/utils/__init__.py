"""Fixed-shape row utilities (the counterpart of ``pypic_tpu/utils``)."""

from .packing import compact_rows, pack_rows, place_rows  # noqa: F401
