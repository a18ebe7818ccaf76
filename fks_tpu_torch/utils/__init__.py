"""Host-side helpers shared across the port (fks_tpu.utils counterparts)."""
