"""Host utilities of the port (mirrors dsv2_tpu/utils)."""
