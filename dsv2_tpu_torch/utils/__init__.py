"""Host utilities of the port (counterparts of `dsv2_tpu/utils`)."""
