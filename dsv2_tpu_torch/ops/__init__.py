"""Device ops of the torch port (mirrors dsv2_tpu/ops)."""
