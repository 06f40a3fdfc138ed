"""Batched device pipelines of the torch port (mirrors dsv2_tpu/parallel)."""
