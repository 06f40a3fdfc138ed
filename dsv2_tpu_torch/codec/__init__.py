"""Codec sessions of the torch port (mirrors dsv2_tpu/codec)."""
