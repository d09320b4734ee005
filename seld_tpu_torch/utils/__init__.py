"""Logging and device introspection (counterpart: seld_tpu/utils)."""
