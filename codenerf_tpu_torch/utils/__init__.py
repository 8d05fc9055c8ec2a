"""Logging (counterpart of ``codenerf_tpu/utils``)."""
