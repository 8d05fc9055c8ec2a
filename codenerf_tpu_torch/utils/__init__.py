"""Logging (counterpart of ``codenerf_tpu/utils``) and the span recorder
(``trace``)."""
