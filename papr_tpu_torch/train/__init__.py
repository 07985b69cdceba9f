"""Rendering entry points (counterpart of ``papr_tpu/train``)."""
