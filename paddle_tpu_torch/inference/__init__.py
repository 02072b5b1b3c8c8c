"""Inference of the port (counterpart of ``paddle_tpu/inference``)."""
