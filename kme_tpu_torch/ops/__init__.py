"""Kernels shared by the engines (the port of `kme_tpu/ops`)."""
