"""Host sessions and routers (the port of `kme_tpu/runtime`)."""
