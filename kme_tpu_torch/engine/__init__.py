"""Device engines (the port of `kme_tpu/engine`)."""
