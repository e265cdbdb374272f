"""Parallelism: the seq fleet (`seqmesh.py`) and the sharded lanes engine
(`mesh.py`).

The port of `kme_tpu/parallel/`. The JAX package shards the symbol axis
over a device mesh with `shard_map`; the port keeps one set of state
tensors per shard on the session's device and gives each shard its own
CUDA stream, so the shards' kernels run side by side on one card. The
merges that the reference writes as `psum` / `pmax` collectives are
written out on tensors after the shard streams are joined.
"""
