"""Golden scalar oracle: a quirk-faithful pure-Python replica of the
reference matching-engine semantics (KProcessor.java:63-445), used as the
parity judge for the TPU engine. See oracle/engine.py."""

from kme_tpu_torch.oracle.engine import OracleEngine, ReferenceHang  # noqa: F401
