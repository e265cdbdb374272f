"""Host routing errors shared by the port's routers (the port's copy of
the two exception types of `kme_tpu/runtime/sequencer.py`)."""


class CapacityError(RuntimeError):
    """The workload exceeds a static device capacity (symbols, accounts)."""


class EnvelopeError(RuntimeError):
    """A wire value falls outside the Jackson-parseable envelope (int32
    price/size) — input on which the reference's deserializer throws and
    its Streams thread dies (KProcessor.java:513-517)."""
