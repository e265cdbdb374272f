"""The sticky device error type (the port's copy of `LaneEngineError`
and its name table from `kme_tpu/runtime/session.py`, with the seq
kernel's codes that `kme_tpu/runtime/seqsession.py` registers)."""

from kme_tpu_torch.engine import lanes as L

LERR_HASH_FULL = 4     # position hash exhausted (pos_cap knob)
LERR_JAVA_DOMAIN = 5   # java mode: price/size outside the device domain
LERR_JAVA_CAP = 6      # java mode: slots/max_fills device bound exceeded

_LERR_NAMES = {
    L.LERR_FILLBUF_FULL: "session fill log exhausted (fill_buffer knob)",
    LERR_HASH_FULL: "position hash exhausted (pos_cap knob)",
    LERR_JAVA_DOMAIN:
        "java mode: price/size outside the device domain (the reference "
        "runs unvalidated fields; this stream needs the native engine)",
    LERR_JAVA_CAP:
        "java mode: device capacity exceeded (reference stores are "
        "unbounded -- raise slots/max_fills or use the native engine)",
}


class LaneEngineError(RuntimeError):
    def __init__(self, code: int) -> None:
        self.code = int(code)
        super().__init__(
            f"lane engine error: {_LERR_NAMES.get(self.code, self.code)}")
