"""kme_tpu_torch — the matching engine ported to PyTorch and CUDA.

A second package beside `kme_tpu` (the JAX/Pallas reference, which it
never imports). It mirrors `kme_tpu`'s module names so each counterpart
is easy to find; every Pallas kernel on a ported path becomes a kernel
written by hand for an NVIDIA Hopper card (`csrc/`), with a plain
PyTorch version beside it that runs on CPU tensors.

Ported so far, each from wire JSON to MatchOut lines: the sequential
matching engine in fixed and java mode (`runtime/seqsession.py` over
`engine/seq.py` and `csrc/seq_step.cu`), serially or pipelined
(`submit`/`collect`), and the sweep (lanes) engine on one device
(`runtime/session.py` over `runtime/sequencer.py`, `engine/lanes.py`,
`ops/rowdma.py` and `csrc/rowdma.cu`); both over the native host runtime
copied from `kme_tpu` (`native/`: router, scheduler, batch plan, wire
parser and MatchOut reconstructor in C++). Around them: checkpoints
whose files restore across packages (`runtime/checkpoint.py`,
`runtime/javasnap.py`), the host engines (`oracle/`, `native/oracle.py`)
and the serving stack (`bridge/`: broker, TCP, `MatchService`, `serve`)
with its CLI (`cli.py`). Entry points run on the card unless the caller
passes `device="cpu"`.
"""
