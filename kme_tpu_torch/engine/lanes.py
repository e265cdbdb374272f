"""Lane act codes, sticky error codes, metric and histogram constants.

The port's copy of the constants of `kme_tpu/engine/lanes.py` (:60-111)
that the sequential kernel shares with the sweep engine. The sweep
engine itself is a later slice of the port; until then this module
holds constants only.
"""

# dense lane op codes (host-side routers pack these)
L_NOP = 0
L_BUY = 1
L_SELL = 2
L_CANCEL = 3
L_CREATE = 4
L_TRANSFER = 5
L_ADD_SYMBOL = 6

# lane error codes (sticky, per call). Book/fill CAPACITY overflow is
# NOT an error: it is a per-message REJECT (the envelope policy). Only
# the per-call fill buffer bound is a sticky error.
LERR_OK = 0
LERR_FILLBUF_FULL = 3  # fill buffer of one call exhausted (fill_cap knob)

# on-device metrics counters
MET_MSGS = 0            # device-executed messages (non-NOP)
MET_TRADES_OK = 1       # accepted BUY/SELL
MET_FILLS = 2           # fill events (maker count)
MET_CONTRACTS = 3       # contracts traded (sum of fill sizes)
MET_REJ_CAPACITY = 4    # envelope rejects
MET_REJ_RISK = 5        # margin/validation rejects
MET_RESTED = 6          # orders appended to a book
MET_CANCELS_OK = 7
MET_REJ_CANCEL = 8
MET_TRANSFERS_OK = 9
MET_REJ_OTHER = 10      # failed create/transfer/add_symbol
MET_BARRIERS = 11       # payout/remove settles executed
N_METRICS = 12

METRIC_NAMES = ("msgs", "trades_ok", "fills", "contracts", "rej_capacity",
                "rej_risk", "rested", "cancels_ok", "rej_cancel",
                "transfers_ok", "rej_other", "barriers")

# on-device distribution histograms: power-of-two buckets. Bucket index
# for value v is #{k in 0..14 : v >= 2^k}: v <= 0 -> bucket 0, v == 1 ->
# 1, v in [2^(i-1), 2^i) -> i, v >= 2^14 -> 15.
HIST_FILLS = 0        # makers swept per ACCEPTED trade (0 = pure rest)
HIST_DEPTH = 1        # resting orders (both sides) in the touched book
#                       after each accepted trade/cancel
HIST_OCCUPANCY = 2    # non-NOP messages per kernel call; empty calls
#                       are unobserved
N_HIST = 3
N_HIST_BUCKETS = 16

HIST_NAMES = ("fills_per_order", "book_depth", "batch_occupancy")
