"""Wire opcodes of the reference (KProcessor.java:65-75): the benchmark's
own copy, shared by its generator, its reference and its byte count."""

ADD_SYMBOL = 0
REMOVE_SYMBOL = 1
BUY = 2
SELL = 3
CANCEL = 4
BOUGHT = 5
SOLD = 6
REJECT = 7
CREATE_BALANCE = 100
TRANSFER = 101
PAYOUT = 200
