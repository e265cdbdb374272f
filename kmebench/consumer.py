"""The consumer child: reads MatchOut over TCP from offset 0, as
`consumer.js` does, and keeps for every record an 8-byte digest of its
`<key> <value>` line, whether it closes a message, and its exactly-once
stamp; for every fetch the monotonic time its reply arrived.

A message's records end with its result echo: an OUT record whose action
is not BOUGHT (5) or SOLD (6), which only fills carry. The running count
of closed messages goes to the generator through `--progress-fd` (8-byte
little-endian counts), so the closed-loop mix can keep its window. After
the harness writes `EXPECT <n>` on stdin, the consumer reads until n
messages are closed, then once more for 0.2 s to catch stray records,
writes its arrays to `--out` and prints `DONE`. It imports no torch.

Run: python -m kmebench.consumer --addr HOST:PORT --out FILE.npz
         [--progress-fd FD]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import select
import struct
import sys
import time

import numpy as np

from kmebench.client import TOPIC_OUT, BrokerError, Client

FETCH_MAX = 8192
POLL_S = 0.05
TAIL_S = 0.2
DEADLINE_S = 60.0   # after EXPECT: what never comes by then is unanswered


def is_close(key: str, value: str) -> bool:
    """Whether a MatchOut record is a message's closing result echo."""
    if key != "OUT":
        return False
    # values start with {"action":N, (the Jackson field order)
    return not (value[10] in "56" and value[11] == ",")


def digest(key: str, value: str) -> bytes:
    return hashlib.blake2b(f"{key} {value}".encode(),
                           digest_size=8).digest()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmebench.consumer")
    p.add_argument("--addr", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--progress-fd", type=int, default=None)
    a = p.parse_args(argv)
    host, port = a.addr.rsplit(":", 1)
    cli = Client(host, int(port))
    if a.progress_fd is not None:
        os.set_blocking(a.progress_fd, False)
    digests = bytearray()
    closes = bytearray()
    stamps: list = []
    fetch_t: list = []
    fetch_n: list = []
    off = 0
    nclosed = 0
    expect = None
    deadline = None
    stdin = sys.stdin.buffer
    pending = b""

    def take(rows, t) -> int:
        """Keep a fetch's records; returns how many messages it closed."""
        fetch_t.append(t)
        fetch_n.append(len(rows))
        n = 0
        for row in rows:
            k, v = row[1], row[2]
            digests.extend(digest(k, v))
            c = is_close(k, v)
            closes.append(c)
            n += c
            stamps.append(row[4] if len(row) > 4 and row[4] is not None
                          else -1)
        return n

    try:
        while True:
            rows = cli.fetch(TOPIC_OUT, off, FETCH_MAX, POLL_S)
            t = time.monotonic()
            if rows:
                off += len(rows)
                before = nclosed
                nclosed += take(rows, t)
                if a.progress_fd is not None and nclosed != before:
                    try:
                        os.write(a.progress_fd, struct.pack("<q", nclosed))
                    except BlockingIOError:
                        pass   # the generator reads only the newest count
                    except BrokenPipeError:
                        os.close(a.progress_fd)   # the generator is done
                        a.progress_fd = None
            if expect is None and select.select([stdin], [], [], 0)[0]:
                pending += os.read(stdin.fileno(), 256)
                if b"\n" in pending:
                    expect = int(pending.split()[1])
                    deadline = t + DEADLINE_S
            if expect is not None and (nclosed >= expect or t > deadline):
                break
        # records that arrive after the last expected close are extras
        while True:
            rows = cli.fetch(TOPIC_OUT, off, FETCH_MAX, TAIL_S)
            if not rows:
                break
            off += len(rows)
            take(rows, time.monotonic())
    except (OSError, BrokerError) as e:
        # the server is gone: what never came is unanswered
        print(f"kmebench.consumer: {e}", file=sys.stderr)
    finally:
        cli.close()
    np.savez(a.out,
             digests=np.frombuffer(bytes(digests), dtype="<u8"),
             closes=np.frombuffer(bytes(closes), dtype=np.uint8),
             stamps=np.asarray(stamps, dtype=np.int64),
             fetch_t=np.asarray(fetch_t, dtype=np.float64),
             fetch_n=np.asarray(fetch_n, dtype=np.int64))
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
