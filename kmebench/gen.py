"""The generator child: makes the configuration's stream from the seed
(`streams.py`) and produces it to MatchIn over TCP under the cell's
traffic mix (`arrivals.py`), each produce call carrying the messages due
in one tick, as a Kafka producer batches under `linger.ms`.

Set-up: the stream's preamble and a warm prefix of `warm` events go out
closed-loop with 8 batches outstanding, and the child waits until every
one of them is answered (the consumer's closed count on
`--progress-fd`), then prints `WARM` and waits for `GO <t0>` on stdin,
t0 on the monotonic clock that the consumer stamps with too.

The window, [t0, t0 + seconds): each message goes out at the first tick
at or after its due time (a mix with arrivals) or as soon as the mix's
outstanding bound lets it (a closed loop, until the window closes),
never more outstanding at the consumer than the mix allows and never
more in one call than it allows. A scheduled message is timed from its
due time, so a late send counts in its latency; how late the sends ran
is reported.

At the end it prints one JSON line: the messages produced in all, those
of the window, and the lateness of a scheduled mix. It imports no torch.

Run: python -m kmebench.gen --addr HOST:PORT --job JSON --progress-fd FD
"""

from __future__ import annotations

import argparse
import json
import math
import os
import select
import struct
import sys
import time

import numpy as np

from kmebench.client import TOPIC_IN, BrokerError, Client
from kmebench import arrivals as A
from kmebench.streams import MessageStream, encode


class Stopped(Exception):
    """The server went away after `sent` messages of a loop."""

    def __init__(self, sent: int, cause: BaseException) -> None:
        super().__init__(f"stopped after {sent} messages: {cause}")
        self.sent = sent


def _produce(cli, values, sent: int) -> None:
    try:
        cli.produce_values(TOPIC_IN, values)
    except (OSError, BrokerError) as e:
        raise Stopped(sent, e) from e


class Progress:
    """The consumer's newest closed-message count."""

    def __init__(self, fd: int) -> None:
        self.fd = fd
        self.n = 0
        self._buf = b""
        os.set_blocking(fd, False)

    def poll(self, wait: float = 0.0) -> int:
        if wait > 0:
            select.select([self.fd], [], [], wait)
        while True:
            try:
                chunk = os.read(self.fd, 65536)
            except BlockingIOError:
                break
            if not chunk:
                break
            self._buf += chunk
        whole = len(self._buf) // 8 * 8
        if whole:
            self.n = struct.unpack_from("<q", self._buf, whole - 8)[0]
            self._buf = self._buf[whole:]
        return self.n


def send(cli, stream, prog, *, offs=None, t0=0.0, until=None, total=None,
         cap=A.UNBOUNDED, per_call=A.UNBOUNDED, tick=1e-3):
    """Produce messages, message i no earlier than t0 + offs[i] (without
    `offs`, as soon as allowed), keeping at most `cap` unanswered and at
    most `per_call` in one call. Stops after `total` messages, after the
    last of `offs`, or at the monotonic time `until`. Returns how many
    went out and, with `offs`, each one's lateness (s) against its due
    time."""
    n = len(offs) if offs is not None else total
    late = np.zeros(n) if offs is not None else None
    sent = 0
    while n is None or sent < n:
        now = time.monotonic()
        if until is not None and now >= until:
            break
        if offs is not None:
            due = int(np.searchsorted(offs, now - t0, side="right"))
        else:
            due = n if n is not None else sent + per_call
        room = cap - (sent - prog.n)
        k = min(due - sent, room, per_call)
        if k > 0:
            vals = encode(stream.take(k))
            if late is not None:
                late[sent:sent + k] = now - (t0 + offs[sent:sent + k])
            _produce(cli, vals, sent)
            sent += k
            prog.poll()
        elif room <= 0:
            wait = 0.05 if until is None else max(0.0, min(0.05,
                                                          until - now))
            prog.poll(wait)
        else:
            # the tick boundary at which the next message is due
            wake = t0 + math.ceil(offs[sent] / tick) * tick
            time.sleep(max(0.0, wake - time.monotonic()))
    return sent, late


def window(cli, stream, prog, mix, params, seed, batch, t0, seconds,
           report) -> int:
    """The measured window; returns the messages it sent."""
    offs = A.due_offsets(mix, params, seed, seconds)
    time.sleep(max(0.0, t0 - time.monotonic()))
    kw = dict(cap=A.outstanding(mix, batch), per_call=A.per_call(mix, batch),
              tick=A.tick_s(mix), t0=t0)
    if offs is None:
        n, _ = send(cli, stream, prog, until=t0 + seconds, **kw)
        return n
    n, late = send(cli, stream, prog, offs=offs, **kw)
    if len(offs):
        q = np.percentile(late, [50, 99, 100]) * 1e3
        report["late_ms"] = {"p50": float(q[0]), "p99": float(q[1]),
                             "max": float(q[2])}
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmebench.gen")
    p.add_argument("--addr", required=True)
    p.add_argument("--job", required=True,
                   help="JSON: stream, traffic, params, seed, seconds, "
                        "batch, warm")
    p.add_argument("--progress-fd", type=int, required=True)
    a = p.parse_args(argv)
    job = json.loads(a.job)
    host, port = a.addr.rsplit(":", 1)
    cli = Client(host, int(port))
    prog = Progress(a.progress_fd)
    stream = MessageStream(job["stream"], job["seed"])
    traffic, params = job["traffic"], job["params"]
    batch = int(job["batch"])
    seconds = float(job["seconds"])
    try:
        # set-up: a failure here ends the child, and the run with it
        warm_total = stream.preamble_len + int(job["warm"])
        send(cli, stream, prog, total=warm_total, cap=8 * batch,
             per_call=batch)
        while prog.poll(0.05) < warm_total:
            pass
        print("WARM", flush=True)
        t0 = float(sys.stdin.readline().split()[1])
        report = {"warm": warm_total}
        try:
            n = window(cli, stream, prog, traffic, params, job["seed"],
                       batch, t0, seconds, report)
        except Stopped as e:
            # what went out; the harness judges what never came back
            print(f"kmebench.gen: {e}", file=sys.stderr)
            n = e.sent
            report["error"] = str(e)
        report.update(window=n, produced=warm_total + n)
    finally:
        cli.close()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
