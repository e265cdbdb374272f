"""The benchmark's client of the broker's TCP protocol: a frozen copy of
the parts of `kme_tpu_torch/bridge/tcp.py`'s `TcpBroker` that the
generator and the consumer use, so that a change to the port's client
cannot move the yardstick. One JSON object per line each way:

  {"op":"produce_batch","topic":T,"records":[[k,v],...]}
                                        -> {"ok":true,"last_offset":N}
  {"op":"fetch","topic":T,"offset":N,"max":M,"timeout_ms":W}
                                        -> {"ok":true,"records":[[o,k,v,...],...]}

A fetched row is [offset, key, value], then [epoch, out_seq] where the
record carries an exactly-once stamp, then the admission stamp. The
client imports neither torch nor the program.
"""

from __future__ import annotations

import json
import socket
from typing import List

TOPIC_IN = "MatchIn"      # topic.js:17
TOPIC_OUT = "MatchOut"    # topic.js:21


class BrokerError(RuntimeError):
    pass


class Client:
    def __init__(self, host: str, port: int, timeout: float = 60.0) -> None:
        self._timeout = timeout
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def _call(self, payload: bytes, extra_wait: float = 0.0) -> dict:
        """Send one request line; return the reply."""
        self._sock.settimeout(self._timeout + extra_wait)
        self._sock.sendall(payload)
        raw = self._rfile.readline()
        if not raw.endswith(b"\n"):
            raise BrokerError("broker connection closed mid-reply")
        resp = json.loads(raw)
        if not resp.get("ok"):
            raise BrokerError(resp.get("error", "broker error"))
        return resp

    def produce_values(self, topic: str, values: List[str]) -> int:
        """Append keyless records in one round trip (the produce_batch
        op); returns the last offset."""
        req = json.dumps({"op": "produce_batch", "topic": topic,
                          "records": [[None, v] for v in values]},
                         separators=(",", ":")) + "\n"
        return self._call(req.encode())["last_offset"]

    def fetch(self, topic: str, offset: int, max_records: int,
              timeout: float) -> List[list]:
        """Rows at `offset` onwards, waiting up to `timeout` seconds
        broker-side for the first."""
        req = json.dumps({"op": "fetch", "topic": topic, "offset": offset,
                          "max": max_records, "timeout_ms": timeout * 1e3},
                         separators=(",", ":")) + "\n"
        return self._call(req.encode(), extra_wait=timeout)["records"]

