"""Feed subscriber client: subscribe-line handshake + frame stream.

The blocking counterpart of the server's wire contract, used by tests,
the chaos drill and `kme-torch-feed --tail`. Scale consumers (the 10k-sub
bench) drive raw nonblocking sockets instead — the wire bytes are the
same; this class is the readable reference implementation."""

from __future__ import annotations

import json
import socket
from typing import Iterator, List, Optional

from kme_tpu_torch.feed import frames as ff
from kme_tpu_torch.feed.derive import BookBuilder
from kme_tpu_torch.feed.frames import FeedFrame


def subscribe_line(symbols=None) -> bytes:
    """The one-line JSON handshake. symbols None = wildcard."""
    syms = None if symbols is None else sorted(int(s) for s in symbols)
    return (json.dumps({"op": "subscribe", "symbols": syms},
                       separators=(",", ":")) + "\n").encode()


class FeedClient:
    """Blocking subscriber: connects, handshakes, then yields decoded
    frames. `builder` (a BookBuilder) is fed every frame, so
    `client.builder.book` is always the reconstructed view."""

    def __init__(self, host: str, port: int, symbols=None,
                 timeout: float = 5.0) -> None:
        self.symbols = symbols
        self.builder = BookBuilder()
        self.frames: List[FeedFrame] = []
        self._buf = b""
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.sendall(subscribe_line(symbols))

    def recv_frames(self, max_frames: Optional[int] = None
                    ) -> Iterator[FeedFrame]:
        """Yield frames until EOF, a socket timeout, or `max_frames`.
        Every yielded frame has already been applied to the builder."""
        n = 0
        while max_frames is None or n < max_frames:
            got: List[FeedFrame] = []
            off = 0
            while True:
                length = ff.feed_frame_length(self._buf, off)
                if length is None or off + length > len(self._buf):
                    break
                f, off = ff.decode_feed(self._buf, off)
                got.append(f)
            self._buf = self._buf[off:]
            if got:
                for f in got:
                    self.builder.apply(f)
                    self.frames.append(f)
                    yield f
                    n += 1
                    if max_frames is not None and n >= max_frames:
                        return
                continue
            try:
                data = self.sock.recv(1 << 16)
            except socket.timeout:
                return
            except OSError:
                return
            if not data:
                return
            self._buf += data

    def drain(self) -> int:
        """Consume until EOF/timeout; returns frames received."""
        return sum(1 for _ in self.recv_frames())

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
