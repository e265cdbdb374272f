"""Market-data read path (the port of `kme_tpu/feed/`): deterministic
book-delta derivation from the MatchOut stream, depth snapshots served
off the checkpoint machinery, and a TCP fan-out tier (`kme-torch-feed`).

The write path never changes: feed frames are derived FROM MatchOut
records and ride on their own sockets, so MatchIn/MatchOut bytes are
untouched (COMPAT.md — the reference has no read path at all).
"""

from kme_tpu_torch.feed.frames import (FEED_DELTA, FEED_DEPTH, FEED_RESYNC,
                                 FEED_SNAP_BEGIN, FEED_SNAP_END,
                                 FEED_TOB, FeedFrame, FeedFrameError,
                                 decode_feed_frames)
from kme_tpu_torch.feed.derive import (BookBuilder, BookState, FeedDeriver,
                                 books_from_oracle, canonical_books)

__all__ = [
    "FEED_DELTA", "FEED_TOB", "FEED_DEPTH", "FEED_SNAP_BEGIN",
    "FEED_SNAP_END", "FEED_RESYNC", "FeedFrame", "FeedFrameError",
    "decode_feed_frames", "BookBuilder", "BookState", "FeedDeriver",
    "books_from_oracle", "canonical_books",
]
