"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the whole run (one card)

Drives the port's main paths — wire JSON -> a session -> the CUDA
kernels -> MatchOut lines — at full width (the seq fleet and the sharded
lanes engine too, phase 11; the service with its observability on, phase
12; a multi-leader deployment of group services and the feed, phase 13;
the failover drills, a hot standby and a supervisor, phase 14; the chaos
harness's drills against supervised card children, phase 15; its
multi-leader and feed drills, the Kafka transport and the host-only
tools, phase 16; the serial parity replica and the lint gate, phase 17;
perfgate and `kme-torch-prof --diff` over TSDB stores and artifacts the
card's services wrote, phase 18; the benchmark's seq suite and its gate,
phase 19), and holds each kernel bit for
bit against its plain PyTorch version. Four paths: three through
SeqSession and the seq_step kernel, one per configuration, each three
ways (process_wire's Python line builder; the native host path serially,
process_wire_buffer over WireBatches of 1024 parsed natively; and the
native host path pipelined, submit/collect at depth 2): the
`kme-serve` defaults (B1: fixed mode, 1024 symbols, 4096 accounts, 128
slots, 16 max fills, 1024-message batches), the same at `--slots 8192`
(B3: deep books, which the service turns on above 512 slots) and
`kme-serve --compat java --slots 8192` (B2 with B3); and `kme-serve
--engine lanes` at its defaults (width 8): LaneSession replaying a CUDA
graph of the sweep step, whose position rows of both planes move through
one launch of each row-copy kernel per step (B4 gather, B5 scatter, in
their (2, joined) instantiation), planned by the native scheduler.
Phases, in order; any failure exits non-zero:

1. card and build: the card's name and power limit, a fresh build of
   both kernel sources (one nvcc each, started together), each source's
   sha256 and ptxas report (registers, shared memory and spills of every
   kernel), and the host runtime (g++, built at first use);
2. small: a small stream through a session on the card and one on the
   CPU (plain version) must give the same MatchOut lines and planes;
2b. small java: the same for the java harness stream, java mode at 256
   slots (Q1 symbol 0, Q2, Q9, Q11), all 25 planes;
3. B1 vs plain at full width: the zipf stream's JSON parsed twice, line
   by line with parse_order and as one buffer by the native parser
   (WireBatch.parse_buffer), timed, with identical columns; three
   batches of the stream (the first with trades, one with a PAYOUT, the
   last) must leave bit-identical state planes, header rows and used
   fill prefix; so must one full-width batch of a low-deposit stream,
   where the margin check rejects orders;
4. B1 main path: the stream end to end through process_wire's Python
   line builder (`_use_native_wire` off), with the kernel's launch
   count held to the dispatch count (and the rows-in-use kernel's: one
   per dispatch at more than one row per side, none at one), and its
   MatchOut to every earlier run's; then the native host path on fresh
   sessions with the counts set to 0 before each: serially (the native
   router asserted, no buffer call giving None) and pipelined at depth
   2, each with the Python path's MatchOut, launches = dispatches, its
   phases (plan_s, stage_s, dispatch_s, fetch_s, recon_s), the kernel's
   share of the wall (CUDA events around each seq_scan), and for the
   pipeline its h2d_overlap_frac (at least 0.5) and
   measured_overlap_frac; then a timed replay of the same dispatches
   (CUDA events around the whole call, the rows-in-use launch included)
   with each dispatch's byte bound and the rows in use of the book
   sides it touched;
3b. B3 at 8192 slots: phase 3's three checks on the same stream (and the
   rows-in-use kernel against its plain version on each checked state),
   then its main path as in phase 4 (the native serial and pipelined
   runs included), with the capacity rejects beside phase 4's;
3c. B2 with B3, java mode at 8192 slots, on the java zipf stream: three
   checked batches as in 3b (the first with trades holds a Q2 ghost
   fill), then the main path, whose MatchOut must be the java oracle's
   (line count and sha256 below), and the end state's open orders and
   positions; then the native serial and pipelined runs (java mode keeps
   the Python router, the reconstruction is native), with the oracle's
   MatchOut;
3d. a deep book, which the zipf streams never build: one symbol rested
   3000 orders deep on one side (24 rows, past the 16 a trade stages),
   cancelled from the top rows, swept across rows, wiped by a PAYOUT and
   rested again (java mode: without the barrier), at full width and 8192
   slots: every dispatch bit for bit against the plain version, and the
   rows-in-use kernel against its plain version on every state; then the
   rows-in-use kernel timed alone beside its plain version and its byte
   bound;
6. B4/B5 vs plain at full width, all four instantiations: seeded
   (1025, 64, 128) int32 planes and 8 lanes with repeated scrap lanes;
   (1, planar): gather output and scattered plane, (2, joined): both
   planes' int64 blocks and both scattered planes, bit-identical to the
   plain versions;
6b. lanes vs plain at full width: the zipf stream through a card
   LaneSession (its steps replayed from the step graph) until two
   windows are checked — the first with trades and the first after a
   PAYOUT — each also run from the same pre-state by the eager chunk
   function on the card and in a CPU session: packed outputs, used fill
   prefix and canonical state identical;
7. lanes main path: the session's scheduler must be the native one; the
   step graph captured for a fresh session, then the
   whole zipf stream through LaneSession.process_wire with every launch
   count set to 0 just before; its MatchOut must equal B1's (line count
   and sha256 from phase 4), its open orders, positions and capacity
   rejects B1's; no sticky error, no negative balance; launches of each
   (2, joined) kernel = the padded scan steps (graph replays counted),
   none of the (1, planar) ones, no second capture; the capture and
   replay costs; then the last window, replayed from the state before
   the last batch, checked as in 6b; then that batch under
   torch.profiler (device busy share, device ms per padded step, and
   the step's device time by kernel name);
8. B4/B5 timed, each instantiation: CUDA-event device time per launch
   at 8 rows of 32 KiB per plane (kernel, plain version on the card,
   library call) back to back, and the kernel in a CUDA graph of 100
   launches, with the byte bounds;
10. serving (kme_tpu_torch.bridge), at the serve defaults on the card:
   (a) `MatchService(engine="seq", pipeline=2)` behind `serve_broker` on
   127.0.0.1:0, the zipf stream produced over TCP (`TcpBroker.
   produce_batch` of 4096) and its MatchOut consumed over TCP: B1's
   MatchOut, launches = dispatches; wall, messages/s, the service gauges
   and the kernel's share (CUDA events); (b) the same stream exactly once
   over a persisted broker log with checkpoints every 32768 messages,
   both dropped at about 60,000 messages and rebuilt from disk: the
   resumed service's stamped MatchOut log is B1's again; snapshot bytes,
   save and restore seconds; (c) the java stream through `compat="java"`
   at 8192 slots, one seqjava checkpoint mid-stream and a resume from it:
   the java oracle's MatchOut; (d) the first 20,000 messages through
   `engine="lanes"` with a snapshot at offset 10,240, restored into a seq
   service that finishes them: both equal B1's lines for those messages;
   (e) a card SeqSession and a CPU one after the same four batches write
   snapshots with equal payload digests; (f) `python -m kme_tpu_torch.cli
   serve` as a subprocess on the card, fed by the CLI's `loadgen`
   (a harness stream), consumed over TCP: equal to a `device="cpu"`
   service's MatchOut for the same stream;
11. the seq fleet and the sharded lanes engine, at the serve defaults:
   (a) `SeqMeshSession` over the zipf stream in WireBatches of 1024
   through `process_wire_buffer`, at 4 shards async, 4 lockstep and 8
   async, each with the launch counts set to 0 just before: B1's
   MatchOut, launches = the fleet's dispatches on as many non-default
   streams as shards (every shard launching), per-shard walls and
   kernel time by CUDA events, `stall_stats`, `shard_stats` and phases
   (`plan_s`, `rebalance_s`, `migrate_s`), and `export_canonical_global`
   with the digest of a serial card session's `export_canonical` after
   the same batches; (b) `zipf_hot_stream` (20,000 events, 1024
   symbols, 4096 accounts) at 4 shards in slices of 1024: the serial
   card session's MatchOut, with migrations; (c) a fresh 4-shard fleet
   fed up to batch 12, where each shard's first segment is launched
   from a copy of its state taken on its stream and replayed from that
   copy through the plain version (state planes, header rows and used
   fill prefix bit-equal); (d) `LaneSession(shards=4)` (full width, its
   sharded step graph captured first) over the first 20,000 messages:
   B1's lines for them, no row-copy launch, ms per padded step (a cut:
   the whole stream runs at one shard in phase 7). The fleet's launches
   are added to B1's on the kernels line;
12. the service's observability, at the serve defaults: (a) phase 10a's
   service over TCP with every option on — a binary journal, the
   auditor, trace spans, an SLO, the TSDB (heartbeat every 0.5 s), the
   host profiler, the device plane into a transfer artifact that already
   holds another backend's entry, trigger captures (each with a 0.5 s
   torch.profiler window on the card), two watchpoints, /metrics scraped over HTTP every 0.5 s
   during the run, exactly-once output and checkpoints every 32,768
   messages: B1's MatchOut, launches = dispatches, no audit violation
   and `check_engine` [] against the card's state at each of 3 or more
   checkpoints, the journal's canonical events and the watch hit set
   equal to what CPU runs of both packages give (OBSERVED_CANON,
   OBSERVED_HITS), the TSDB and the event log verified, the artifact's
   `cuda` entry (B1's CUDA-event ms and bytes per dispatch) beside the
   untouched other entry, seq_scan_kernel slices in the capture's
   profiler trace; its wall beside 10a's, by span and part; (b) on the
   first 20,000 messages, the `fill_qty` drill: the auditor trips and
   `replay_repro` of its dump re-finds it; (c) the `journal_fill_qty@K`
   drill over a persisted broker log: `xray.bisect` pins batch K and its
   repro replays; (d) the lanes service (B4/B5) journaled and audited
   over the same 20,000 messages: B1's lines, `check_engine` [] at its
   checkpoint and at the end. Its launches join the kernels line;
13. the multi-leader front, at the serve defaults, over the payout-free
   zipf stream (phase 3c's; on phase 4's PAYOUT stream the groups do not
   reproduce the single leader in either package): first a single-leader
   `MatchService(engine="seq", pipeline=2)` on the card, whose MatchOut
   per message is the reference; (a) groups2 and groups4: the port's
   front (`GroupRouter`, transfers on, prefund 8) splits the stream,
   `FrontLinks` produces it over TCP (`send_batch`) to one `serve_broker`
   per group, and each group, `MatchService(engine="seq", pipeline=2,
   group=(k, N))` exactly once, serves its substream on the card, one
   after another: each MatchOut.gK must equal the single leader's lines
   of the messages routed to group k, no Xfer.gK stamp may repeat, and
   the merged stream, the router's counters and the substreams must be
   what the JAX package gives on the CPU (GROUPS_ZIPF); each group's
   wall, their maximum (the deployment wall), the split and produce
   seconds, and the reference's `FrontLinks.send` (a record per round
   trip) timed over the first 8,192 records; (b) groups-cross: `cross_account_stream(20_000, ...,
   cross_frac=1.0)` through a single-leader card service and two groups
   likewise (GROUPS_CROSS), group 0 with checkpoints every 8,192 messages,
   then again from a copy of its log, killed at 10,240 and resumed from
   disk: its `pending_reserve` restored from the snapshot, MatchOut.g0
   and Xfer.g0 equal to the uninterrupted run's; (c) groups-cli, the
   stream's first 20,000 messages: `kme-torch-front route` feeding two
   `kme-torch-serve --group k/2 --engine seq --pipeline 2
   --checkpoint-dir --journal-out --trace-spans` processes on the card,
   `kme-torch-consume --topic MatchOut.gK` reading each group (the single
   leader's lines again), then `kme-torch-trace --cluster` (every order
   admitted and stitched) and `kme-torch-xray --cluster` (cash conserved
   at the cut) on that run directory; (d) feed-groups: a `FeedServer` per
   group of (c) over its stamped MatchOut.gK, 10,000 subscribers (or the
   fd limit's cap) on one symbol each, round-robin, on their symbol's
   group, and two wildcard auditors per group: every subscriber's books
   equal the levels of the resting orders in the group sessions' last
   snapshots (restored on the card), 0 gaps, 0 duplicates, and each
   group's frame bytes the JAX package's `FeedDeriver`'s (FEED_FRAMES);
   frames derived and delivered, conflations, resyncs, `feed_lag`. Its
   launches of B1 join the kernels line;
14. the failover drills, at the serve defaults over the zipf stream: (a)
   in process, a pipelined exactly-once `MatchService(engine="seq")` with
   snapshots every 32,768 runs to 60,416 messages of a persisted broker
   log, writes its leader heartbeat and is dropped without teardown; a
   `Replica(engine="seq", device="cuda")` restores the 32,768 snapshot on
   the card, follows the log to 59,392 (one batch short of the leader's
   heartbeat) and holds there; a pid-less promote.json promotes it
   (epoch 2, the old one fenced) and it serves the rest: launches =
   dispatches in each incarnation (leader, follower, promoted), the
   durable MatchOut's lines deduped by their stamps B1's, no stamp
   twice, `dup_suppressed_total` > 0, the `failover_seconds` gauge set;
   (b) `python -m kme_tpu_torch.cli supervise --standby` over
   `kme-torch-serve` children on the card, the leader SIGKILLed at
   60,416 by the `serve.kill` fault (once across incarnations), the
   stream produced over TCP in two parts, the second after the
   standby's first heartbeat, resuming from the endpoint's end offset
   after the kill; while both children run, each holds the card's device
   node and the card's context count has grown by two; the supervisor
   exits 0 with one recovery, promoted, and its `failover_seconds`; (c)
   the same without `--standby`: a cold restart from the 32,768
   snapshot. (b) and (c): B1's MatchOut deduped, no stamp twice, a
   produce stamped with epoch 1 against the reloaded log fenced; each
   child's seconds to its first heartbeat, the recovery seconds. 14a's
   launches of B1 join the kernels line;
15. the chaos drills: `python -m kme_tpu_torch.cli chaos --engine seq`
   as a subprocess, three times, its serve children running B1 on the
   card at the serve defaults (1024 symbols, 4096 accounts, 128 slots,
   1024-message batches, 16 fills) with snapshots every 3072 messages
   (CHAOS_CKPT_EVERY says why):
   (a) the default gauntlet over the harness stream (20,000 events at the
   reference harness's 10 accounts and 3 symbols), every fault class of
   `default_schedule` (broker fetch and produce errors, a partial TCP
   frame, a torn and a bit-flipped card snapshot, a torn journal tail, a
   SIGKILL at 10,000, a stuck loop at 15,000): `verify_stream` holds, 2
   or more restarts, every rule fired; the supervisor's recoveries and
   which snapshots each restore skipped; (b) `--scenario failover` over
   the same stream: the standby promoted within 2.0 s, the deduped
   MatchOut byte-exact with `dup_suppressed_total` > 0, the stale epoch
   fenced; (c) `--scenario payout-storm-wide --events 10000` at the
   profile's registry scale (1000 symbols, 64 accounts; chaos sizes that
   child at 1000 symbols and 128 accounts) against the adaptive overload
   controller at `--overload-high-lag 16` (STORM_HIGH_LAG says why):
   parity over the admitted stream, no stamp twice, 1 or more
   shed, cancels and payouts shed at a strictly lower rate than new
   orders, p99 under 2000 ms, 10 records/s or more. Each drill's report
   must say ok; every child named in a heartbeat must have held the
   card's device node, the card's context count must have grown (by two
   while 15b's leader and standby run), and the last leader heartbeat
   must count batches and kernel-counted messages. Prints restarts,
   `recovery_seconds`, `failover_seconds`, sheds by class, the p99 and
   each drill's wall. B1's launches in those child processes are not
   counted in this process, so they are not on the kernels line;
16. the other failover drills, the Kafka transport and the host-only
   tools (the constants' comment says what each runs at): (a)
   `kme-torch-chaos --scenario shard-failover` over 20,000 events, two
   group leaders and the busiest group's hot standby on the card, the
   victim SIGKILLed mid-substream: promoted within 2.0 s, every survivor
   restart-free with its busy-window rate during the outage measured
   (not exempt) and dipped under 10%, the merged MatchOut byte-exact
   against `verify_groups`, no stamp twice, the stale epoch fenced; each
   group's children hold the card's device node and the context count
   grows by 3; printed: the survivors' rates, each child's seconds to
   its first heartbeat, every group's heartbeats (own clock, offset,
   `device_ms_per_batch`) around the outage and the host's CPU busy
   share; (b)
   `--scenario feed-failover` over 20,000 events: promoted within 2.0
   s, the feed reconnected, every subscriber's book byte-exact with 0
   gaps and 0 duplicates; children on the card as in (a); (c)
   `kme_tpu_torch.bridge.serve.main([... "--kafka" ...])` in process
   over the first 20,000 zipf messages, the seq engine on the card at
   the serve defaults, the Kafka cluster an in-memory stand-in for the
   aiokafka client installed in `sys.modules` for this phase only: its
   MatchOut must be phase 4's B1 lines for those messages, launches =
   dispatches (on the kernels line); (d) `python -m kme_tpu_torch.cli
   sim --seed N --json` for each of SIM_DIGESTS (the recorded digests of
   both packages' CPU runs) and `... oracle --compat java` over the java
   stream (the java oracle's `183a22c6…`);
17. the serial parity replica (engine/parity.py: plain torch ops, no
   kernel of its own; each message's segments between two device reads
   replayed from CUDA graphs) on the card at the JAX package's bench caps for it
   (balances 32, positions 8192, books 32, buckets 1024, orders 16384,
   64 events, batch 2048): (a) java mode over harness_stream(4096,
   seed=0), its MatchOut lines == the port's java oracle's run here, its
   export_state == the oracle's stores, its state on the card, with
   msgs/s and D2H syncs per message; (b) phase 2b's stream, its lines ==
   phase 2b's card SeqSession (B2) lines; (c) fixed mode over
   harness_stream(1500, seed=3, validated, real PAYOUTs) == the fixed
   oracle, and a java REMOVE_SYMBOL on a non-empty book dies with
   ERR_HANG at the oracle's ReferenceHang index, the records before it
   equal; (d) `python -m kme_tpu_torch.cli lint --gate` exits 0 (its
   findings and grandfathered counts printed);
18. perfgate on the card's own history: (a) two services over the first
   20,000 zipf messages (phase 16c's prefix) through an in-process
   broker, `MatchService(engine="seq", pipeline=2, tsdb=..., profile=True,
   profile_artifact=...)` with a heartbeat every 50 ms: A at the serve
   defaults (B1), B at 8192 slots (B3 behind the rows-in-use kernel);
   each MatchOut must be the lines this script's earlier card runs gave
   for those messages (phase 4's B1 for A, phase 3b's for B), launches =
   dispatches, each store with several heartbeat samples; (b) `python -m
   kme_tpu_torch.cli prof --diff` as a subprocess: A's store against
   itself exits 0 with no suspect; A's against B's exits 0 with stages,
   each evidence's baseline, current and ratio those of the two
   `window_summary` dicts read here, the verdict (suspect, score, top
   evidence) logged as a measurement; (c) a detail artifact of A's own
   measurements (`backend` "cuda", `orders_per_sec` by the host clock,
   `device_ms_per_batch` by the device plane's CUDA events, `p99_ms` of
   `lat_e2e`) through `python -m kme_tpu_torch.perfgate`: against itself
   exit 0; against a copy with `device_ms_per_batch` doubled exit 1 with
   that metric regressed, and `--attribute` names `device`; against that
   copy tagged `"backend": "cpu"` exit 0 (advisory). Its launches join
   the kernels line;
19. the benchmark (kme_tpu_torch/benchmarks.py, `kme-torch-bench`): (a)
   in process, `bench_seq_engine` (`--suite lanes --engine seq`) at the
   serve defaults (20,000 zipf events, 1024 symbols, 4096 accounts, 128
   slots, 16 max fills, batch 1024, no java sub-run) on the card: its
   in-run full-stream parity against the native judge holds, its
   `device_path_s` is CUDA-event time and above 0, its `backend` is
   "cuda", and its B1 launches (counts set to 0 just before) equal the
   `seq_scan` calls it makes: KME_BENCH_DEV_REPS + 1 for the device path,
   one for the warm session, one per timed run (three); they join the
   kernels line; (b) its detail JSON written to a file, as
   `kme-torch-bench` writes it to stderr, then `python -m
   kme_tpu_torch.cli bench --baseline F --gate-current F` as a
   subprocess exits 0, and against a copy with `local_orders_per_sec`
   halved exits 1 naming that metric;
20. summary: one `kernels` JSON line, the card line, then the device line
   last.

`plain_ms` in the kernels line is the plain version's time per call:
host-clock time on the CPU for the seq kernel's entries (its plain
version is a Python interpreter of the kernel), CUDA-event time on the
card for the row copies and the rows-in-use kernel (whose plain versions
are torch ops). `seq_step` (B1) counts the launches of phase 4's main
path, of the fleet's runs (11a, 11b), of phase 12 (a-c), of phase
13's in-process services (a, b), of phase 14a's three incarnations, of
16c's Kafka-served service, of 18a's service A and of 19a's suite; its
`max_abs_err` includes phase 11c's. `seq_step_deep` (B3) counts the B3
main path's and 18a's service B's. `seq_rows_in_use` is the prologue of the deep-book
configurations of the seq kernel; its `launches` are those of the B3 main
path and of 18a's service B, its `max_abs_err` is over every state of phases 3b-3d that it was
held against its plain version on, its times are phase 3d's. The
`rowdma_*` entries are the (2, joined) instantiations, the ones the
lanes path launches (back-to-back times; library call: two
`index_select` / `index_copy_`, one per plane); the (1, planar) ones are
checked and timed in phases 6 and 8 but not on the main path. Their
`launches` include phase 12d's.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

FULL = dict(lanes=1024, slots=128, accounts=4096, max_fills=16, batch=1024,
            pos_cap=1 << 17, fill_cap=1 << 15, probe_max=64)
DEEP = dict(FULL, slots=8192, hbm_books=True)
JAVA = dict(DEEP, compat="java")
SMALL = dict(lanes=16, slots=128, accounts=256, max_fills=16, batch=256,
             pos_cap=1 << 12, fill_cap=1 << 12, probe_max=8)
SMALL_JAVA = dict(lanes=8, slots=256, accounts=128, max_fills=64, batch=256,
                  pos_cap=1 << 13, fill_cap=1 << 14, probe_max=16,
                  compat="java", hbm_books=True)
STREAM = dict(num_events=100_000, num_symbols=1024, num_accounts=4096, seed=0,
              payout_per_mille=2)
# the java stream and what the java oracle (kme_tpu.oracle.OracleEngine
# ("java")) gives for it: MatchOut lines, each followed by "\n", and the
# open orders and positions at its end (tests/test_torch_seq_java.py
# recomputes them)
JAVA_STREAM = dict(STREAM, payout_per_mille=0)
JAVA_LINES = 358_730
JAVA_SHA256 = \
    "183a22c60e0130a4a8e34eaa8549bd09cae3f607f590edaff4a7cf628058b10b"
JAVA_OPEN_ORDERS = 16_759
JAVA_POSITIONS = 48_317
# the MatchOut (lines, sha256) of the zipf stream at 128 slots (the lanes
# engine gives the same) and at 8192 slots, as every run on the card has
# given them
B1_MATCHOUT = (
    345_906, "454c29e38f8cc5b8e836f831c5479189c974cdec09800e74e84eaf8f1372a772")
DEEP_MATCHOUT = (
    346_474, "bb6686cfefe6fdf8b8f8759c1e54d573d52adeeda7bab905b2b677035744855d")
LANES = dict(lanes=1024, slots=128, accounts=4096, max_fills=16)
# MatchService's arguments at the kme-serve defaults
SERVE = dict(symbols=1024, accounts=4096, slots=128, max_fills=16,
             batch=1024)
# phase 10's cuts: snapshot cadence and crash point of the exactly-once
# runs (fixed, java), and the lanes prefix with its snapshot offset
SERVE_CKPT_EVERY, SERVE_CRASH_AT = 32_768, 60_000
JAVA_CKPT_EVERY = 50_000
LANES_PREFIX, LANES_CUT = 20_000, 10_240
CLI_EVENTS = 10_000
LANES_WIDTH = 8             # kme-serve --width default
# phase 11: the fleet's runs (shards, dispatch) over the zipf stream, the
# zipf-hot stream of 11b, the batch whose segments 11c replays, and the
# sharded lanes run of 11d (its shards; the prefix is LANES_PREFIX)
FLEET_RUNS = ((4, "async"), (4, "lockstep"), (8, "async"))
HOT_STREAM = dict(num_events=20_000, num_symbols=1024, num_accounts=4096,
                  seed=0)
FLEET_CHECK_BATCH = 12
FLEET_LANES_SHARDS = 4
# phase 12: the watch predicates of the observed service; what a CPU run
# of both packages gives for the zipf stream at the serve defaults (the
# card machine has no JAX; tests/test_torch_observe_stream.py recomputes
# them): the journal's canonical lifecycle events (count, sha256 of the
# canonical lines each followed by a newline) and the watch hit set over
# 1024-message barriers (count, sha256 of the JSON list of [offset,
# predicate, value]); the journal_fill_qty drill's batch (the stream's
# first 9 batches open and fund the accounts: batch 9 holds its first
# fill); the drills' and the lanes service's cut
OBSERVED_WATCH = ("depth[0]>=64", "depth[1]>=32")
OBSERVED_CANON = (
    342_267, "26c8c1c8b7acb5663f9308f972daa242233bef96e6c9370625e067612534a019")
OBSERVED_HITS = (
    36, "0870e6d24253c5b430695758baeb773b3670e6d52d44d4ddcf161abb20f47f06")
OBSERVED_SLO_MS = 5.0
TAMPER_BATCH = 12
DRILL_PREFIX = 20_000
# phase 13: the payout-free zipf stream the groups serve (phase 3c's;
# on phase 4's PAYOUT stream the groups do not reproduce the single
# leader, in either package: a settlement can debit a group past the
# margin the front granted) and its single-leader MatchOut at the serve
# defaults; the front's prefund, its records per produce round trip and
# the records it times at one per round trip; the cross-account stream of
# 13b; the
# prefix of the stream that the CLI deployment (13c) and the feed (13d)
# serve; the feed's deriver and queue (kme-bench --suite feed's
# defaults), its subscribers, and the wall past which they are cut; the
# group-0 checkpoint cadence and crash point of 13b. What the JAX package
# gives on the CPU (tests/test_torch_front_stream.py recomputes them):
# per group count, the merged MatchOut (lines, sha256), the router's
# counters and the substream line counts; for the cross stream, the
# single leader's MatchOut first; per feed group, (sequenced frames,
# sha256 of every frame's bytes)
GROUPS_STREAM = JAVA_STREAM
GROUPS_SINGLE = (
    325_558, "7dd9c0eeafc454f33330149e58fe1ae5ab8afb4212e73ec58aa36b9bf71d484d")
FRONT_PREFUND = 8
FRONT_BATCH = 1024
FRONT_SEND_PROBE = 8192
CROSS_STREAM = dict(num_events=20_000, num_symbols=1024, num_accounts=4096,
                    ngroups=2, seed=0, cross_frac=1.0)
GROUPS_CLI_PREFIX = 20_000
FEED_DERIVE = dict(depth_every=256, depth_levels=8)
FEED_QUEUE_BYTES = 64 * 1024
FEED_SUBSCRIBERS = 10_000
FEED_AUDITORS = 2
FEED_PHASE_LIMIT_S = 60.0
CROSS_CKPT_EVERY, CROSS_CRASH_AT = 8192, 10_240
GROUPS_ZIPF = {
    2: ((325_558, "755ed05ca5756e9b4a3a04e4a47575a4"
                  "e894dfca3999239fb9506bc746d1be96"),
        {"cross_shard_transfers_total": 7728, "transfer_shortfall_total": 0,
         "transfer_volume_total": 155_139_294,
         "balance_broadcasts_total": 4096}, [83_955, 44_813]),
    4: ((325_558, "ccf29b5f5bfdf6945538d15c85676035"
                  "78f78d30947a3c815b6b019b982e50a7"),
        {"cross_shard_transfers_total": 15_277,
         "transfer_shortfall_total": 0,
         "transfer_volume_total": 304_638_275,
         "balance_broadcasts_total": 12_288},
        [47_654, 28_745, 22_638, 53_021]),
}
GROUPS_CROSS = (
    (80_678, "cf10cda0e96bdade918a4e720d8842e7e6e8c638da07e1916e83e6fe001aab91"),
    (80_678, "2422e58c846ac6948e7e8e703bdd1a3e4d48fcda52499991f72e1eb3a3b6e68f"),
    {"cross_shard_transfers_total": 4590, "transfer_shortfall_total": 0,
     "transfer_volume_total": 91_193_597, "balance_broadcasts_total": 4096},
    [25_224, 17_268])
FEED_FRAMES = (
    (17_687, "45451af100260cf89ef8dd83b5c34bba8dba9350dd6486b97d647ea2f42dcb92"),
    (8_078, "ef62641f9ca1e2787458b88e9215b8f5e4f94484201a1aa0de49c13439c187f2"))
# phase 14 (snapshots every SERVE_CKPT_EVERY): the failover drills' kill
# point (59 batches of 1024) and the input produced before (b) waits for
# the standby's first heartbeat; the supervisor's poll, the grace it gives
# a child to its first heartbeat (a card child pays the torch import, the
# CUDA context, the kernel library load and the snapshot restore first:
# PERF.md has the measured start-up) and the serve children's idle exit
FAILOVER_KILL_AT = 60_416
FAILOVER_PART1 = 40_960
SUPERVISE_POLL = 0.1
SUPERVISE_GRACE = 30.0
FAILOVER_IDLE_EXIT = 15
# phase 15: `kme-torch-chaos` drills against serve children running B1 at
# the serve defaults (1024-message batches, 16 fills; chaos's own default
# batch of 64 is tuned for its host-only oracle). 15a/15b: the harness
# stream at the reference harness's shape (chaos's --accounts 10
# --symbols 3), snapshots every 3072 messages: chaos's default of 60 would
# write a ~74 MB card snapshot after every 1024-message batch, and at 3072
# no sound snapshot follows the damaged second (torn) and third
# (bit-flipped) before serve.kill lands at 10,000, so that restore walks
# the damaged ones back to the first (at 2048 a fourth, sound snapshot
# can land before the kill, as it did on the card: PERF.md §6). 15c: the
# payout storm at its registry scale (1000 symbols, 64 accounts) with the
# same snapshot cadence. Its shedding watermark is 16, not chaos's 48: a
# card child drains the storm's lag so fast that at 48 it shed 6 of
# 13,128 records, one of them a new order (PERF.md §6), and the
# fairness verdict (cancels and payouts shed strictly less often than
# new orders) would rest on that one record
CHAOS_EVENTS = 20_000
CHAOS_CKPT_EVERY = 3072
CHAOS_SERVE = ("--batch", "1024", "--max-fills", "16")
STORM = "payout-storm-wide"
STORM_EVENTS = 10_000
STORM_HIGH_LAG = 16
CHAOS_LIMIT_S = 420
# phase 16a: shard-failover at chaos's defaults for its topology (2
# groups, prefund 8 as the front's, half the orders from a non-home
# account, a hot standby for the busiest group, the victim) over
# CHAOS_EVENTS, with phase 15's serve arguments and snapshot cadence;
# every card child gets SUPERVISE_GRACE to its first heartbeat (start-up:
# PERF.md §6) and an idle exit of 10 s, not chaos's 5: the drill holds
# every group's input until all three children are up, and a leader that
# is up first must not idle out meanwhile. 16b: feed-failover over
# CHAOS_EVENTS likewise. 16c: the Kafka-served prefix of the zipf stream
SHARD_GROUPS = 2
SHARD_CROSS_FRAC = 0.5
SHARD_IDLE_EXIT = 10
KAFKA_PREFIX = LANES_PREFIX
# phase 16d: `kme-torch-sim --seed N` at its defaults (400 events, 2
# groups) -> (trace_digest, out_digest), what CPU runs of both packages'
# simulators give (tests/test_torch_sim.py recomputes them)
SIM_DIGESTS = {
    5: ("4c5b12cc8706716f9972c9f39cdd1718887dd6e0106ab31ac9f76bc4148e063d",
        "787f5943dbe82032fc487fc221e247c6c576c26b69bbdfed9602dd630aa8db63"),
    13: ("5f27962e9bf03131bb7537937f9551d323be873465c1fab92ea1c3179a78d2c5",
         "79f7a07ed89a3f2ef84dea7279ff6942aea8496c3f7150caf256b17891a92f9a"),
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# phase 17: the serial parity replica at the JAX package's bench caps for it
# (kme_tpu/benchmarks.py bench_parity_engine: the stock harness stream of
# 4096 events, java mode, batch 2048)
PARITY_CAPS = dict(balances=32, positions=8192, books=32, buckets=1024,
                   orders=16384, max_events=64, batch=2048)
PARITY_EVENTS = 4096
PARITY_PHASE_LIMIT_S = 60.0
# phase 18: two profiled services over phase 16c's prefix of the zipf
# stream (A at the serve defaults, B at 8192 slots), each TSDB fed by a
# heartbeat every PERFGATE_HEALTH_S (a service served the prefix in
# 0.4-1.6 s on the card, so each store held 9-31 samples; at least
# PERFGATE_MIN_SAMPLES are required), and the slowdown planted into a copy
# of A's detail artifact
PERFGATE_PREFIX = KAFKA_PREFIX
PERFGATE_DEEP = dict(SERVE, slots=8192)
PERFGATE_HEALTH_S = 0.05
PERFGATE_MIN_SAMPLES = 3
PERFGATE_SLOWDOWN = 2.0
PERFGATE_PHASE_LIMIT_S = 40.0
# phase 19: the benchmark's seq suite at the serve defaults over the first
# 20,000 zipf events, and the gate over its own detail artifact
BENCH_EVENTS = 20_000
BENCH_DEV_REPS = 3          # KME_BENCH_DEV_REPS's default
BENCH_PHASE_LIMIT_S = 20.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def planes_equal(SQ, cfg, a: dict, b: dict, out_a, out_b):
    """-> (max abs difference, list of differing names) over the state
    planes, the header rows and the used fill prefix."""
    import torch

    bad, err = [], 0
    for k in SQ.state_keys(cfg):
        x, y = a[k].cpu().to(torch.int64), b[k].cpu().to(torch.int64)
        d = int((x - y).abs().max())
        if d:
            bad.append(k)
            err = max(err, d)
    ft_a, ft_b = int(out_a[0, 1]), int(out_b[0, 1])
    rows = SQ.used_rows(cfg, max(ft_a, ft_b))
    x = out_a[:rows].cpu().to(torch.int64)
    y = out_b[:rows].cpu().to(torch.int64)
    d = int((x - y).abs().max())
    if d or ft_a != ft_b:
        bad.append("out")
        err = max(err, d, 1)
    return err, bad


def route_chunks(SQ, SeqRouter, cfg, msgs):
    """The stream cut into the session's dispatches, packed as the
    kernel's message columns (one chunk per `batch` messages)."""
    router = SeqRouter(cfg.lanes, cfg.accounts, cfg.compat)
    chunks = []
    for lo in range(0, len(msgs), cfg.batch):
        cols, _ = router.route(msgs[lo:lo + cfg.batch])
        chunks.append(SQ.pack_msgs(cfg, cols, len(cols["act"])))
    return chunks


def trade_chunk(SQ, chunks):
    return next(i for i, c in enumerate(chunks)
                if ((c["act"] == SQ.L_BUY) | (c["act"] == SQ.L_SELL)).any())


def check_batches(SQ, cfg, chunks, checks, label, after=None):
    """Every chunk through the kernel from an empty state; each chunk in
    `checks` also through the plain version from the same pre-state:
    planes, header rows and used fill prefix must be equal; `after(state)`
    runs behind each checked chunk. -> (state, max abs err, plain ms per
    checked batch, outputs of the checked batches)."""
    import torch

    state = SQ.make_seq_state(cfg)
    max_err, plain_ms, outs = 0, [], {}
    for i, c in enumerate(chunks):
        dm = SQ.msgs_to_device(c, "cuda")
        if i in checks:
            pre = SQ.state_to_numpy(state)
        out = SQ.seq_step(cfg, state, dm)
        if i in checks:
            torch.cuda.synchronize()
            ref_state = SQ.state_from_numpy(cfg, pre, "cpu")
            del pre
            t = time.perf_counter()
            ref_out = SQ.seq_step(cfg, ref_state, SQ.msgs_to_device(c, "cpu"))
            plain_ms.append((time.perf_counter() - t) * 1e3)
            err, bad = planes_equal(SQ, cfg, state, ref_state, out, ref_out)
            del ref_state
            max_err = max(max_err, err)
            if bad:
                fail(f"{label} batch {i}: kernel != plain version in {bad} "
                     f"(max abs err {err})")
            outs[i] = out.cpu()
            if after is not None:
                after(state)
            log(f"{label} batch {i}: {int((c['act'] != 0).sum())} messages, "
                f"fill_total {int(out[0, 1])}, kernel == plain version bit "
                f"for bit ({len(state)} planes, {SQ.hdr_rows(cfg)} header "
                f"rows, used fill prefix); plain version {plain_ms[-1]:.1f} "
                f"ms on the host CPU")
    torch.cuda.synchronize()
    if int(state["err"][0, 0]) != 0:
        fail(f"{label}: sticky error {int(state['err'][0, 0])} in the "
             f"checked run")
    return state, max_err, plain_ms, outs


def main_path(SQ, ses, msgs, label, keep=None):
    """The stream end to end through process_wire's Python line builder
    (`_use_native_wire` off) with every launch count set to 0 just before
    and read just after; the first KAFKA_PREFIX messages' lines are
    appended to `keep` (a list, one entry per message) when it is given.
    -> (MatchOut lines, sha256, host wall s, launches by configuration)."""
    import torch

    ses._use_native_wire = False    # the Python line builder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in SQ.LAUNCHES:
        SQ.LAUNCHES[key] = 0
    hasher = hashlib.sha256()
    nlines = 0
    t = time.perf_counter()
    for lo in range(0, len(msgs), ses.cfg.batch):
        for lines in ses.process_wire(msgs[lo:lo + ses.cfg.batch]):
            if keep is not None and len(keep) < KAFKA_PREFIX:
                keep.append(lines)
            for ln in lines:
                hasher.update(ln.encode())
                hasher.update(b"\n")
            nlines += len(lines)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(SQ.LAUNCHES)
    key = ses.cfg.compat
    if launches[key] != ses.dispatches or launches[key] == 0:
        fail(f"{label}: launches {launches[key]} != dispatches "
             f"{ses.dispatches}")
    if launches[key] != launches["fixed"] + launches["java"]:
        fail(f"{label}: launches of another configuration {launches}")
    if launches["rows_in_use"] != (ses.dispatches if ses.cfg.nr > 1 else 0):
        fail(f"{label}: {launches['rows_in_use']} rows-in-use launches for "
             f"{ses.dispatches} dispatches at {ses.cfg.nr} rows per side")
    log(f"{label} end to end: {len(msgs)} messages in {wall:.3f} s = "
        f"{len(msgs) / wall:.0f} msg/s (host clock, synchronized); "
        f"{ses.dispatches} dispatches, {launches[key]} kernel launches, "
        f"{launches['rows_in_use']} rows-in-use launches")
    phases = dict(ses.phases, lines_s=wall - sum(ses.phases.values()))
    log(f"{label} phases (s, host clock; fetch_s includes waiting for the "
        "kernel, lines_s is building the MatchOut lines): "
        + json.dumps({k: round(v, 4) for k, v in phases.items()}))
    log(f"{label} max_memory_allocated {torch.cuda.max_memory_allocated()} "
        f"bytes")
    log(f"{label} MatchOut: {nlines} lines, sha256 {hasher.hexdigest()}")
    return nlines, hasher.hexdigest(), wall, launches


def parse_both(parse_order, dumps_order, WireBatch, msgs, label):
    """The stream's JSON lines parsed twice, timed: line by line with
    parse_order (the OrderMsgs of the Python paths) and as one buffer
    with WireBatch.parse_buffer (the columns of the native paths); the
    columns must be identical. -> (OrderMsgs, WireBatch)."""
    import numpy as np

    lines = [dumps_order(m) for m in msgs]
    buf = ("\n".join(lines) + "\n").encode()
    t = time.perf_counter()
    parsed = [parse_order(ln) for ln in lines]
    py_s = time.perf_counter() - t
    t = time.perf_counter()
    wb = WireBatch.parse_buffer(buf)
    native_s = time.perf_counter() - t
    if wb._msgs is not None:
        fail(f"{label}: the native parser refused the stream")
    want = WireBatch.from_msgs(parsed)
    for f in WireBatch._COLS + ("hnext", "hprev"):
        if not np.array_equal(getattr(wb, f), getattr(want, f)):
            fail(f"{label}: parse_buffer column {f} != parse_order's")
    log(f"{label}: {len(msgs)} messages ({len(buf)} bytes of JSON) parsed "
        f"by parse_order in {py_s:.4f} s, by WireBatch.parse_buffer (native) "
        f"in {native_s:.4f} s ({py_s / native_s:.0f}x); columns identical "
        f"(host clock)")
    return parsed, wb


def wire_batches(WireBatch, wb, B):
    """`wb` cut into WireBatches of B messages (column views)."""
    cols = WireBatch._COLS
    return [WireBatch(min(B, wb.n - lo),
                      [getattr(wb, f)[lo:lo + B] for f in cols],
                      wb.hnext[lo:lo + B], wb.hprev[lo:lo + B])
            for lo in range(0, wb.n, B)]


@contextlib.contextmanager
def kernel_events(SQ):
    """CUDA events around every seq_scan call in the block (its
    rows-in-use and chain kernels, on the stream it launches on); yields
    the list of (start, end) pairs."""
    import torch

    orig, pairs = SQ.seq_scan, []

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig(*a, **kw)
        ev[1].record()
        pairs.append(ev)
        return out

    SQ.seq_scan = timed
    try:
        yield pairs
    finally:
        SQ.seq_scan = orig


def buffer_digest(parts):
    """(MatchOut lines, sha256 of the lines each followed by a newline)
    of process_wire_buffer / collect results."""
    hasher = hashlib.sha256()
    nlines = 0
    for buf, off, _ in parts:
        n = len(off) - 1
        hasher.update(b"\n".join(buf[off[k]:off[k + 1]] for k in range(n)))
        hasher.update(b"\n")
        nlines += n
    return nlines, hasher.hexdigest()


def native_paths(SQ, SS, cfg, batches, want, label):
    """The stream through the native host path twice, each on a fresh
    session with every launch count set to 0 just before: serially
    through process_wire_buffer, then pipelined through submit/collect at
    depth 2. Each must give `want` (MatchOut lines, sha256) with launches
    = dispatches; the router must be the native one in fixed mode.
    -> {"serial": wall s, "pipelined": wall s}."""
    import torch

    walls = {}
    for mode in ("serial", "pipelined"):
        ses = SS.SeqSession(cfg)
        router = SS.NativeSeqRouter if cfg.compat == "fixed" else SS.SeqRouter
        if type(ses.router) is not router:
            fail(f"{label} {mode}: the router is {type(ses.router).__name__}"
                 f", not {router.__name__}")
        torch.cuda.synchronize()
        for key in SQ.LAUNCHES:
            SQ.LAUNCHES[key] = 0
        parts, pend = [], []
        with kernel_events(SQ) as evs:
            t = time.perf_counter()
            for b in batches:
                if mode == "serial":
                    r = ses.process_wire_buffer(b)
                    if r is None:
                        fail(f"{label} serial: process_wire_buffer gave None")
                    parts.append(r)
                    continue
                pend.append(ses.submit(b))
                if len(pend) == 2:
                    parts.append(ses.collect(pend.pop(0)))
            while pend:
                parts.append(ses.collect(pend.pop(0)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = dict(SQ.LAUNCHES)
        kern_s = sum(e0.elapsed_time(e1) for e0, e1 in evs) / 1e3
        got = buffer_digest(parts)
        if got != want:
            fail(f"{label} {mode}: MatchOut {got[0]} lines sha256 {got[1]} "
                 f"!= the Python path's {want[0]} lines sha256 {want[1]}")
        key = cfg.compat
        if launches[key] != ses.dispatches or ses.dispatches != len(batches):
            fail(f"{label} {mode}: launches {launches[key]}, dispatches "
                 f"{ses.dispatches}, batches {len(batches)}")
        walls[mode] = wall
        nmsgs = sum(b.n for b in batches)
        log(f"{label} native {mode}: {nmsgs} messages in {wall:.3f} s = "
            f"{nmsgs / wall:.0f} msg/s (host clock, synchronized); "
            f"{ses.dispatches} dispatches = {launches[key]} kernel launches;"
            f" MatchOut == the Python path's ({got[0]} lines, sha256 "
            f"{got[1]})")
        log(f"{label} native {mode} phases (s, host clock; fetch_s includes "
            f"waiting for the kernel): "
            + json.dumps({k: round(v, 4) for k, v in ses.phases.items()}))
        line = (f"{label} native {mode}: kernel time (CUDA events) "
                f"{kern_s:.4f} s = {kern_s / wall:.1%} of the wall")
        if mode == "pipelined":
            ovl = SS.measured_overlap_s(ses.windows)
            coll = sum(t1 - t0 for kind, _, t0, t1 in ses.windows
                       if kind == "collect")
            if ses.h2d_overlap_frac < 0.5:
                fail(f"{label} pipelined: h2d_overlap_frac "
                     f"{ses.h2d_overlap_frac} < 0.5 at depth 2")
            line += (f"; h2d_overlap_frac {ses.h2d_overlap_frac}; "
                     f"measured_overlap_s {ovl:.4f} of {coll:.4f} s of "
                     f"collect = measured_overlap_frac "
                     f"{ovl / max(coll, 1e-9):.4f}; overflow fetches "
                     f"{ses.overflow_fetches}")
        log(line)
        del ses
    return walls


def timed_replay(SQ, cfg, chunks, nmsgs, wall, card, label):
    """The same dispatches again from an empty state, CUDA events around
    each launch, and each dispatch's byte bound. -> (mean ms, bound ms)."""
    import torch
    from kme_tpu_torch.engine.lanes import MET_BARRIERS

    state = SQ.make_seq_state(cfg)
    dev_chunks = [SQ.msgs_to_device(c, "cuda") for c in chunks]
    scratch = SQ.make_seq_state(cfg)
    for c in dev_chunks[:3]:          # warm-up on a scratch state
        SQ.seq_step(cfg, scratch, c)
    torch.cuda.synchronize()
    del scratch
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in dev_chunks]
    bytes_per = []
    rows_hist = torch.zeros(cfg.nr + 1, dtype=torch.int64, device="cuda")
    for (e0, e1), c, hc in zip(ev, dev_chunks, chunks):
        pre = {k: v.clone() for k, v in state.items()}
        e0.record()
        out = SQ.seq_step(cfg, state, c)
        e1.record()
        bytes_per.append(SQ.dispatch_bytes(cfg, hc, out, pre, state,
                                           int(out[0, 2 + MET_BARRIERS])))
        del pre
        # rows in use, after the dispatch, of the book sides it touched
        book = c["lane"][(c["act"] >= SQ.L_BUY) & (c["act"] <= SQ.L_CANCEL)]
        used = SQ.rows_in_use_reference(cfg, state["bs"])[book.long()]
        rows_hist += torch.bincount(used.view(-1).long(),
                                    minlength=cfg.nr + 1)
    torch.cuda.synchronize()
    hist = {r: n for r, n in enumerate(rows_hist.tolist()) if n}
    log(f"{label} rows in use per touched (lane, side), counted after each "
        f"dispatch for every trade and cancel in it, of {cfg.nr} rows: "
        f"{json.dumps(hist)}")
    ms = [e0.elapsed_time(e1) for e0, e1 in ev]
    kern_ms = sum(ms) / len(ms)
    bound_ms = sum(bytes_per) / len(bytes_per) / HBM_BYTES_PER_S * 1e3
    log(f"{label} kernel: {kern_ms:.4f} ms per {cfg.batch}-message dispatch "
        f"(mean of {len(ms)}, min {min(ms):.4f}, max {max(ms):.4f}) = "
        f"{sum(ms) * 1e6 / nmsgs:.0f} ns/message; byte bound "
        f"{bound_ms:.6f} ms per dispatch ({sum(bytes_per) / len(ms):.0f} B "
        f"at 3.35 TB/s); card {card}")
    log(f"{label} kernel time of the stream {sum(ms) / 1e3:.4f} s = "
        f"{sum(ms) / 1e3 / wall:.1%} of the end-to-end wall")
    return kern_ms, bound_ms


def rows_checker(SQ, cfg, label, errs, seen):
    """-> after(state) for `check_batches`: the rows-in-use kernel against
    its plain version on the state's size plane; the max abs err goes to
    `errs`, the deepest side's rows to `seen`."""
    import torch

    def after(state):
        got = SQ.rows_in_use(cfg, state["bs"])
        want = SQ.rows_in_use_reference(cfg, state["bs"])
        errs.append(int((got.long() - want.long()).abs().max()))
        if errs[-1] or not torch.equal(got, want):
            fail(f"{label}: rows-in-use kernel != plain version (max abs "
                 f"err {errs[-1]})")
        seen.append(int(got.max()))

    return after


def deep_book_phase(SQ, SeqRouter, deep_book_stream, card, errs):
    """Phase 3d: the deep-book stream at full width and 8192 slots, fixed
    and java mode, every dispatch against the plain version; the
    rows-in-use kernel against its plain version on every state and timed
    alone. `errs`: that kernel's abs errs from earlier phases, extended
    here. -> the rows-in-use kernel's entry (launches filled in by the
    caller)."""
    import torch

    for kw, label in ((DEEP, "deep book"), (JAVA, "deep book java")):
        cfg = SQ.SeqConfig(**kw)
        msgs = deep_book_stream(3000, barrier=cfg.compat == "fixed")
        chunks = route_chunks(SQ, SeqRouter, cfg, msgs)
        seen = []
        state, _, _, _ = check_batches(
            SQ, cfg, chunks, range(len(chunks)), label,
            rows_checker(SQ, cfg, label, errs, seen))
        if max(seen) <= SQ.STAGE_ROWS:
            fail(f"{label}: the book stayed within the {SQ.STAGE_ROWS} "
                 f"staged rows ({seen})")
        log(f"{label}: {len(msgs)} messages in {len(chunks)} dispatches, "
            f"all == plain version; rows in use of the deepest side after "
            f"each dispatch {seen} (a trade stages {SQ.STAGE_ROWS}); "
            f"rows-in-use kernel == plain version on every state")
    # the rows-in-use kernel alone, on the last state (8192 slots)
    bs = state["bs"]
    n = 50
    times = {}
    for name, fn in (("kernel", lambda: SQ.rows_in_use(cfg, bs)),
                     ("plain", lambda: SQ.rows_in_use_reference(cfg, bs))):
        for _ in range(3):
            fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in "01"]
        ev[0].record()
        for _ in range(n):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        times[name] = ev[0].elapsed_time(ev[1]) / n
    nbytes = bs.numel() * 4 + cfg.lanes * 2 * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"rows-in-use kernel at {cfg.slots} slots x {cfg.lanes} lanes: "
        f"{times['kernel'] * 1e3:.2f} us per call, plain version on the card "
        f"{times['plain'] * 1e3:.2f} us (CUDA events, mean of {n} back to "
        f"back calls, the {nbytes / 1e6:.1f} MB plane partly in L2); byte "
        f"bound {bound_ms * 1e3:.2f} us at 3.35 TB/s; card {card}")
    log(f"rows-in-use kernel == plain version on {len(errs)} states (B3's "
        f"and B2's checked batches, every deep-book dispatch), max abs err "
        f"{max(errs)}")
    return kernel_entry("seq_rows_in_use", "kme_tpu/engine/seq.py:1549", 0,
                        max(errs), times["kernel"], [times["plain"]],
                        bound_ms)


def kernel_entry(name, replaces, launches, max_err, kern_ms, plain_ms,
                 bound_ms, source="kme_tpu_torch/csrc/seq_step.cu",
                 library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": max_err,
            "ms": kern_ms, "plain_ms": sum(plain_ms) / len(plain_ms),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def check_rowdma(rowdma):
    """Phase 6: both instantiations of B4 and B5 on seeded full-width
    planes against their plain versions (on CPU copies of the same
    inputs). -> max abs err."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    S, SUB = LANES["lanes"] + 1, 2 * LANES["accounts"] // 128
    A, W = LANES["accounts"], LANES_WIDTH

    def words(shape):
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64
                            ).astype(np.int32)

    flat, pa, pv = (words((S, SUB, 128)) for _ in range(3))
    rows = words((W, SUB, 128))
    blks = [rng.integers(-2**63, 2**63 - 1, (W, A), dtype=np.int64)
            for _ in "ab"]
    lanes = np.full(W, S - 1, np.int32)                 # 3 scrap lanes
    lanes[[0, 2, 3, 5, 7]] = rng.choice(S - 1, 5, replace=False)

    def both(fn):
        """fn(to_tensor) on the card and on the CPU -> (card, cpu) lists
        of CPU tensors."""
        out = []
        for dev in ("cuda", "cpu"):
            res = fn(lambda x: torch.from_numpy(x.copy()).to(dev))
            out.append([r.cpu() for r in res])
        torch.cuda.synchronize()
        return out

    cases = {
        "B4 (1, planar) gather output": lambda t: [
            rowdma.gather_lane_rows(t(flat), t(lanes))],
        "B5 (1, planar) scattered plane": lambda t: [
            rowdma.scatter_lane_rows(t(flat), t(lanes), t(rows), S - 1)],
        "B4 (2, joined) int64 blocks": lambda t: list(
            rowdma.gather_pos_rows(t(pa), t(pv), t(lanes))),
        "B5 (2, joined) scattered planes": lambda t: list(
            rowdma.scatter_pos_rows(t(pa), t(pv), t(lanes), t(blks[0]),
                                    t(blks[1]), S - 1)),
    }
    err = 0
    for name, fn in cases.items():
        got, want = both(fn)
        for x, y in zip(got, want):
            d = int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
            err = max(err, d)
            if d or x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"{name} != plain version at ({S}, {SUB}, 128), lanes "
                     f"{lanes.tolist()} (max abs err {d})")
        log(f"{name} at ({S}, {SUB}, 128) int32 planes, lanes "
            f"{lanes.tolist()}: == plain version bit for bit")
    return err


@contextlib.contextmanager
def syncs_seen():
    """Collect the warnings of operations that wait for the card
    (torch.cuda's sync debug mode) raised inside the block."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        seen = []
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode(0)
            # every sync warning but the mode's own "prototype" notice
            seen.extend(str(w.message).splitlines()[0] for w in caught
                        if "synchroniz" in str(w.message).lower()
                        and "prototype" not in str(w.message))


def checked_lanes(L, LS):
    """A card LaneSession that also runs chosen windows from the same
    pre-state in a CPU session (the plain row copies) and holds packed
    outputs, used fill prefix and canonical state equal."""
    import numpy as np
    import torch

    class CheckedLanes(LS.LaneSession):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.checked = {}
            self.after_payout = False
            self.last_only = False
            self._win = 0
            self._last_win = -1
            settle = self._settle

            def watched(state, lane, credit_size, mode):
                ok = settle(state, lane, credit_size, mode)
                self.after_payout |= ok and mode > 0
                return ok

            self._settle = watched

        def _dispatch(self, sched):
            Wn = self.cfg.window
            self._last_win = self._win - 1 + sum(
                -(-sched.segment_steps[i] // Wn)
                for kind, i in sched.program if kind == "scan")
            return super()._dispatch(sched)

        def _run_window(self, T, M, cb):
            self.capture()          # (no-op unless the state was replaced)
            acts = cb[LS.CB_FIELDS.index("act")]
            label = None
            if self.last_only:
                if self._win == self._last_win:
                    label = "last"
            elif "first with trades" not in self.checked and (
                    (acts == L.L_BUY) | (acts == L.L_SELL)).any():
                label = "first with trades"
            elif self.after_payout and "first after a PAYOUT" not in \
                    self.checked:
                label = "first after a PAYOUT"
            self._win += 1
            if label is None:
                return super()._run_window(T, M, cb)
            pre = L.state_to_numpy(self.state)
            eager = {k: v.clone() for k, v in self.state.items()}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            replays = self.graph_stats["replays"]
            with syncs_seen() as seen:
                ev[0].record()
                outs = super()._run_window(T, M, cb)
                ev[1].record()
            if seen:
                fail(f"lanes window {self._win - 1} ({label}) waited for "
                     f"the card: {seen[0]}")
            if self.graph_stats["replays"] - replays != T:
                fail(f"lanes window {self._win - 1} ({label}): "
                     f"{self.graph_stats['replays'] - replays} graph "
                     f"replays for T={T}")
            # the same window from the same pre-state: the eager chunk
            # function on the card, and a CPU session
            cbt = {f: torch.from_numpy(cb[r].copy())
                   for r, f in enumerate(LS.CB_FIELDS)}
            ev[2].record()
            eager, eouts = L.build_lane_chunk(self.dev_cfg, T, M)(
                eager, {f: v.cuda() for f, v in cbt.items()})
            ev[3].record()
            torch.cuda.synchronize()
            graph_ms, eager_ms = (ev[0].elapsed_time(ev[1]),
                                  ev[2].elapsed_time(ev[3]))
            cpu = L.state_from_numpy(self.dev_cfg, pre, "cpu")
            t = time.perf_counter()
            cpu, couts = L.build_lane_chunk(self.dev_cfg, T, M)(cpu, cbt)
            plain_s = time.perf_counter() - t
            base, end = int(pre["filloff"][0]), int(cpu["filloff"][0])
            a = L.export_canonical(self.dev_cfg, self.state, self.cfg.lanes)
            for name, st, po in (("eager chunk on the card", eager,
                                  eouts["packed"]),
                                 ("CPU", cpu, couts["packed"])):
                bad = []
                if not torch.equal(outs["packed"].cpu(), po.cpu()):
                    bad.append("packed")
                if not torch.equal(self.state["fillbuf"][:, base:end].cpu(),
                                   st["fillbuf"][:, base:end].cpu()):
                    bad.append("fill prefix")
                b = L.export_canonical(self.dev_cfg, st, self.cfg.lanes)
                bad += [k for k in a if not np.array_equal(a[k], b[k])]
                if bad:
                    fail(f"lanes window {self._win - 1} ({label}): graph != "
                         f"{name} in {bad}")
            del eager, cpu
            self.checked[label] = plain_s
            log(f"lanes window {self._win - 1} ({label}): T={T} steps, "
                f"{int((acts != 0).sum())} messages, {end - base} fills; "
                f"graph replay == eager chunk on the card == CPU (packed "
                f"outputs, used fill prefix, all {len(a)} canonical "
                f"arrays); no host sync in the graph window; card time "
                f"(CUDA events, enqueue included) graph window "
                f"{graph_ms:.2f} ms, eager chunk {eager_ms:.2f} ms; CPU "
                f"session {plain_s:.2f} s")
            return outs

    return CheckedLanes


def lanes_path(L, LS, rowdma, msgs, b1):
    """Phases 6b and 7 on the zipf stream; `b1` = (MatchOut lines,
    sha256, metrics) of phase 4's B1 main path."""
    import numpy as np
    import torch
    from kme_tpu_torch.native.sched import NativeScheduler

    b1_lines, b1_sha, b1_met = b1
    cfg = L.LaneConfig(**LANES)
    B = 1024
    CheckedLanes = checked_lanes(L, LS)

    # ---- 6b. two windows against the CPU
    chk = CheckedLanes(cfg, width=LANES_WIDTH)
    for lo in range(0, len(msgs), B):
        chk.process_wire(msgs[lo:lo + B])
        if len(chk.checked) == 2:
            break
    else:
        fail(f"lanes: only {sorted(chk.checked)} windows were checked")
    log(f"lanes windows checked through batch {lo // B}")
    del chk

    # ---- 7. the main path, its step graph captured first (set-up, like
    # the kernels' build: the capture's warm-up step runs eagerly)
    ses = LS.LaneSession(cfg, width=LANES_WIDTH)
    if not ses.dev_cfg.pos_dma:
        fail("lanes: LaneSession did not turn pos_dma on at the defaults")
    if not isinstance(ses.scheduler, NativeScheduler):
        fail(f"lanes: the scheduler is {type(ses.scheduler).__name__}, not "
             f"the native one")
    ses.capture()
    st = ses.graph_stats
    log(f"lanes step graph: captured in {st['capture_s']:.4f} s, "
        f"instantiated in {st['instantiate_s']:.4f} s (host clock); "
        f"launches it holds {ses._graph_counts}")
    last = (len(msgs) - 1) // B * B
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in rowdma.LAUNCHES:
        rowdma.LAUNCHES[key] = 0
    hasher = hashlib.sha256()
    nlines = 0
    t = time.perf_counter()
    for lo in range(0, len(msgs), B):
        if lo == last:
            pre = ({k: v.clone() for k, v in ses.state.items()},
                   tuple(dict(m) for m in (ses.scheduler.aid_idx,
                                           ses.scheduler.sid_lane,
                                           ses.scheduler.oid_sid)),
                   ses.scheduler._rr_lane)
        out = ses.process_wire(msgs[lo:lo + B])
        for lines in out:
            for ln in lines:
                hasher.update(ln.encode())
                hasher.update(b"\n")
            nlines += len(lines)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(rowdma.LAUNCHES)
    sha = hasher.hexdigest()
    log(f"lanes end to end: {len(msgs)} messages in {wall:.3f} s = "
        f"{len(msgs) / wall:.0f} msg/s (host clock, synchronized); "
        f"{ses.steps} padded scan steps, {ses.steps / wall:.0f} steps/s = "
        f"{wall / ses.steps * 1e3:.4f} ms of wall per step, launches "
        f"{launches}")
    log(f"lanes step graph: {st['captures']} graph(s) captured, "
        f"{st['replays']} replays, host {st['replay_s'] / st['replays'] * 1e6:.2f}"
        f" us per replay ({st['replay_s']:.3f} s enqueuing; the host blocks "
        f"there when the card's launch queue is full)")
    log("lanes phases (s, host clock; plan_s is NativeScheduler.plan, "
        "dispatch_s enqueues the windows and their graph replays, fetch_s "
        "waits for them, recon_s builds the MatchOut lines): "
        + json.dumps({k: round(v, 4) for k, v in ses.phases.items()}))
    log(f"lanes max_memory_allocated {torch.cuda.max_memory_allocated()} "
        f"bytes")
    log(f"lanes MatchOut: {nlines} lines, sha256 {sha}")
    if (nlines, sha) != (b1_lines, b1_sha):
        fail(f"lanes MatchOut {nlines} lines sha256 {sha} != B1's "
             f"{b1_lines} lines sha256 {b1_sha}")
    for key in ("gather_pos", "scatter_pos"):
        if launches[key] != ses.steps or ses.steps == 0:
            fail(f"lanes: {launches[key]} {key} launches for {ses.steps} "
                 f"padded steps (want 1 per step)")
    if launches["gather"] or launches["scatter"]:
        fail(f"lanes: (1, planar) row copies ran on the main path: "
             f"{launches}")
    if st["captures"] != 1 or st["replays"] != ses.steps:
        fail(f"lanes: {st['captures']} captures and {st['replays']} replays "
             f"for {ses.steps} padded steps")
    met = ses.metrics()
    for key in ("open_orders", "positions", "rej_capacity"):
        if met[key] != b1_met[key]:
            fail(f"lanes {key} {met[key]} != B1's {b1_met[key]}")
    canon = ses.export_canonical()
    if int(canon["err"]) != 0:
        fail(f"lanes: sticky error {int(canon['err'])}")
    neg = int((canon["bal"][canon["bal_used"]] < 0).sum())
    if neg:
        fail(f"lanes: {neg} negative balances")
    log(f"lanes MatchOut == B1's; fills {met['fills']}, accepted trades "
        f"{met['trades_ok']}, capacity rejects {met['rej_capacity']}, "
        f"barriers {met['barriers']}, open orders {met['open_orders']}, "
        f"positions {met['positions']} (B1's); sticky error 0, no negative "
        f"balance; B4 and B5 (2, joined) launches each = {ses.steps} padded "
        f"steps = graph replays, one capture")

    # ---- 7, last window: the final batch replayed from its pre-state
    rep = CheckedLanes(cfg, width=LANES_WIDTH)
    rep.state = pre[0]
    rep._load_maps(*pre[1], pre[2])
    rep.last_only = True
    if rep.process_wire(msgs[last:]) != out:
        fail("lanes: the replayed last batch's MatchOut differs")
    if "last" not in rep.checked:
        fail("lanes: the last window was not checked")
    again = rep.export_canonical()
    if any(not np.array_equal(again[k], canon[k]) for k in canon):
        fail("lanes: the replayed last batch left another state")
    log("lanes last batch replayed from its pre-state: same MatchOut and "
        "canonical state as the main path")

    # ---- 7, device busy share: the last batch once more, profiled
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof_ses = LS.LaneSession(cfg, width=LANES_WIDTH)
    prof_ses.state = {k: v.clone() for k, v in pre[0].items()}
    prof_ses._load_maps(*pre[1], pre[2])
    prof_ses.capture()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prof_ses.process_wire(msgs[last:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    steps = max(prof_ses.steps, 1)
    log(f"lanes last batch under torch.profiler: {prof_ses.steps} padded "
        f"steps, wall {wall:.3f} s, {len(kern)} device events, device busy "
        f"{busy:.4f} s = {busy / wall:.1%} of the wall, idle "
        f"{1 - busy / wall:.1%}; per padded step {len(kern) / steps:.0f} "
        f"device events, {busy / steps * 1e3:.4f} ms of device busy time, "
        f"{wall / steps * 1e3:.4f} ms of wall")
    # where a step's device time goes: device time and launches per
    # padded step by kernel name, the largest first
    us, n = collections.Counter(), collections.Counter()
    for e in kern:
        us[e.name] += e.time_range.elapsed_us()
        n[e.name] += 1
    common = us.most_common(12)
    share = sum(t for _, t in common) / max(sum(us.values()), 1)
    top = [{"kernel": name[:90], "us_per_step": round(t / steps, 3),
            "per_step": round(n[name] / steps, 2)} for name, t in common]
    log(f"lanes step device time by kernel ({len(us)} names; the 12 "
        f"largest, {share:.0%} of it): {json.dumps(top)}")
    return launches


def time_rowdma(rowdma, max_err, launches, card):
    """Phase 8: device time per call of each B4/B5 instantiation at 8
    distinct rows of 32 KiB per plane — back to back (CUDA events around
    a run of calls queued behind a sleep kernel, so no host gap enters),
    beside their plain versions on the card and the library calls — and
    each kernel in a CUDA graph of 100 launches. -> the two kernel
    entries, of the (2, joined) instantiations."""
    import numpy as np
    import torch

    # 100 calls of at most 10 kernels each stay inside the card's launch
    # queue (~1024 entries): a fuller queue blocks the host behind the
    # sleep and lets host gaps into the timed run
    S, SUB, n = LANES["lanes"] + 1, 2 * LANES["accounts"] // 128, 100
    A, W = LANES["accounts"], LANES_WIDTH
    rng = np.random.default_rng(8)

    def words(shape):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).cuda()

    flat, pa, pv = (words((S, SUB, 128)) for _ in range(3))
    rows = words((W, SUB, 128))
    pa_blk, pv_blk = (torch.from_numpy(rng.integers(
        -2**63, 2**63 - 1, (W, A), dtype=np.int64)).cuda() for _ in "ab")
    lanes = torch.from_numpy(np.stack([
        rng.choice(S - 1, W, replace=False) for _ in range(n)])
        .astype(np.int32)).cuda()
    lanes64 = lanes.to(torch.int64)
    row_b = SUB * 128 * 4
    bound_ms = {"planar": (2 * W * row_b + W * 4) / HBM_BYTES_PER_S * 1e3,
                "joined": (2 * (W * row_b + W * A * 8) + W * 4)
                / HBM_BYTES_PER_S * 1e3}

    def timed(fn):
        """-> (device ms per call, host enqueue s, sleep ms, host syncs
        per call). A trial run sizes the sleep kernel to 4x its enqueue
        time, so the timed calls run back to back on the card."""
        for i in range(20):
            fn(i)
        torch.cuda.synchronize()
        with syncs_seen() as seen:
            t = time.perf_counter()
            for i in range(n):
                fn(i)
            trial = time.perf_counter() - t
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(8e9 * max(trial, 0.01)))
        ev[1].record()
        t = time.perf_counter()
        for i in range(n):
            fn(i)
        enq = time.perf_counter() - t
        ev[2].record()
        torch.cuda.synchronize()
        return (ev[1].elapsed_time(ev[2]) / n, enq,
                ev[0].elapsed_time(ev[1]), len(seen) / n)

    def graphed(fn):
        """-> device ms per launch of `fn`'s kernel in a CUDA graph of n
        launches (mean of 5 replays after a warm one)."""
        g = torch.cuda.CUDAGraph()
        before = dict(rowdma.CAPTURED)
        with torch.cuda.graph(g):
            for i in range(n):
                fn(i)
        counts = {k: v - before[k] for k, v in rowdma.CAPTURED.items()}
        g.replay()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(5):
            g.replay()
        ev[1].record()
        torch.cuda.synchronize()
        rowdma.replayed(counts, 6)
        return ev[0].elapsed_time(ev[1]) / (5 * n)

    rd = {
        "B4 (1, planar) kernel": lambda i: rowdma.gather_lane_rows(
            flat, lanes[i]),
        "B4 (1, planar) plain": lambda i: rowdma.gather_lane_rows_reference(
            flat, lanes[i]),
        "index_select": lambda i: flat.index_select(0, lanes64[i]),
        "B5 (1, planar) kernel": lambda i: rowdma.scatter_lane_rows(
            flat, lanes[i], rows, S - 1),
        "B5 (1, planar) plain": lambda i: rowdma.scatter_lane_rows_reference(
            flat, lanes[i], rows, S - 1),
        "index_copy_": lambda i: flat.index_copy_(0, lanes64[i], rows),
        "B4 (2, joined) kernel": lambda i: rowdma.gather_pos_rows(
            pa, pv, lanes[i]),
        "B4 (2, joined) plain": lambda i: rowdma.gather_pos_rows_reference(
            pa, pv, lanes[i]),
        "2 x index_select": lambda i: (pa.index_select(0, lanes64[i]),
                                       pv.index_select(0, lanes64[i])),
        "B5 (2, joined) kernel": lambda i: rowdma.scatter_pos_rows(
            pa, pv, lanes[i], pa_blk, pv_blk, S - 1),
        "B5 (2, joined) plain": lambda i: rowdma.scatter_pos_rows_reference(
            pa, pv, lanes[i], pa_blk, pv_blk, S - 1),
        "2 x index_copy_": lambda i: (pa.index_copy_(0, lanes64[i], rows),
                                      pv.index_copy_(0, lanes64[i], rows)),
    }
    ms = {}
    for name, fn in rd.items():
        ms[name], enq, sleep_ms, syncs = timed(fn)
        gaps = ("" if enq * 1e3 < sleep_ms else
                "; the enqueue outlasted the sleep: host gaps are included")
        log(f"{name}: {ms[name] * 1e3:.3f} us per call (device, back to "
            f"back, mean of {n}; host enqueue {enq * 1e3:.1f} ms under a "
            f"{sleep_ms:.1f} ms sleep; {syncs:g} host syncs per call{gaps})")
        if name.endswith("kernel"):
            g_ms = graphed(fn)
            log(f"{name} in a CUDA graph of {n} launches: {g_ms * 1e3:.3f} "
                f"us per launch (device, mean of 5 replays)")
    for form, b in bound_ms.items():
        log(f"B4/B5 ({'1, planar' if form == 'planar' else '2, joined'}) "
            f"byte bound {b * 1e3:.4f} us per call "
            f"({b * 1e-3 * HBM_BYTES_PER_S:.0f} B at 3.35 TB/s); card {card}")
    return [
        kernel_entry("rowdma_gather", "kme_tpu/ops/rowdma.py:148",
                     launches["gather_pos"], max_err,
                     ms["B4 (2, joined) kernel"], [ms["B4 (2, joined) plain"]],
                     bound_ms["joined"], "kme_tpu_torch/csrc/rowdma.cu",
                     ms["2 x index_select"]),
        kernel_entry("rowdma_scatter", "kme_tpu/ops/rowdma.py:165",
                     launches["scatter_pos"], max_err,
                     ms["B5 (2, joined) kernel"], [ms["B5 (2, joined) plain"]],
                     bound_ms["joined"], "kme_tpu_torch/csrc/rowdma.cu",
                     ms["2 x index_copy_"]),
    ]

def stream_digest(lines):
    """(MatchOut lines, sha256 of the lines each followed by a newline),
    as main_path forms them."""
    hasher = hashlib.sha256()
    for ln in lines:
        hasher.update(ln.encode())
        hasher.update(b"\n")
    return len(lines), hasher.hexdigest()


def per_message(lines):
    """A MatchOut log split into each input message's lines (every
    message opens with its IN line)."""
    out = []
    for ln in lines:
        if ln.startswith("IN "):
            out.append([])
        out[-1].append(ln)
    return out


def log_lines(broker, topic):
    return [f"{r.key} {r.value}"
            for r in broker.fetch(topic, 0, 1 << 30, timeout=0)]


def timed_checkpoints(svc, secs):
    """Time every snapshot the service writes (its wall into `secs`)."""
    orig = svc.checkpoint

    def checkpoint():
        t = time.perf_counter()
        orig()
        secs.append(time.perf_counter() - t)

    svc.checkpoint = checkpoint


def zero_launches(*counters):
    import torch

    torch.cuda.synchronize()
    for c in counters:
        for key in c:
            c[key] = 0


def seq_launches_checked(SQ, svc, label):
    import torch

    torch.cuda.synchronize()
    ses = svc._session
    key = ses.cfg.compat
    if SQ.LAUNCHES[key] != ses.dispatches or ses.dispatches == 0:
        fail(f"{label}: {SQ.LAUNCHES[key]} kernel launches for "
             f"{ses.dispatches} dispatches")
    return ses.dispatches


def crash_and_resume(SQ, values, root, kw, crash_at, label,
                     resume_kw=None):
    """`values` into a persisted broker log; a service with a checkpoint
    directory and exactly-once output runs to `crash_at` messages, then
    service and broker are dropped (no teardown) and rebuilt from disk;
    the resumed service finishes the stream. -> (stamped MatchOut log
    lines, snapshot offset, snapshot bytes, save s, broker reload s,
    restore s, duplicates suppressed)."""
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT, MatchService
    from kme_tpu_torch.runtime import checkpoint as ck

    log_dir, ck_dir = os.path.join(root, "log"), os.path.join(root, "ck")
    kw = dict(kw, checkpoint_dir=ck_dir, exactly_once=True)
    b1 = InProcessBroker(persist_dir=log_dir)
    provision(b1)
    for v in values:
        b1.produce(TOPIC_IN, None, v)
    svc1 = MatchService(b1, **kw)
    save_s = []
    timed_checkpoints(svc1, save_s)
    zero_launches(SQ.LAUNCHES)
    t = time.perf_counter()
    svc1.run(max_messages=crash_at, poll_timeout=0.05)
    wall1 = time.perf_counter() - t
    d1 = seq_launches_checked(SQ, svc1, f"{label} first incarnation")
    snap = svc1._last_ckpt_offset
    if len(save_s) != 1 or not 0 < snap < svc1.offset:
        fail(f"{label}: {len(save_s)} snapshots, the last at {snap} of "
             f"{svc1.offset} messages run")
    path = ck.snapshot_path(ck_dir, snap)
    nbytes = os.path.getsize(path)
    ran = svc1.offset
    del svc1, b1                    # the whole process dies
    t = time.perf_counter()
    b2 = InProcessBroker(persist_dir=log_dir)
    reload_s = time.perf_counter() - t
    t = time.perf_counter()
    svc2 = MatchService(b2, **dict(kw, **(resume_kw or {})))
    restore_s = time.perf_counter() - t
    if svc2.offset != snap:
        fail(f"{label}: resumed at {svc2.offset}, the snapshot is at {snap}")
    zero_launches(SQ.LAUNCHES)
    t = time.perf_counter()
    svc2.run(max_messages=len(values) - snap, poll_timeout=0.05)
    wall2 = time.perf_counter() - t
    d2 = seq_launches_checked(SQ, svc2, f"{label} resumed")
    lines = log_lines(b2, TOPIC_OUT)
    dups = b2.dup_suppressed
    svc2.close()
    log(f"{label}: first incarnation {ran} messages in {wall1:.3f} s "
        f"({d1} dispatches = launches), snapshot at offset {snap}: "
        f"{nbytes} bytes, saved in {save_s[0]:.3f} s; broker log reloaded "
        f"in {reload_s:.3f} s; service restored in {restore_s:.3f} s; "
        f"resumed run {len(values) - snap} messages in {wall2:.3f} s ({d2} "
        f"dispatches = launches); {dups} replayed records suppressed by "
        f"their (epoch, out_seq) stamps (host clock)")
    return lines, snap


def serving_phase(SQ, rowdma, zipf, java_msgs, b1, card):
    """Phase 10: the serving stack on the card (see the module
    docstring); `b1` = (MatchOut lines, sha256) of phase 4. -> 10a's
    wall, spans, dispatches and kernel seconds."""
    import shutil
    import tempfile
    import threading

    import torch
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.consume import consume_lines
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT, MatchService
    from kme_tpu_torch.bridge.tcp import TcpBroker, serve_broker
    from kme_tpu_torch.runtime import checkpoint as ck
    from kme_tpu_torch.runtime.seqsession import SeqSession
    from kme_tpu_torch.wire import dumps_order, parse_order
    from kme_tpu_torch.workload import harness_stream

    root = tempfile.mkdtemp(prefix="kme_serving_")
    values = [dumps_order(m) for m in zipf]
    try:
        # ---- (a) the pipelined seq service over TCP
        t_phase = time.perf_counter()
        srv, broker = serve_broker("127.0.0.1", 0, InProcessBroker())
        host, port = srv.server_address[:2]
        client = TcpBroker(host, port)
        try:
            provision(client)
            t = time.perf_counter()
            for lo in range(0, len(values), 4096):
                client.produce_batch(TOPIC_IN, [(None, v) for v in
                                                values[lo:lo + 4096]])
            prod_s = time.perf_counter() - t
            svc = MatchService(broker, engine="seq", compat="fixed",
                               pipeline=2, **SERVE)
            if svc.pipeline != 2:
                fail("serve-tcp: the service did not take the pipeline")
            zero_launches(SQ.LAUNCHES)
            with kernel_events(SQ) as evs:
                t = time.perf_counter()
                n = svc.run(max_messages=len(values), poll_timeout=0.05)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            dispatches = seq_launches_checked(SQ, svc, "serve-tcp")
            kern_s = sum(e0.elapsed_time(e1) for e0, e1 in evs) / 1e3
            gauges = svc.telemetry.snapshot()["gauges"]
            spans = dict(svc._ptimer.totals)
            svc.close()
            t = time.perf_counter()
            lines = list(consume_lines(client, follow=False))
            cons_s = time.perf_counter() - t
        finally:
            client.close()
            srv.shutdown()
            srv.server_close()
        got = stream_digest(lines)
        if n != len(values) or got != b1:
            fail(f"serve-tcp: {n} messages served, MatchOut {got[0]} lines "
                 f"sha256 {got[1]}; B1 gives {b1[0]} lines sha256 {b1[1]}")
        log(f"serve-tcp: {len(values)} messages produced over TCP in "
            f"{prod_s:.3f} s; served in {wall:.3f} s = "
            f"{len(values) / wall:.0f} msg/s (host clock, synchronized; "
            f"{dispatches} dispatches = kernel launches); MatchOut "
            f"consumed over TCP in {cons_s:.3f} s == B1's ({got[0]} lines, "
            f"sha256 {got[1]}); card {card}")
        log(f"serve-tcp: kernel time (CUDA events) {kern_s:.4f} s = "
            f"{kern_s / wall:.1%} of the service wall; gauges plan_s "
            f"{gauges['plan_s']} recon_s {gauges['recon_s']} host_path_s "
            f"{gauges['host_path_s']} device_ms_per_batch "
            f"{gauges['device_ms_per_batch']} h2d_overlap_frac "
            f"{gauges.get('h2d_overlap_frac')}; session phases "
            + json.dumps({k: round(v, 4)
                          for k, v in svc._session.phases.items()}))
        rest = wall - sum(spans.values())
        log(f"serve-tcp: service wall by span (s, host clock): serve_engine "
            f"(submit + collect) {spans.get('serve_engine', 0):.4f}, "
            f"serve_produce (MatchOut into the broker, "
            f"{len(lines)} produce calls) {spans.get('serve_produce', 0):.4f}"
            f", the rest (broker fetch, JSON join and parse, counters, "
            f"metrics refresh) {rest:.4f}")
        per_msg = per_message(lines)
        unobserved = {"wall": wall, "spans": spans,
                      "dispatches": dispatches, "kern_s": kern_s}
        del svc, broker, lines
        log(f"phase 10a took {time.perf_counter() - t_phase:.1f} s")

        # ---- (b) crash and resume, exactly once, seq fixed
        t_phase = time.perf_counter()
        kw = dict(engine="seq", compat="fixed", pipeline=2,
                  checkpoint_every=SERVE_CKPT_EVERY, **SERVE)
        lines, _ = crash_and_resume(SQ, values, os.path.join(root, "b"), kw,
                                    SERVE_CRASH_AT, "crash-resume")
        got = stream_digest(lines)
        if got != b1:
            fail(f"crash-resume: MatchOut log {got[0]} lines sha256 "
                 f"{got[1]}; B1 gives {b1[0]} lines sha256 {b1[1]}")
        log(f"crash-resume: the stamped MatchOut log == B1's ({got[0]} "
            f"lines, sha256 {got[1]})")
        del lines
        log(f"phase 10b took {time.perf_counter() - t_phase:.1f} s")

        # ---- (c) java at 8192 slots, one seqjava checkpoint, a resume
        t_phase = time.perf_counter()
        kw = dict(SERVE, engine="seq", compat="java", slots=8192,
                  checkpoint_every=JAVA_CKPT_EVERY)
        lines, snap = crash_and_resume(
            SQ, [dumps_order(m) for m in java_msgs], os.path.join(root, "c"),
            kw, SERVE_CRASH_AT, "java",
            resume_kw={"checkpoint_every": 1 << 30})
        got = stream_digest(lines)
        if got != (JAVA_LINES, JAVA_SHA256):
            fail(f"java service: MatchOut log {got[0]} lines sha256 "
                 f"{got[1]}; the java oracle gives {JAVA_LINES} lines "
                 f"sha256 {JAVA_SHA256}")
        log(f"java service: resumed from the seqjava snapshot at {snap}; "
            f"the MatchOut log == the java oracle's ({got[0]} lines, sha256 "
            f"{got[1]})")
        del lines
        log(f"phase 10c took {time.perf_counter() - t_phase:.1f} s")

        # ---- (d) lanes through the service, its snapshot into seq
        t_phase = time.perf_counter()
        P, cut = LANES_PREFIX, LANES_CUT
        want = [ln for m in per_msg[:P] for ln in m]
        ck_dir = os.path.join(root, "d")
        b = InProcessBroker()
        provision(b)
        for v in values[:P]:
            b.produce(TOPIC_IN, None, v)
        svc = MatchService(b, engine="lanes", width=LANES_WIDTH,
                           checkpoint_dir=ck_dir, checkpoint_every=cut,
                           **SERVE)
        ses = svc._session
        ses.capture()           # set-up: its warm-up step counts launches
        zero_launches(rowdma.LAUNCHES)
        t = time.perf_counter()
        svc.run(max_messages=P, poll_timeout=0.05)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        lanes_out = log_lines(b, TOPIC_OUT)
        launches = dict(rowdma.LAUNCHES)
        if any(launches[k] != ses.steps for k in ("gather_pos",
                                                  "scatter_pos")):
            fail(f"lanes service: launches {launches} for {ses.steps} "
                 f"padded steps")
        if lanes_out != want:
            fail(f"lanes service: MatchOut of the first {P} messages != "
                 f"B1's")
        if svc._last_ckpt_offset != cut:
            fail(f"lanes service: the snapshot is at "
                 f"{svc._last_ckpt_offset}, not {cut}")
        nbytes = os.path.getsize(ck.snapshot_path(ck_dir, cut))
        log(f"lanes service: {P} messages in {wall:.3f} s = "
            f"{P / wall:.0f} msg/s (host clock, synchronized), "
            f"{ses.steps} padded steps = B4 = B5 launches; MatchOut == "
            f"B1's for those messages; lanes snapshot at {cut}: {nbytes} "
            f"bytes")
        del svc, ses, b
        b = InProcessBroker()
        provision(b)
        for v in values[:P]:
            b.produce(TOPIC_IN, None, v)
        t = time.perf_counter()
        svc = MatchService(b, engine="seq", compat="fixed",
                           checkpoint_dir=ck_dir, checkpoint_every=1 << 30,
                           **SERVE)
        restore_s = time.perf_counter() - t
        if svc.offset != cut:
            fail(f"lanes -> seq: the seq service resumed at {svc.offset}")
        zero_launches(SQ.LAUNCHES)
        svc.run(max_messages=P - cut, poll_timeout=0.05)
        seq_launches_checked(SQ, svc, "lanes -> seq")
        seq_out = log_lines(b, TOPIC_OUT)
        if seq_out != [ln for m in per_msg[cut:P] for ln in m]:
            fail("lanes -> seq: the seq service's MatchOut for messages "
                 f"{cut}..{P} != B1's")
        log(f"lanes -> seq: the lanes snapshot restored into a seq service "
            f"in {restore_s:.3f} s; its MatchOut for messages {cut}..{P} == "
            f"B1's ({len(seq_out)} lines)")
        del svc, b, want, lanes_out, seq_out
        log(f"phase 10d took {time.perf_counter() - t_phase:.1f} s")

        # ---- (e) card and CPU sessions write the same snapshot
        t_phase = time.perf_counter()
        cfg = SQ.SeqConfig(**FULL)
        gpu, cpu = SeqSession(cfg), SeqSession(cfg, device="cpu")
        for lo in range(0, 4 * cfg.batch, cfg.batch):
            part = zipf[lo:lo + cfg.batch]
            if gpu.process_wire(part) != cpu.process_wire(part):
                fail(f"snapshot digests: card != CPU MatchOut at {lo}")
        dig = []
        for name, ses in (("card", gpu), ("cpu", cpu)):
            path = ck.save_seq_session(os.path.join(root, "e", name), ses,
                                       4 * cfg.batch)
            data, _ = ck._load_file(path)
            dig.append(bytes(data["digest"]).decode())
        if dig[0] != dig[1]:
            fail(f"snapshot digests: card {dig[0]} != CPU {dig[1]}")
        log(f"snapshot digests after 4 full-width batches: card == CPU "
            f"(sha256 {dig[0]})")
        del gpu, cpu
        log(f"phase 10e took {time.perf_counter() - t_phase:.1f} s")

        # ---- (f) the CLI once: serve on the card, fed by loadgen
        t_phase = time.perf_counter()
        hmsgs = harness_stream(CLI_EVENTS, seed=0, payout_opcode_bug=False,
                               validate=True)
        hvalues = [dumps_order(m) for m in hmsgs]
        b = InProcessBroker()
        provision(b)
        for v in hvalues:
            b.produce(TOPIC_IN, None, v)
        ref = MatchService(b, engine="seq", compat="fixed", device="cpu",
                           **SERVE)
        ref.run(max_messages=len(hvalues), poll_timeout=0.05)
        want = log_lines(b, TOPIC_OUT)
        del ref, b
        if [parse_order(v) for v in hvalues] != hmsgs:
            fail("harness stream: the JSON does not round-trip")
        cli = [sys.executable, "-m", "kme_tpu_torch.cli"]
        env = dict(os.environ, PYTHONPATH=ROOT)
        # the serve ends 10 s after its input goes idle: the loadgen (no
        # torch import) produces before the serve's loop starts, and the
        # consumer below reads while it waits
        serve = subprocess.Popen(
            cli + ["serve", "--listen", "127.0.0.1:0", "--engine", "seq",
                   "--pipeline", "2", "--auto-provision", "--idle-exit",
                   "10"], cwd=ROOT, env=env, stderr=subprocess.PIPE,
            text=True)
        errs = []
        try:
            addr = None
            while addr is None:
                line = serve.stderr.readline()
                if not line:
                    fail(f"CLI serve exited before listening: {errs}")
                errs.append(line.rstrip())
                if "broker listening on" in line:
                    addr = line.rsplit(" ", 1)[1].strip()
            drain = threading.Thread(
                target=lambda: errs.extend(ln.rstrip()
                                           for ln in serve.stderr),
                daemon=True)
            drain.start()
            gen = subprocess.run(
                cli + ["loadgen", "--events", str(CLI_EVENTS), "--seed", "0",
                       "--validate", "--fix-payout-opcode", "--broker",
                       addr], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=300)
            if gen.returncode != 0:
                fail(f"CLI loadgen rc={gen.returncode}: {gen.stderr}")
            h, p = addr.rsplit(":", 1)
            client = TcpBroker(h, int(p))
            got = []
            try:
                for ln in consume_lines(client, follow=True,
                                        poll_timeout=0.5, idle_exit=60):
                    got.append(ln)
                    if len(got) == len(want):
                        break
            finally:
                client.close()
            rc = serve.wait(timeout=120)
            drain.join(timeout=30)
        finally:
            if serve.poll() is None:
                serve.kill()
                serve.wait()
        if rc != 0:
            fail(f"CLI serve rc={rc}: {errs[-5:]}")
        if got != want:
            fail(f"CLI serve: {len(got)} MatchOut lines != the CPU "
                 f"service's {len(want)}")
        log(f"CLI serve on the card fed by the CLI loadgen ({len(hvalues)} "
            f"messages): MatchOut == the CPU service's ({len(want)} lines, "
            f"sha256 {stream_digest(want)[1]}); serve said "
            f"{[e for e in errs if 'processed' in e]}")
        log(f"phase 10f took {time.perf_counter() - t_phase:.1f} s")
        return unobserved
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 11: the seq fleet and the sharded lanes engine


def canon_digest(canon) -> str:
    """sha256 over a canonical state dict's arrays (name, dtype, shape,
    bytes), in name order."""
    import numpy as np

    h = hashlib.sha256()
    for k in sorted(canon):
        if canon[k] is None:
            continue
        a = np.ascontiguousarray(np.asarray(canon[k]))
        h.update(f"{k} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def buffer_lines(parts, nmsgs):
    """The MatchOut lines of the first `nmsgs` messages of
    process_wire_buffer results."""
    out = []
    done = 0
    for buf, off, msg_lines in parts:
        li = 0
        for nl in msg_lines.tolist():
            if done == nmsgs:
                return out
            out.extend(buf[off[li + k]:off[li + k + 1]].decode()
                       for k in range(nl))
            li += nl
            done += 1
    return out


@contextlib.contextmanager
def stream_kernel_events(SQ):
    """CUDA events around every seq_scan call, on the stream it launches
    on; yields {stream handle: [(start, end), ...]}."""
    import torch

    orig, by_stream = SQ.seq_scan, collections.defaultdict(list)

    def timed(*a, **kw):
        stream = torch.cuda.current_stream()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
        out = orig(*a, **kw)
        ev[1].record(stream)
        by_stream[stream.cuda_stream].append(ev)
        return out

    SQ.seq_scan = timed
    try:
        yield by_stream
    finally:
        SQ.seq_scan = orig


def fleet_run(SQ, SM, cfg, shards, mode, batches, want, want_canon, label,
              want_name="B1's"):
    """One fleet run over `batches` (WireBatches) through
    process_wire_buffer, the launch counts set to 0 just before and read
    just after: MatchOut `want` (`want_name`'s), launches = the fleet's
    dispatches with
    every shard launching on its own (non-default) stream, and, when
    `want_canon` is given, the stitched canonical state's digest. ->
    (the session, its launches, its MatchOut parts, its wall s)."""
    import torch

    ses = SM.SeqMeshSession(cfg, shards, dispatch=mode)
    zero_launches(SQ.LAUNCHES)
    parts = []
    with stream_kernel_events(SQ) as evs:
        t = time.perf_counter()
        for b in batches:
            r = ses.process_wire_buffer(b)
            if r is None:
                fail(f"{label}: process_wire_buffer gave None")
            parts.append(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = dict(SQ.LAUNCHES)
    nmsgs = sum(b.n for b in batches)
    got = buffer_digest(parts)
    if got != want:
        fail(f"{label}: MatchOut {got[0]} lines sha256 {got[1]} != "
             f"{want[0]} lines sha256 {want[1]}")
    if (launches["fixed"] != ses.dispatches or ses.dispatches == 0
            or launches["java"] or launches["rows_in_use"]):
        fail(f"{label}: launches {launches} for {ses.dispatches} "
             f"dispatches")
    default = torch.cuda.default_stream().cuda_stream
    if (len(evs) != shards or default in evs
            or not (ses.shard_dispatches > 0).all()):
        fail(f"{label}: launches on {len(evs)} streams (default stream "
             f"among them: {default in evs}), per shard "
             f"{ses.shard_dispatches.tolist()}")
    kern = {h: sum(e0.elapsed_time(e1) for e0, e1 in pairs) / 1e3
            for h, pairs in evs.items()}
    kern_s = sorted(kern.values(), reverse=True)
    stats = ses.stall_stats()
    log(f"{label}: {nmsgs} messages in {wall:.3f} s = {nmsgs / wall:.0f} "
        f"msg/s (host clock, synchronized); MatchOut == {want_name} "
        f"({got[0]} "
        f"lines, sha256 {got[1]}); {ses.dispatches} kernel launches on "
        f"{len(evs)} shard streams (per shard "
        f"{ses.shard_dispatches.tolist()})")
    log(f"{label} per-shard walls (s, CUDA events, first submit to last "
        f"segment's end, summed over batches): "
        f"{[round(float(w), 4) for w in ses.walls_total]}; kernel time per "
        f"shard stream (s, CUDA events around each seq_scan): "
        f"{[round(k, 4) for k in kern_s]}, the busiest "
        f"{kern_s[0] / wall:.1%} of the wall, all shards "
        f"{sum(kern_s) / wall:.1%}")
    log(f"{label} stall_stats {json.dumps(stats)}; shard_stats "
        f"{json.dumps(ses.shard_stats())}")
    log(f"{label} phases (s, host clock; dispatch_s holds slice_s, "
        f"stage_s, launch_s, patch_s and merge_s; fetch_s includes waiting "
        f"for the kernels; rebalance_s is plan_rebalance, migrate_s the "
        f"migrations): "
        + json.dumps({k: round(v, 4) for k, v in ses.phases.items()}))
    if want_canon is not None:
        t = time.perf_counter()
        dig = canon_digest(ses.export_canonical_global())
        if dig != want_canon:
            fail(f"{label}: export_canonical_global digest {dig} != the "
                 f"serial session's {want_canon}")
        log(f"{label}: export_canonical_global == the serial card "
            f"session's export_canonical (sha256 {dig}, "
            f"{time.perf_counter() - t:.2f} s)")
    return ses, launches["fixed"], parts, wall


def fleet_segments_checked(SQ, SM, cfg, batches, label):
    """11c: a fresh 4-shard async fleet fed the batches up to
    FLEET_CHECK_BATCH; in that batch each shard's first segment is
    launched from a copy of the shard's state taken on its stream just
    before, and replayed from that copy through the plain version:
    output planes (header rows and used fill prefix of every window) and
    the state after must be bit-equal. -> max abs err."""
    import torch

    class Recorded(SM.SeqMeshSession):
        recording = False

        def _stage_and_dispatch(self, s, win_idx, seg):
            if not self.recording or s in self.taken:
                return super()._stage_and_dispatch(s, win_idx, seg)
            with self._on(s):
                pre = {k: v.clone() for k, v in self._shard_states[s].items()}
            out = super()._stage_and_dispatch(s, win_idx, seg)
            with self._on(s):
                post = {k: v.clone()
                        for k, v in self._shard_states[s].items()}
            self.taken[s] = (dict(seg), pre, post, out)
            return out

    ses = Recorded(cfg, 4)
    ses.taken = {}
    for i, b in enumerate(batches[:FLEET_CHECK_BATCH + 1]):
        ses.recording = i == FLEET_CHECK_BATCH
        ses.process_wire_buffer(b)
    torch.cuda.synchronize()
    if sorted(ses.taken) != [0, 1, 2, 3]:
        fail(f"{label}: batch {FLEET_CHECK_BATCH} launched on shards "
             f"{sorted(ses.taken)} only")
    lcfg, max_err, msgs, plain_s = ses.local_cfg, 0, 0, 0.0
    for s, (seg, pre, post, out) in sorted(ses.taken.items()):
        ref_state = {k: v.cpu() for k, v in pre.items()}
        stacked = {f: torch.from_numpy(seg[f]) for f in SQ.MSG_FIELDS}
        t = time.perf_counter()
        ref_out = SQ.seq_scan_reference(lcfg, ref_state, stacked)
        plain_s += time.perf_counter() - t
        for i in range(ref_out.shape[0]):
            err, bad = planes_equal(SQ, lcfg, post, ref_state, out.out[i],
                                    ref_out[i])
            max_err = max(max_err, err)
            if bad:
                fail(f"{label}: shard {s} window {seg_win(out, i)}: kernel "
                     f"!= plain version in {bad} (max abs err {err})")
        msgs += int((seg["act"] != 0).sum())
        log(f"{label}: shard {s}'s first segment of batch "
            f"{FLEET_CHECK_BATCH} ({len(out.win_idx)} windows, "
            f"{int((seg['act'] != 0).sum())} messages, fill_total "
            f"{[int(out.out[i][0, 1]) for i in range(len(out.win_idx))]}) "
            f"== the plain version on a copy of its pre-state, bit for bit "
            f"(state planes, header rows, used fill prefix)")
    log(f"{label}: {msgs} messages over 4 shard segments, plain version "
        f"{plain_s:.2f} s on the host CPU, max abs err {max_err}")
    return max_err


def seg_win(seg, i):
    return seg.win_idx[i] if i < len(seg.win_idx) else f"pad {i}"


def fleet_phase(SQ, SS, SM, L, LS, rowdma, zipf, batches, WireBatch,
                zipf_hot_stream, card):
    """Phase 11 (see the module docstring). -> (B1 launches of the fleet
    runs, max abs err of 11c)."""
    import torch

    cfg = SQ.SeqConfig(**FULL)
    want = B1_MATCHOUT
    # the serial card session over the same batches: its canonical
    # state, and B1's lines of the lanes prefix
    t_phase = time.perf_counter()
    serial = SS.SeqSession(cfg)
    parts = [serial.process_wire_buffer(b) for b in batches]
    if buffer_digest(parts) != want:
        fail("fleet: the serial card session's MatchOut != B1's")
    want_canon = canon_digest(SQ.export_canonical(cfg, serial.state))
    prefix = buffer_lines(parts, LANES_PREFIX)
    del serial, parts
    log(f"fleet: the serial card session's export_canonical sha256 "
        f"{want_canon}")

    # ---- 11a. the fleet over the zipf stream
    launches = 0
    for shards, mode in FLEET_RUNS:
        label = f"fleet {shards} {mode}"
        ses, n, _, _ = fleet_run(SQ, SM, cfg, shards, mode, batches, want,
                                 want_canon, label)
        launches += n
        del ses
    log(f"phase 11a took {time.perf_counter() - t_phase:.1f} s")

    # ---- 11b. zipf-hot: migrations, against the serial card session
    t_phase = time.perf_counter()
    hot = zipf_hot_stream(**HOT_STREAM)
    hot_batches = [WireBatch.from_msgs(hot[lo:lo + cfg.batch])
                   for lo in range(0, len(hot), cfg.batch)]
    serial = SS.SeqSession(cfg)
    hot_want = buffer_digest([serial.process_wire_buffer(b)
                              for b in hot_batches])
    del serial
    ses, n, _, _ = fleet_run(SQ, SM, cfg, 4, "async", hot_batches, hot_want,
                             None, "fleet zipf-hot 4 async",
                             "the serial card session's")
    launches += n
    if ses.shard_stats()["migrations"] == 0:
        fail("fleet zipf-hot: no migration")
    log(f"fleet zipf-hot: {len(hot)} messages in slices of {cfg.batch}, "
        f"MatchOut == the serial card session's ({hot_want[0]} lines, "
        f"sha256 {hot_want[1]}); {ses.shard_stats()['migrations']} lanes "
        f"migrated in {ses.shard_stats()['rebalances']} rebalances")
    del ses
    log(f"phase 11b took {time.perf_counter() - t_phase:.1f} s")

    # ---- 11c. B1 on the fleet's streams against its plain version
    t_phase = time.perf_counter()
    max_err = fleet_segments_checked(SQ, SM, cfg, batches, "fleet check")
    log(f"phase 11c took {time.perf_counter() - t_phase:.1f} s")

    # ---- 11d. the sharded lanes engine over the zipf prefix (a cut: the
    # whole stream runs at one shard in phase 7)
    t_phase = time.perf_counter()
    P = LANES_PREFIX
    ses = LS.LaneSession(L.LaneConfig(**LANES), shards=FLEET_LANES_SHARDS)
    t = time.perf_counter()
    ses.capture()             # set-up, like the kernels' build
    capture_s = time.perf_counter() - t
    zero_launches(rowdma.LAUNCHES)
    spans = []
    orig = ses._replay

    def replay(T):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        orig(T)
        ev[1].record()
        spans.append(ev)

    ses._replay = replay
    lines = []
    t = time.perf_counter()
    for lo in range(0, P, cfg.batch):
        for per in ses.process_wire(zipf[lo:min(lo + cfg.batch, P)]):
            lines.extend(per)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if lines != prefix:
        fail(f"sharded lanes: MatchOut of the first {P} messages != B1's")
    if any(rowdma.LAUNCHES.values()):
        fail(f"sharded lanes: row-copy launches {dict(rowdma.LAUNCHES)}")
    st = ses.graph_stats
    if st["captures"] != 1 or st["replays"] != ses.steps:
        fail(f"sharded lanes: graph stats {st} for {ses.steps} steps")
    dev_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
    log(f"sharded lanes {FLEET_LANES_SHARDS} shards: {P} messages in "
        f"{wall:.3f} s = {P / wall:.0f} msg/s (host clock, synchronized); "
        f"MatchOut == B1's for those messages ({len(lines)} lines); "
        f"{ses.steps} padded steps, {wall * 1e3 / ses.steps:.4f} ms per "
        f"padded step on the host clock, {dev_ms / ses.steps:.4f} ms per "
        f"padded step between CUDA events around the replays; the sharded "
        f"step graph captured once in {capture_s:.2f} s (capture "
        f"{st['capture_s']:.3f} s, instantiate {st['instantiate_s']:.3f} "
        f"s), {st['replay_s'] * 1e6 / max(st['replays'], 1):.1f} µs of host "
        f"per replay; no row-copy launch")
    log(f"sharded lanes phases (s, host clock): "
        + json.dumps({k: round(v, 4) for k, v in ses.phases.items()}))
    del ses
    log(f"phase 11d took {time.perf_counter() - t_phase:.1f} s")
    return launches, max_err


# ---------------------------------------------------------------------------
# phase 12: the service's observability


def hits_digest(hits):
    """(count, sha256 of the JSON list of [offset, predicate, value]) of
    a watch hit set."""
    doc = json.dumps([list(h) for h in hits])
    return len(hits), hashlib.sha256(doc.encode()).hexdigest()


def http_get(port, path):
    from urllib.request import urlopen

    with urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def timed_method(obj, name, secs):
    """Add the wall of every call of `obj.name` to `secs[name]`."""
    orig = getattr(obj, name)
    secs[name] = 0.0

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            secs[name] += time.perf_counter() - t

    setattr(obj, name, timed)


def trace_kernels(path):
    """Kernel slices in a torch.profiler Chrome trace: (all, seq_scan's)."""
    with open(path) as f:
        evs = json.load(f).get("traceEvents", [])
    kern = [e for e in evs if e.get("cat") == "kernel"]
    return len(kern), sum("seq_scan_kernel" in e.get("name", "")
                          for e in kern)


def drill_run(SQ, values, root, tamper, label, **kw):
    """`values` into a persisted broker log and through a journaled,
    audited seq service (pipeline 2, the serve defaults) with
    KME_AUDIT_TAMPER=`tamper`, launches checked. -> (the closed service,
    journal path, broker log dir)."""
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN, MatchService

    log_dir = os.path.join(root, "log")
    jp = os.path.join(root, "journal.bin")
    b = InProcessBroker(persist_dir=log_dir)
    provision(b)
    for v in values:
        b.produce(TOPIC_IN, None, v)
    os.environ["KME_AUDIT_TAMPER"] = tamper
    try:
        svc = MatchService(b, engine="seq", compat="fixed", pipeline=2,
                           journal=jp, audit=True,
                           audit_repro_dir=os.path.join(root, "repro"),
                           **SERVE, **kw)
    finally:
        del os.environ["KME_AUDIT_TAMPER"]
    zero_launches(SQ.LAUNCHES)
    svc.run(max_messages=len(values), poll_timeout=0.05)
    d = seq_launches_checked(SQ, svc, label)
    svc.close()
    return svc, jp, log_dir, d


def observed_phase(SQ, rowdma, zipf, b1, card, unobserved):
    """Phase 12: the serving stack with every observability option on (see
    the module docstring); `unobserved` is phase 10a's run. -> (B1
    launches, B4 launches, B5 launches) of this phase's checked runs."""
    import shutil
    import tempfile
    import threading

    import torch
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.consume import consume_lines
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT, MatchService
    from kme_tpu_torch.bridge.tcp import TcpBroker, serve_broker
    from kme_tpu_torch.telemetry import (canonical_lines, read_events,
                                         read_transfer_artifact,
                                         replay_repro, start_metrics_server)
    from kme_tpu_torch.telemetry import events as cpevents
    from kme_tpu_torch.telemetry import tsdb as tsdbm
    from kme_tpu_torch.telemetry import xray
    from kme_tpu_torch.telemetry.profiler import list_captures
    from kme_tpu_torch.wire import dumps_order

    root = tempfile.mkdtemp(prefix="kme_observed_")
    values = [dumps_order(m) for m in zipf]
    try:
        # ---- (a) the pipelined seq service over TCP, every option on
        t_phase = time.perf_counter()
        a = os.path.join(root, "a")
        os.makedirs(a)
        art = os.path.join(a, "transfer.json")
        # an entry another backend wrote: the card's must leave it as is
        seed = {"cpu": {"probe_bytes": 8 << 20, "recorded_at": 0.0}}
        with open(art, "w") as f:
            json.dump(seed, f)
        jp = os.path.join(a, "journal.bin")
        ck_dir = os.path.join(a, "ck")
        srv, broker = serve_broker("127.0.0.1", 0, InProcessBroker())
        host, port = srv.server_address[:2]
        client = TcpBroker(host, port)
        scrapes = []
        try:
            provision(client)
            for lo in range(0, len(values), 4096):
                client.produce_batch(TOPIC_IN, [(None, v) for v in
                                                values[lo:lo + 4096]])
            t = time.perf_counter()
            svc = MatchService(
                broker, engine="seq", compat="fixed", pipeline=2,
                checkpoint_dir=ck_dir, checkpoint_every=SERVE_CKPT_EVERY,
                exactly_once=True, journal=jp, audit=True,
                audit_repro_dir=os.path.join(a, "repro"), trace_spans=True,
                slo={"p99_ms": OBSERVED_SLO_MS}, tsdb=os.path.join(a, "tsdb"),
                profile=True, profile_artifact=art,
                capture_dir=os.path.join(a, "cap"),
                capture_p99_us=int(OBSERVED_SLO_MS * 1e3),
                watch=list(OBSERVED_WATCH), **SERVE)
            init_s = time.perf_counter() - t
            if svc.pipeline != 2:
                fail("serve-observed: the service did not take the pipeline")
            window_s = svc.capture.window_s
            if not window_s > 0:
                fail("serve-observed: a capture on the card records no "
                     "torch.profiler window")
            msrv = start_metrics_server(svc.telemetry, 0, host="127.0.0.1")
            mport = msrv.server_address[1]
            save_s = []
            timed_checkpoints(svc, save_s)
            # the rest of the wall, in parts: the per-batch counters and
            # the rate-limited refresh (metrics, SLO, profiler, capture
            # triggers), the captures with their profiler windows, and
            # the device plane's byte probes (inside serve_engine)
            parts = {}
            timed_method(svc, "_publish_batch", parts)
            timed_method(svc.capture, "maybe_fire", parts)
            timed_method(svc._session, "_count_bytes", parts)
            stop = threading.Event()

            def scraper():
                while not stop.wait(0.5):
                    try:
                        scrapes.append(len(http_get(mport,
                                                    "/metrics.json")))
                    except OSError as e:
                        scrapes.append(repr(e))

            th = threading.Thread(target=scraper, daemon=True)
            zero_launches(SQ.LAUNCHES)
            th.start()
            t = time.perf_counter()
            n = svc.run(max_messages=len(values), poll_timeout=0.05,
                        health_file=os.path.join(a, "health.json"),
                        health_every=0.5)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            stop.set()
            th.join()
            dispatches = seq_launches_checked(SQ, svc, "serve-observed")
            prom = http_get(mport, "/metrics")
            spans = dict(svc._ptimer.totals)
            timing = svc._session.device_timing()
            slo_reason = svc._slo_reason
            prof_g = {k: v for k, v in
                      svc.telemetry.snapshot()["gauges"].items()
                      if k.startswith("prof_")}
            t = time.perf_counter()
            svc.close()
            close_s = time.perf_counter() - t
            msrv.shutdown()
            msrv.server_close()
            lines = list(consume_lines(client, follow=False))
        finally:
            client.close()
            srv.shutdown()
            srv.server_close()
        got = stream_digest(lines)
        if n != len(values) or got != b1:
            fail(f"serve-observed: {n} messages served, MatchOut {got[0]} "
                 f"lines sha256 {got[1]}; B1 gives {b1[0]} lines sha256 "
                 f"{b1[1]}")
        prefix = [ln for m in per_message(lines)[:DRILL_PREFIX] for ln in m]
        del lines
        aud = svc.auditor
        if aud.violations or svc.degraded:
            fail(f"serve-observed: audit violations {aud.violations[:3]}")
        checks = svc.engine_checks
        if len(checks) < 3 or any(v for _off, v in checks):
            fail(f"serve-observed: check_engine at the checkpoints gave "
                 f"{checks} (need 3 or more, each with no violation)")
        evs = read_events(jp)
        canon = stream_digest(canonical_lines(evs))
        if canon != OBSERVED_CANON:
            fail(f"serve-observed: canonical journal events {canon}; the "
                 f"CPU runs of both packages give {OBSERVED_CANON}")
        kinds = collections.Counter(ev["e"] for ev in evs)
        if kinds["lat"] != len(values) or kinds["span"] != 4 * len(values):
            fail(f"serve-observed: {kinds['lat']} lat and {kinds['span']} "
                 f"span events for {len(values)} messages")
        del evs
        hits = hits_digest(svc.watch.hits)
        if hits != OBSERVED_HITS:
            fail(f"serve-observed: watch hit set {hits}; the CPU runs of "
                 f"both packages give {OBSERVED_HITS}")
        rep = tsdbm.verify_store(os.path.join(a, "tsdb"))
        samples = sum(1 for _ in tsdbm.read_samples(os.path.join(a, "tsdb")))
        if rep["mismatched"] or not samples:
            fail(f"serve-observed: TSDB {rep}, {samples} samples")
        erep = cpevents.verify_log(cpevents.log_path(ck_dir, "serve"))
        if not erep["ok"] or erep["seq_gaps"] or not erep["events"]:
            fail(f"serve-observed: event log {erep}")
        bad = [x for x in scrapes if isinstance(x, str)]
        if bad or not scrapes or "audit_batches" not in prom \
                or "lat_e2e" not in prom:
            fail(f"serve-observed: /metrics scrapes {scrapes[:5]}, "
                 f"{len(prom)} bytes of Prometheus text")
        doc = read_transfer_artifact(art)
        plane = doc.get("cuda") or {}
        if doc.get("cpu") != seed["cpu"]:
            fail(f"serve-observed: the artifact's cpu entry changed: {doc}")
        if (plane.get("dispatches_timed") != dispatches
                or not plane.get("kernel_ms_per_dispatch")
                or not plane.get("bytes_per_batch")
                or not plane.get("h2d_bytes_per_s")):
            fail(f"serve-observed: device plane {plane}")
        caps = list_captures(os.path.join(a, "cap"))
        trig = []
        for pth in caps:
            with open(pth) as f:
                cdoc = json.load(f)
            if cdoc.get("device_trace"):
                trig.append(cdoc)
        if not trig or not os.path.exists(trig[0]["device_trace"]):
            fail(f"serve-observed: no trigger capture with a device trace "
                 f"({len(caps)} captures)")
        nk, nseq = trace_kernels(trig[0]["device_trace"])
        if nseq == 0:
            fail(f"serve-observed: the capture's torch.profiler window "
                 f"holds {nk} kernel slices, none of seq_scan_kernel")
        ckpt_s = sum(save_s)
        obs_s = spans.get("serve_observe", 0.0)
        eng_s = spans.get("serve_engine", 0.0)
        prod_s = spans.get("serve_produce", 0.0)
        rest = wall - eng_s - prod_s - obs_s - ckpt_s
        u = unobserved
        log(f"serve-observed: {len(values)} messages served in {wall:.3f} s "
            f"= {len(values) / wall:.0f} msg/s with journal (binary), audit, "
            f"trace spans, SLO {OBSERVED_SLO_MS} ms, TSDB, host profiler, "
            f"device plane, captures, {len(OBSERVED_WATCH)} watchpoints, "
            f"/metrics, exactly-once and {len(save_s)} checkpoints; "
            f"unobserved (serve-tcp, this process) {u['wall']:.3f} s: "
            f"{wall / u['wall']:.2f}x (host clock, synchronized; "
            f"{dispatches} dispatches = kernel launches); MatchOut == B1's "
            f"({got[0]} lines, sha256 {got[1]}); card {card}")
        log(f"serve-observed: service wall by span (s, host clock): "
            f"serve_engine {eng_s:.4f}, serve_produce {prod_s:.4f}, "
            f"serve_observe (journal + audit + stamps + spans + watch) "
            f"{obs_s:.4f}, checkpoints (save + check_engine) {ckpt_s:.4f} "
            f"({', '.join(f'{x:.3f}' for x in save_s)}), the rest {rest:.4f}; "
            f"unobserved: serve_engine "
            f"{u['spans'].get('serve_engine', 0):.4f}, serve_produce "
            f"{u['spans'].get('serve_produce', 0):.4f}, the rest "
            f"{u['wall'] - sum(u['spans'].values()):.4f}; construction "
            f"{init_s:.3f} s, close {close_s:.3f} s")
        log(f"serve-observed: parts (s, host clock): _publish_batch "
            f"{parts['_publish_batch']:.4f} (of it the capture triggers and "
            f"their torch.profiler windows {parts['maybe_fire']:.4f}); the "
            f"device plane's byte probes {parts['_count_bytes']:.4f} (in "
            f"serve_engine); host profiler {json.dumps(prof_g)}")
        log(f"serve-observed: journal {os.path.getsize(jp)} bytes, "
            f"{sum(kinds.values())} events ({json.dumps(dict(kinds))}); "
            f"canonical lifecycle {canon[0]} events sha256 {canon[1]} == "
            f"both packages' on the CPU; audit batches "
            f"{aud.batches}, 0 violations; check_engine on the card's state "
            f"at offsets {[o for o, _ in checks]}: [] each time")
        log(f"serve-observed: watch {list(OBSERVED_WATCH)}: {hits[0]} hits "
            f"sha256 {hits[1]} == both packages' on the CPU; TSDB {samples} "
            f"samples ({rep['segments']} finalized segments, none "
            f"mismatched); event log {erep['events']} events verified; "
            f"{len(scrapes)} /metrics.json scrapes during the run, "
            f"/metrics {len(prom)} bytes after it; SLO "
            f"{slo_reason or 'held'}; {len(caps)} captures, the "
            f"{trig[0]['trigger']} capture's torch.profiler window "
            f"({window_s} s) {nk} kernel slices, {nseq} of "
            f"seq_scan_kernel")
        bound = plane["bytes_per_batch"] / HBM_BYTES_PER_S * 1e3
        log(f"serve-observed: device plane (cuda): {plane['kernel']} "
            f"{plane['kernel_ms_per_dispatch']:.4f} ms per dispatch (CUDA "
            f"events, {plane['dispatches_timed']} dispatches), "
            f"{plane['bytes_per_batch']} bytes per dispatch (dispatch_bytes, "
            f"mean of {plane['dispatches_probed']} probed; byte bound "
            f"{bound:.6f} ms at 3.35 TB/s), H2D "
            f"{plane['h2d_bytes_per_s'] / 1e9:.2f} GB/s, "
            f"transfer_s_per_batch {plane.get('transfer_s_per_batch')}, "
            f"h2d_overlap_frac {plane.get('h2d_overlap_frac')}; the cpu "
            f"entry untouched; session timing {json.dumps(timing)}")
        del svc
        log(f"phase 12a took {time.perf_counter() - t_phase:.1f} s")

        # ---- (b) the fill_qty drill: the auditor trips, its dump replays
        t_phase = time.perf_counter()
        cut = values[:DRILL_PREFIX]
        svc, _jp, _ld, d_b = drill_run(SQ, cut, os.path.join(root, "b"),
                                       "fill_qty", "fill_qty drill")
        found = svc.auditor.violations
        if not found or not svc.auditor.dumps:
            fail(f"fill_qty drill: {len(found)} violations, "
                 f"{len(svc.auditor.dumps)} repro dumps")
        again = replay_repro(svc.auditor.dumps[0])
        kinds_b = sorted({v["kind"] for v in found})
        if not again or not {v["kind"] for v in again} <= set(kinds_b):
            fail(f"fill_qty drill: the dump replays to {again}, the service "
                 f"found {found[:4]}")
        log(f"fill_qty drill ({len(cut)} messages, {d_b} dispatches = "
            f"launches): the auditor found {len(found)} violation(s) "
            f"{kinds_b}; replay_repro of {os.path.basename(svc.auditor.dumps[0])} "
            f"re-finds {sorted({v['kind'] for v in again})}")
        del svc
        log(f"phase 12b took {time.perf_counter() - t_phase:.1f} s")

        # ---- (c) the journal_fill_qty@K drill, pinned by xray.bisect
        t_phase = time.perf_counter()
        c = os.path.join(root, "c")
        svc, jp_c, log_c, d_c = drill_run(
            SQ, cut, c, f"journal_fill_qty@{TAMPER_BATCH}",
            "journal_fill_qty drill")
        tampered = svc._tampered_batch
        # cold replays: a seq snapshot restores each book in slot order,
        # not time priority (in both packages), so it anchors no replay
        t = time.perf_counter()
        res = xray.bisect(jp_c, log_c, topic=TOPIC_IN,
                          book_slots=SERVE["slots"],
                          max_fills=SERVE["max_fills"])
        bis_s = time.perf_counter() - t
        if (tampered != TAMPER_BATCH or not res.get("divergent")
                or res.get("batch") != TAMPER_BATCH):
            fail(f"journal_fill_qty drill: tampered batch {tampered}, bisect "
                 f"{ {k: res.get(k) for k in ('divergent', 'batch')} }; "
                 f"want {TAMPER_BATCH}")
        rr = xray.replay_bisect_repro(res["repro"])
        if not rr["match"]:
            fail(f"journal_fill_qty drill: the bisect repro does not replay "
                 f"({rr})")
        log(f"journal_fill_qty@{TAMPER_BATCH} drill ({len(cut)} messages, "
            f"{d_c} dispatches = launches): xray.bisect pins batch "
            f"{res['batch']} (offset {res['first_divergent_offset']}) in "
            f"{res['replays']} oracle replays, {bis_s:.2f} s (host); diff "
            f"{json.dumps(res['diff'])[:160]}; its repro replays; the "
            f"auditor tripped too ({len(svc.auditor.violations)} "
            f"violations)")
        del svc
        log(f"phase 12c took {time.perf_counter() - t_phase:.1f} s")

        # ---- (d) the lanes service (B4/B5) journaled and audited
        t_phase = time.perf_counter()
        dd = os.path.join(root, "d")
        b = InProcessBroker()
        provision(b)
        for v in cut:
            b.produce(TOPIC_IN, None, v)
        svc = MatchService(b, engine="lanes", width=LANES_WIDTH,
                           checkpoint_dir=os.path.join(dd, "ck"),
                           checkpoint_every=LANES_CUT,
                           journal=os.path.join(dd, "journal.bin"),
                           audit=True, **SERVE)
        ses = svc._session
        ses.capture()           # set-up: its warm-up step counts launches
        zero_launches(rowdma.LAUNCHES)
        t = time.perf_counter()
        svc.run(max_messages=len(cut), poll_timeout=0.05)
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - t
        launches = dict(rowdma.LAUNCHES)
        if any(launches[k] != ses.steps for k in ("gather_pos",
                                                  "scatter_pos")):
            fail(f"lanes observed: launches {launches} for {ses.steps} "
                 f"padded steps")
        final = svc.auditor.check_engine(ses.export_state(),
                                         ses.histograms())
        checks = svc.engine_checks
        if (final or svc.auditor.violations or not checks
                or any(v for _o, v in checks)):
            fail(f"lanes observed: check_engine {checks} then {final}, "
                 f"violations {svc.auditor.violations[:3]}")
        if log_lines(b, TOPIC_OUT) != prefix:
            fail(f"lanes observed: MatchOut of the first {len(cut)} "
                 f"messages != B1's")
        svc.close()
        log(f"lanes observed: {len(cut)} messages in {wall_d:.3f} s = "
            f"{len(cut) / wall_d:.0f} msg/s with journal and audit "
            f"({ses.steps} padded steps = B4 = B5 launches); MatchOut == "
            f"B1's; check_engine on the card's lanes state at offsets "
            f"{[o for o, _ in checks]} and at the end: [] each time, "
            f"{svc.auditor.batches} batches audited, 0 violations")
        del svc, ses, b
        log(f"phase 12d took {time.perf_counter() - t_phase:.1f} s")
        return (dispatches + d_b + d_c, launches["gather_pos"],
                launches["scatter_pos"])
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 13: the multi-leader front


def split_routes(front, lines, n):
    """The front's split of `lines` into n groups (transfers on, prefund
    FRONT_PREFUND), timed. -> (the (group, line) records in front order,
    each input line's primary group, per-group line counts, router,
    seconds)."""
    router = front.GroupRouter(n, transfers=True, prefund=FRONT_PREFUND)
    routed, prim, counts = [], [], [0] * n
    t = time.perf_counter()
    for ln in lines:
        for g, out in router.route_line(ln):
            routed.append((g, out))
            counts[g] += 1
            if not front.is_internal_line(out):
                prim.append(g)
    split_s = time.perf_counter() - t
    if len(prim) != len(lines):
        fail(f"front split at {n} groups: {len(prim)} primary routes for "
             f"{len(lines)} lines")
    return routed, prim, counts, router, split_s


def restricted(per_msg, prim, k, upto=None):
    """The single leader's MatchOut lines of the messages whose primary
    route is group k (the first `upto` messages)."""
    n = len(prim) if upto is None else upto
    return [ln for i in range(n) if prim[i] == k for ln in per_msg[i]]


def front_produce(front, routed, servers):
    """Every routed line onto its group's serve_broker over TCP through
    FrontLinks, in front order, FRONT_BATCH stamped records per round
    trip (`send_batch`). -> (seconds, the links' snapshot)."""
    links = front.FrontLinks(["%s:%d" % s.server_address[:2]
                              for s, _b in servers])
    try:
        pend = [[] for _ in servers]
        t = time.perf_counter()
        for g, ln in routed:
            pend[g].append(ln)
            if len(pend[g]) == FRONT_BATCH:
                links.send_batch(g, pend[g])
                pend[g] = []
        for g, lines in enumerate(pend):
            links.send_batch(g, lines)
        produce_s = time.perf_counter() - t
        snap = links.snapshot()
    finally:
        links.close()
    faults = sum(h["transport_faults"] for h in snap["links"])
    if faults or snap["cursors"] != [sum(1 for g, _ in routed if g == k)
                                     for k in range(len(servers))]:
        fail(f"front links: cursors {snap['cursors']}, {faults} transport "
             f"faults")
    return produce_s, snap


def send_probe(front, routed, n):
    """The reference's produce, `FrontLinks.send` (one stamped record
    per round trip), for the first FRONT_SEND_PROBE routed records into
    fresh serve_brokers. -> (records, seconds)."""
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.tcp import serve_broker

    servers = [serve_broker("127.0.0.1", 0, InProcessBroker())
               for _ in range(n)]
    links = front.FrontLinks(["%s:%d" % s.server_address[:2]
                              for s, _b in servers])
    try:
        part = routed[:FRONT_SEND_PROBE]
        t = time.perf_counter()
        for g, ln in part:
            links.send(g, ln)
        return len(part), time.perf_counter() - t
    finally:
        links.close()
        for s, _b in servers:
            s.shutdown()
            s.server_close()


def group_service(broker, k, n, root, checkpoint_every=1 << 30):
    """Group k of n on the card: `MatchService(engine="seq", pipeline=2,
    group=(k, n))`, exactly once (its lease under `root`)."""
    from kme_tpu_torch.bridge.service import MatchService

    svc = MatchService(broker, engine="seq", compat="fixed", pipeline=2,
                       group=(k, n), exactly_once=True, checkpoint_dir=root,
                       checkpoint_every=checkpoint_every, **SERVE)
    if svc.pipeline != 2 or svc.topic_in != f"MatchIn.g{k}":
        fail(f"group {k}/{n}: pipeline {svc.pipeline}, topic {svc.topic_in}")
    return svc


def run_group(SQ, svc, nmsgs, label):
    """Serve `nmsgs` with the launch counts set to 0 just before. ->
    (wall s, B1 launches)."""
    import torch

    zero_launches(SQ.LAUNCHES)
    t = time.perf_counter()
    got = svc.run(max_messages=nmsgs, poll_timeout=0.05)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if got != nmsgs:
        fail(f"{label}: served {got} of {nmsgs} messages")
    return wall, seq_launches_checked(SQ, svc, label)


def stamped(broker, topic):
    return [(r.epoch, r.out_seq, r.key, r.value)
            for r in broker.fetch(topic, 0, 1 << 30, timeout=0)]


def xfer_checked(front, broker, k, label):
    """Group k's Xfer.gK log: every record an internal transfer or
    broadcast line, no (epoch, out_seq) stamp twice."""
    recs = stamped(broker, f"Xfer.g{k}")
    stamps = {(e, s) for e, s, _k, _v in recs}
    if len(stamps) != len(recs) or any(e is None for e, _s in stamps):
        fail(f"{label}: Xfer.g{k} holds {len(recs)} records with "
             f"{len(stamps)} distinct stamps")
    if not all(front.is_internal_line(v) for _e, _s, _k, v in recs):
        fail(f"{label}: an organic record on Xfer.g{k}")
    return recs


def groups_run(SQ, front, lines, per_msg, n, root, label, want):
    """One n-group deployment of `lines` (phase 13a/13b): the front's
    split, FrontLinks into one serve_broker per group, the group services
    one after another on the card. Each MatchOut.gK must equal the
    single leader's lines (`per_msg`) of the messages routed to group k;
    the merged stream's digest, the router's counters and the substream
    counts must be `want` (the JAX package's, on the CPU). -> (B1
    launches, primary routes, per-group (MatchOut lines, Xfer records,
    transfer ledger), brokers' report)."""
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import group_topics, provision
    from kme_tpu_torch.bridge.tcp import serve_broker

    routed, prim, counts, router, split_s = split_routes(front, lines, n)
    c = router.counters
    if c["transfer_shortfall_total"]:
        fail(f"{label}: {c['transfer_shortfall_total']} transfer shortfalls")
    servers = [serve_broker("127.0.0.1", 0, InProcessBroker())
               for _ in range(n)]
    for k, (_s, broker) in enumerate(servers):
        provision(broker, topics=group_topics(k))
    launches, walls, groups = 0, [], []
    try:
        produce_s, snap = front_produce(front, routed, servers)
        for k, (_s, broker) in enumerate(servers):
            gl = f"{label} group {k}"
            svc = group_service(broker, k, n,
                                os.path.join(root, f"{label}-g{k}"))
            wall, d = run_group(SQ, svc, counts[k], gl)
            launches += d
            walls.append(wall)
            gauges = svc.telemetry.snapshot()["gauges"]
            xfer = dict(svc._xfer)
            svc.close()
            out = log_lines(broker, f"MatchOut.g{k}")
            if out != restricted(per_msg, prim, k):
                fail(f"{gl}: MatchOut.g{k} ({len(out)} lines) != the "
                     f"single leader's lines of its messages")
            xrecs = xfer_checked(front, broker, k, gl)
            groups.append((out, xrecs, xfer))
            log(f"{gl}: {counts[k]} messages in {wall:.3f} s = "
                f"{counts[k] / wall:.0f} msg/s ({d} dispatches = "
                f"launches); MatchOut.g{k} {len(out)} lines == the single "
                f"leader's for its messages; Xfer.g{k} {len(xrecs)} stamped "
                f"records, no stamp twice; ledger {xfer}; gauges "
                f"cross_shard_transfers_total "
                f"{gauges.get('cross_shard_transfers_total')} "
                f"group{k}_lag {gauges.get(f'group{k}_lag')}")
    finally:
        for s, _b in servers:
            s.shutdown()
            s.server_close()
    nprobe, probe_s = send_probe(front, routed, n)
    merged = stream_digest(front.merge_streams([g[0] for g in groups]))
    got = (merged, dict(c), counts)
    if got != want:
        fail(f"{label}: merged {merged}, counters {dict(c)}, substreams "
             f"{counts}; the JAX package gives {want}")
    log(f"{label}: {len(lines)} messages split in {split_s:.3f} s and "
        f"produced over TCP by FrontLinks (send_batch) in {produce_s:.3f} s "
        f"({len(routed)} records = {len(routed) / produce_s:.0f}/s; one "
        f"record per round trip, `send`: {nprobe} in {probe_s:.3f} s = "
        f"{nprobe / probe_s:.0f}/s); "
        f"substreams {counts}; cross_shard_transfers_total "
        f"{c['cross_shard_transfers_total']}, transfer_shortfall_total "
        f"{c['transfer_shortfall_total']}, balance_broadcasts_total "
        f"{c['balance_broadcasts_total']}; group walls "
        f"{[round(w, 3) for w in walls]} s, deployment wall (the slowest "
        f"group) {max(walls):.3f} s, sum {sum(walls):.3f} s; merged "
        f"MatchOut {merged[0]} lines sha256 {merged[1]} (host clock)")
    return launches, prim, groups


def cross_phase(SQ, front, lines, root):
    """Phase 13b: the cross-account stream through one single-leader card
    service and through two groups; group 0 exactly once with
    checkpoints every CROSS_CKPT_EVERY, killed after its first and
    resumed from disk. -> B1 launches."""
    import shutil

    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import group_topics, provision
    from kme_tpu_torch.bridge.tcp import serve_broker
    from kme_tpu_torch.runtime import checkpoint as ck

    single, launches = single_leader(SQ, lines, "cross single leader")
    if stream_digest(single) != GROUPS_CROSS[0]:
        fail(f"cross single leader: MatchOut {stream_digest(single)}; the "
             f"JAX package gives {GROUPS_CROSS[0]}")
    per_msg = per_message(single)
    routed, prim, counts, router, _ = split_routes(front, lines, 2)
    log0, copy0 = os.path.join(root, "x-log0"), os.path.join(root, "x-copy0")
    servers = [serve_broker("127.0.0.1", 0,
                            InProcessBroker(persist_dir=log0)),
               serve_broker("127.0.0.1", 0, InProcessBroker())]
    for k, (_s, broker) in enumerate(servers):
        provision(broker, topics=group_topics(k))
    runs = {}
    try:
        front_produce(front, routed, servers)
        servers[0][1].sync()
        shutil.copytree(log0, copy0)
        for k, (_s, broker) in enumerate(servers):
            svc = group_service(broker, k, 2, os.path.join(root, f"x-g{k}"),
                                CROSS_CKPT_EVERY)
            wall, d = run_group(SQ, svc, counts[k], f"cross group {k}")
            launches += d
            runs[k] = (stamped(broker, f"MatchOut.g{k}"),
                       xfer_checked(front, broker, k, f"cross group {k}"),
                       dict(svc._xfer), wall)
            svc.close()
            want = restricted(per_msg, prim, k)
            if [f"{r[2]} {r[3]}" for r in runs[k][0]] != want:
                fail(f"cross group {k}: MatchOut.g{k} != the single "
                     f"leader's lines of its messages")
    finally:
        for s, _b in servers:
            s.shutdown()
            s.server_close()
    merged = stream_digest(front.merge_streams(
        [[f"{r[2]} {r[3]}" for r in runs[k][0]] for k in range(2)]))
    got = (stream_digest(single), merged, dict(router.counters), counts)
    if got != GROUPS_CROSS:
        fail(f"cross groups: {got}; the JAX package gives {GROUPS_CROSS}")
    log(f"cross groups: substreams {counts}, "
        f"cross_shard_transfers_total "
        f"{router.counters['cross_shard_transfers_total']}, shortfalls "
        f"{router.counters['transfer_shortfall_total']}; group walls "
        f"{[round(runs[k][3], 3) for k in range(2)]} s; merged MatchOut "
        f"{merged[0]} lines sha256 {merged[1]} == the JAX package's")
    # group 0 again from the copied log: killed after its first snapshot
    ck_dir = os.path.join(root, "x-crash")
    b1 = InProcessBroker(persist_dir=copy0)
    topics = group_topics(0)
    svc1 = group_service(b1, 0, 2, ck_dir, CROSS_CKPT_EVERY)
    zero_launches(SQ.LAUNCHES)
    svc1.run(max_messages=CROSS_CRASH_AT, poll_timeout=0.05)
    launches += seq_launches_checked(SQ, svc1, "cross crash, first")
    snap = svc1._last_ckpt_offset
    if not 0 < snap <= CROSS_CKPT_EVERY + SERVE["batch"] * 2:
        fail(f"cross crash: first snapshot at {snap}")
    pending = ck.snapshot_extra(ck_dir, snap).get("pending_reserve")
    del svc1, b1                      # the whole process dies
    b2 = InProcessBroker(persist_dir=copy0)
    svc2 = group_service(b2, 0, 2, ck_dir, CROSS_CKPT_EVERY)
    restored = dict(svc2._xfer)
    if svc2.offset != snap or not pending or restored != pending \
            or pending["legs"] == 0:
        fail(f"cross crash: resumed at {svc2.offset} (snapshot {snap}), "
             f"ledger {restored}, snapshot's pending_reserve {pending}")
    _wall, d = run_group(SQ, svc2, counts[0] - snap, "cross crash, resumed")
    launches += d
    final = dict(svc2._xfer)
    svc2.close()
    out0 = [r[1:] for r in stamped(b2, topics[1])]
    x0 = [r[1:] for r in stamped(b2, topics[2])]
    if out0 != [r[1:] for r in runs[0][0]] or \
            x0 != [r[1:] for r in runs[0][1]] or final != runs[0][2]:
        fail("cross crash: the resumed group 0's MatchOut.g0 / Xfer.g0 / "
             "ledger differ from the uninterrupted run's")
    log(f"cross crash: group 0 killed at {CROSS_CRASH_AT} messages after "
        f"its snapshot at {snap}; resumed with pending_reserve {pending} "
        f"from the snapshot; MatchOut.g0 ({len(out0)}) and Xfer.g0 "
        f"({len(x0)}) stamps and values == the uninterrupted run's, "
        f"{b2.dup_suppressed} replayed records suppressed")
    return launches


def cli_phase(front, lines, per_msg, prim, root):
    """Phase 13c: `kme-torch-front route` feeds two `kme-torch-serve
    --group k/2` processes; `kme-torch-consume --topic MatchOut.gK` reads
    each group; then `kme-torch-trace --cluster` and `kme-torch-xray
    --cluster` on the run directory. -> each group's MatchOut lines."""
    import threading

    from kme_tpu_torch.bridge.tcp import TcpBroker

    t_phase = time.perf_counter()
    os.makedirs(root)
    with open(os.path.join(root, "front.in"), "w") as f:
        f.write("".join(ln + "\n" for ln in lines))
    want = [restricted(per_msg, prim, k, len(lines)) for k in range(2)]
    cli = [sys.executable, "-m", "kme_tpu_torch.cli"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    serves, addrs, errs = [], [], [[], []]
    try:
        for k in range(2):
            gdir = os.path.join(root, f"group{k}", "state")
            serves.append(subprocess.Popen(
                cli + ["serve", "--listen", "127.0.0.1:0", "--engine",
                       "seq", "--pipeline", "2", "--group", f"{k}/2",
                       "--auto-provision", "--idle-exit", "8",
                       "--checkpoint-dir", gdir, "--journal-out",
                       os.path.join(gdir, "journal.bin"), "--trace-spans"],
                cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True))
        for k, p in enumerate(serves):
            while len(addrs) <= k:
                line = p.stderr.readline()
                if not line:
                    fail(f"group {k} serve exited before listening: "
                         f"{errs[k]}")
                errs[k].append(line.rstrip())
                if "broker listening on" in line:
                    addrs.append(line.rsplit(" ", 1)[1].strip())
            threading.Thread(target=lambda p=p, e=errs[k]: e.extend(
                ln.rstrip() for ln in p.stderr), daemon=True).start()
        t = time.perf_counter()
        r = subprocess.run(cli + ["front", "route", "--groups", "2",
                                  "--brokers", ",".join(addrs), "--input",
                                  os.path.join(root, "front.in"),
                                  "--prefund", str(FRONT_PREFUND)],
                           cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=600)
        route_s = time.perf_counter() - t
        if r.returncode != 0:
            fail(f"kme-torch-front route rc={r.returncode}: {r.stderr}")
        front_doc = json.loads(r.stderr.strip().splitlines()[-1])
        got = []
        for k, addr in enumerate(addrs):
            h, port = addr.rsplit(":", 1)
            client = TcpBroker(h, int(port))
            deadline = time.monotonic() + 300
            while client.end_offset(f"MatchOut.g{k}") < len(want[k]):
                if time.monotonic() > deadline or serves[k].poll() is not None:
                    fail(f"group {k} serve: MatchOut.g{k} stalled at "
                         f"{client.end_offset(f'MatchOut.g{k}')} of "
                         f"{len(want[k])} lines: {errs[k][-5:]}")
                time.sleep(0.1)
            client.close()
            c = subprocess.run(cli + ["consume", "--broker", addr,
                                      "--topic", f"MatchOut.g{k}",
                                      "--no-follow"], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=300)
            if c.returncode != 0:
                fail(f"kme-torch-consume group {k} rc={c.returncode}: "
                     f"{c.stderr}")
            got.append(c.stdout.splitlines())
        for k, p in enumerate(serves):
            rc = p.wait(timeout=300)
            if rc != 0:
                fail(f"group {k} serve rc={rc}: {errs[k][-5:]}")
    finally:
        for p in serves:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t_phase
    for k in range(2):
        if got[k] != want[k]:
            fail(f"CLI group {k}: kme-torch-consume read {len(got[k])} "
                 f"lines; the single leader gives {len(want[k])} for its "
                 f"messages")
    merged = stream_digest(front.merge_streams(got))
    log(f"groups-cli: kme-torch-front route sent {len(lines)} messages "
        f"({front_doc['cursors']} records, cross_shard_transfers_total "
        f"{front_doc['cross_shard_transfers_total']}) in {route_s:.3f} s; "
        f"kme-torch-consume read MatchOut.g0/g1 ({len(got[0])} + "
        f"{len(got[1])} lines): merged {merged[0]} lines sha256 "
        f"{merged[1]} == the single leader's stream restricted to the cut; "
        f"serves said {[[e for e in es if 'processed' in e] for es in errs]}"
        f"; wall with the idle exits {wall:.1f} s (host clock)")
    t = time.perf_counter()
    tr = subprocess.run(cli + ["trace", "--cluster", "--state-root", root,
                               "--prefund", str(FRONT_PREFUND)], cwd=ROOT,
                        env=env, capture_output=True, text=True,
                        timeout=600)
    tail = tr.stderr.strip().splitlines()[-1] if tr.stderr.strip() else ""
    if tr.returncode != 0 or f"{len(lines)} orders admitted" not in tail \
            or f"{len(lines)} stitched" not in tail:
        fail(f"kme-torch-trace --cluster rc={tr.returncode}: {tail}")
    trace_s = time.perf_counter() - t
    t = time.perf_counter()
    xr = subprocess.run(cli + ["xray", "--cluster", "--state-root", root,
                               "--prefund", str(FRONT_PREFUND),
                               "--book-slots", str(SERVE["slots"]),
                               "--max-fills", str(SERVE["max_fills"]),
                               "--json"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=600)
    if xr.returncode != 0:
        fail(f"kme-torch-xray --cluster rc={xr.returncode}: "
             f"{xr.stderr[-2000:]}")
    cut = json.loads(xr.stdout)
    if not cut["conserved"] or cut["watermark"] != len(lines):
        fail(f"kme-torch-xray --cluster: not conserved at "
             f"{cut['watermark']}: delta {cut['delta']}")
    log(f"groups-cli: kme-torch-trace --cluster: {tail.split(': ', 1)[-1]} "
        f"({trace_s:.1f} s); kme-torch-xray --cluster: cash conserved at "
        f"the cut {cut['watermark']}: cluster {cut['cluster']} == single "
        f"leader {cut['single_leader']}, pending reserve "
        f"{cut['pending_reserve_total']} ({time.perf_counter() - t:.1f} s)")
    return got


def feed_phase(SQ, front, root, per_lines):
    """Phase 13d: one FeedServer per group of 13c over its MatchOut.gK,
    subscribers on one symbol each (round-robin over the symbols, on
    their symbol's group) and FEED_AUDITORS wildcard auditors per group.
    `per_lines` = each group's substream line count."""
    import resource
    import selectors
    import socket
    from types import SimpleNamespace

    from kme_tpu_torch import opcodes as op
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.feed.client import subscribe_line
    from kme_tpu_torch.feed.derive import (BookBuilder, books_from_oracle,
                                           canonical_books)
    from kme_tpu_torch.feed.server import FeedServer
    from kme_tpu_torch.runtime import checkpoint as ck
    from kme_tpu_torch.telemetry import Registry

    t_phase = time.perf_counter()
    ngroups, nsym = 2, SERVE["symbols"]
    cfg = SQ.SeqConfig(lanes=SERVE["symbols"], slots=SERVE["slots"],
                       accounts=SERVE["accounts"],
                       max_fills=SERVE["max_fills"])
    recs, levels = [], []
    for k in range(ngroups):
        gdir = os.path.join(root, f"group{k}", "state")
        b = InProcessBroker(persist_dir=os.path.join(gdir, "broker-log"))
        recs.append(b.fetch(f"MatchOut.g{k}", 0, 1 << 30, timeout=0))
        ses, off = ck.load_seq_session(gdir, cfg)
        if ses is None or off != per_lines[k]:
            fail(f"feed: group {k}'s last snapshot is at {off}, its "
                 f"substream has {per_lines[k]} messages")
        orders = ses.export_state()["orders"]
        levels.append(books_from_oracle(SimpleNamespace(orders={
            oid: SimpleNamespace(action=op.BUY if o["is_buy"] else op.SELL,
                                 sid=o["sid"], price=o["price"],
                                 size=o["size"])
            for oid, o in orders.items()})))
        del ses
    subs = FEED_SUBSCRIBERS
    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want_fd = 2 * subs + 512
        if soft < want_fd:
            soft = want_fd if hard == resource.RLIM_INFINITY \
                else min(want_fd, hard)
            resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))
        cap = max(16, (soft - 256) // 2)
        if subs > cap:
            log(f"feed: RLIMIT_NOFILE {soft} caps the subscribers at {cap} "
                f"(asked {subs})")
            subs = cap
    except (ValueError, OSError) as e:
        log(f"feed: RLIMIT_NOFILE not raised ({e})")
    servers, hashes = [], []
    for k in range(ngroups):
        broker = InProcessBroker()
        broker.create_topic(f"MatchOut.g{k}")
        srv = FeedServer(broker, port=0, group=k, topic=f"MatchOut.g{k}",
                         queue_bytes=FEED_QUEUE_BYTES, registry=Registry(),
                         **FEED_DERIVE)
        h = hashlib.sha256()
        hashes.append(h)

        def fan_out(f, orig=srv._fan_out, h=h):
            h.update(f.raw)
            orig(f)

        srv._fan_out = fan_out
        servers.append((broker, srv))
    plan = [(k, None) for k in range(ngroups) for _ in range(FEED_AUDITORS)]
    plan += [(front.symbol_group(i % nsym, ngroups), {i % nsym})
             for i in range(max(0, subs - len(plan)))]
    csel = selectors.DefaultSelector()
    clients = []

    class Client:
        __slots__ = ("k", "sock", "symbols", "out", "buf", "live", "eof")

        def __init__(self, k, symbols) -> None:
            self.k, self.symbols = k, symbols
            self.out = subscribe_line(symbols)
            self.buf, self.live, self.eof = [], False, False
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setblocking(False)
            self.sock.connect_ex(servers[k][1].address)

    def pump_clients(timeout):
        moved = 0
        for key, mask in csel.select(timeout=timeout):
            c = key.data
            if not c.live:
                if mask & selectors.EVENT_WRITE:
                    try:
                        n = c.sock.send(c.out)
                    except (BlockingIOError, InterruptedError):
                        continue
                    c.out = c.out[n:]
                    if not c.out:
                        c.live = True
                        csel.modify(c.sock, selectors.EVENT_READ, c)
                continue
            try:
                data = c.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                data = b""
            if not data:
                c.eof = True
                csel.unregister(c.sock)
                continue
            c.buf.append(data)
            moved += len(data)
        return moved

    def step_all(timeout):
        return sum(srv.step(timeout) for _b, srv in servers)

    try:
        t = time.perf_counter()
        for lo in range(0, len(plan), 512):
            for k, syms in plan[lo:lo + 512]:
                c = Client(k, syms)
                clients.append(c)
                csel.register(c.sock, selectors.EVENT_WRITE, c)
            for _ in range(200):
                step_all(0.001)
                pump_clients(0.0)
                if all(c.live for c in clients):
                    break
        deadline = time.monotonic() + 120
        while sum(len(srv._subs) for _b, srv in servers) < len(clients):
            if time.monotonic() > deadline:
                fail(f"feed: only {sum(len(s._subs) for _b, s in servers)}"
                     f" of {len(clients)} subscribers connected")
            step_all(0.001)
            pump_clients(0.0)
        connect_s = time.perf_counter() - t
        t = time.perf_counter()
        for k, (broker, _srv) in enumerate(servers):
            now = time.time_ns() // 1000
            for r in recs[k]:
                broker.produce(f"MatchOut.g{k}", r.key, r.value,
                               epoch=r.epoch, out_seq=r.out_seq, ats=now)
        deadline = time.monotonic() + 600
        while True:
            n = step_all(0.0)
            pump_clients(0.0)
            if n == 0 and all(srv.offset >= len(recs[k]) and not any(
                    s.queue or s.conflating for s in srv._subs.values())
                    for k, (_b, srv) in enumerate(servers)):
                break
            if time.monotonic() > deadline:
                fail("feed: the fan-out stalled")
        fanout_s = time.perf_counter() - t
        stats = [srv.stats() for _b, srv in servers]
        lags = [srv.lag.quantiles() for _b, srv in servers]
        frames = [(srv.deriver.frames_out, hashes[k].hexdigest())
                  for k, (_b, srv) in enumerate(servers)]
    finally:
        for _b, srv in servers:
            srv.close()
    deadline = time.monotonic() + 120
    while any(not c.eof for c in clients) and time.monotonic() < deadline:
        if pump_clients(0.05) == 0 and all(not c.live or c.eof
                                           for c in clients):
            break
    csel.close()
    for c in clients:
        c.sock.close()
    if tuple(frames) != FEED_FRAMES:
        fail(f"feed: the groups' derivers gave {frames}; the JAX package's "
             f"FeedDeriver gives {FEED_FRAMES} over the same MatchOut.gK")
    received = conflated = 0
    for i, c in enumerate(clients):
        blob = b"".join(c.buf)
        bb = BookBuilder()
        if bb.apply_buffer(blob) != len(blob) or bb.errors or bb.gaps \
                or bb.dups:
            fail(f"feed subscriber {i} (group {c.k}, {c.symbols}): "
                 f"errors {bb.errors[:2]}, gaps {bb.gaps[:2]}, dups "
                 f"{bb.dups}")
        want = levels[c.k] if c.symbols is None else {
            key: lv for key, lv in levels[c.k].items()
            if key[0] in c.symbols}
        if canonical_books(bb.book) != canonical_books(want):
            fail(f"feed subscriber {i} (group {c.k}, {c.symbols}): books "
                 f"differ from the card session's resting orders")
        received += bb.frames
        conflated += bool(bb.resyncs)
    delivered = sum(s["delivered"] for s in stats)
    wall = time.perf_counter() - t_phase
    log(f"feed-groups: {len(clients)} subscribers ({FEED_AUDITORS} "
        f"wildcard auditors per group) on {nsym} symbols over "
        f"{ngroups} groups, connected in {connect_s:.2f} s; frames derived "
        f"{[s['frames'] for s in stats]} (sha256 == the JAX package's "
        f"FeedDeriver), delivered {delivered} in {fanout_s:.3f} s = "
        f"{delivered / fanout_s:.0f} frames/s, received {received}; "
        f"conflations {[s['conflations'] for s in stats]}, resyncs "
        f"{[s['resyncs'] for s in stats]} ({conflated} subscribers "
        f"resynced); feed_lag p50 "
        f"{[round(q[0.5] * 1e3, 3) for q in lags]} ms p99 "
        f"{[round(q[0.99] * 1e3, 3) for q in lags]} ms; every book == the "
        f"card sessions' resting orders, 0 gaps, 0 dups; phase wall "
        f"{wall:.1f} s (host clock)")
    if wall > FEED_PHASE_LIMIT_S:
        log(f"feed-groups: {wall:.1f} s is past the phase's "
            f"{FEED_PHASE_LIMIT_S:.0f} s budget")


def single_leader(SQ, lines, label):
    """The single-leader card service (`MatchService(engine="seq",
    pipeline=2)`) over `lines`. -> (MatchOut lines, B1 launches)."""
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT, MatchService

    b = InProcessBroker()
    provision(b)
    for v in lines:
        b.produce(TOPIC_IN, None, v)
    svc = MatchService(b, engine="seq", compat="fixed", pipeline=2, **SERVE)
    wall, launches = run_group(SQ, svc, len(lines), label)
    svc.close()
    out = log_lines(b, TOPIC_OUT)
    log(f"{label}: {len(lines)} messages in {wall:.3f} s = "
        f"{len(lines) / wall:.0f} msg/s ({launches} dispatches = "
        f"launches), MatchOut {len(out)} lines (host clock)")
    return out, launches


def front_phase(SQ, gmsgs):
    """Phase 13: the multi-leader front (see the module docstring) over
    `gmsgs`, the payout-free zipf stream. -> B1 launches."""
    import shutil
    import tempfile

    from kme_tpu_torch.bridge import front
    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import cross_account_stream

    lines = [dumps_order(m) for m in gmsgs]
    root = tempfile.mkdtemp(prefix="kme_front_")
    try:
        t = time.perf_counter()
        single, launches = single_leader(SQ, lines, "groups single leader")
        if stream_digest(single) != GROUPS_SINGLE:
            fail(f"groups single leader: MatchOut {stream_digest(single)}; "
                 f"the JAX package gives {GROUPS_SINGLE}")
        per_msg = per_message(single)
        del single
        prim2 = None
        for n in (2, 4):
            d, prim, groups = groups_run(SQ, front, lines, per_msg, n, root,
                                         f"groups{n}", GROUPS_ZIPF[n])
            launches += d
            if n == 2:
                prim2 = prim
            del groups
            log(f"phase 13a to groups{n} took "
                f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        cross = [dumps_order(m) for m in cross_account_stream(
            **CROSS_STREAM)]
        launches += cross_phase(SQ, front, cross, root)
        log(f"phase 13b took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        prefix = lines[:GROUPS_CLI_PREFIX]
        cli_root = os.path.join(root, "cli")
        cli_phase(front, prefix, per_msg, prim2, cli_root)
        log(f"phase 13c took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        per_lines = split_routes(front, prefix, 2)[2]
        feed_phase(SQ, front, cli_root, per_lines)
        log(f"phase 13d took {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches

# ---------------------------------------------------------------------------
# phase 14: the failover drills


def durable_rows(ck_dir):
    """The rows of a checkpoint root's durable MatchOut log."""
    with open(os.path.join(ck_dir, "broker-log", "MatchOut.log"), "rb") as f:
        return [json.loads(ln) for ln in f]


def rows_checked(rows, b1, label):
    """No (epoch, out_seq) stamp twice in the durable MatchOut rows, and
    their lines, deduped by DedupRing, equal to B1's. -> rows per epoch."""
    from kme_tpu_torch.bridge.consume import DedupRing

    if any(len(r) != 4 or r[2] is None for r in rows):
        fail(f"{label}: an unstamped row in the exactly-once MatchOut log")
    stamps = {(r[2], r[3]) for r in rows}
    if len(stamps) != len(rows):
        fail(f"{label}: {len(rows) - len(stamps)} stamps appear twice in "
             f"the durable MatchOut log")
    ring = DedupRing(capacity=len(rows) + 1)
    got = stream_digest([f"{r[0]} {r[1]}" for r in rows
                         if not ring.is_dup(r[2], r[3])])
    if got != b1:
        fail(f"{label}: deduped MatchOut {got[0]} lines sha256 {got[1]}; B1 "
             f"gives {b1[0]} lines sha256 {b1[1]}")
    return dict(collections.Counter(r[2] for r in rows))


def stale_epoch_fenced(ck_dir, label):
    """A produce stamped with epoch 1 against the reloaded durable logs
    must be fenced."""
    from kme_tpu_torch.bridge.broker import BrokerFenced, InProcessBroker
    from kme_tpu_torch.bridge.service import TOPIC_OUT

    b = InProcessBroker(persist_dir=os.path.join(ck_dir, "broker-log"))
    try:
        b.produce(TOPIC_OUT, "OUT", "stale", epoch=1, out_seq=1 << 40)
    except BrokerFenced:
        return
    fail(f"{label}: a produce stamped with epoch 1 was not fenced")


def follow_and_promote(SQ, values, root, b1, kw, cut, device, label):
    """Phase 14a: `values` into a persisted broker log; a pipelined
    exactly-once leader runs to the kill point, writes its leader
    heartbeat and is dropped without teardown; a `Replica` restores its
    snapshot, follows to one batch short of the kill point and holds
    there, then a pid-less promote.json promotes it and it serves the
    rest. -> B1 launches (leader, follower, promoted)."""
    import threading

    import torch
    from kme_tpu_torch.bridge import lease
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.replica import Replica
    from kme_tpu_torch.bridge.service import TOPIC_IN, MatchService

    ckpt_every, kill_at, _ = cut
    ck_dir = os.path.join(root, "a")
    b = InProcessBroker(persist_dir=os.path.join(ck_dir, "broker-log"))
    provision(b)
    for v in values:
        b.produce(TOPIC_IN, None, v)
    leader = MatchService(b, engine="seq", compat="fixed", pipeline=2,
                          checkpoint_dir=ck_dir, exactly_once=True,
                          checkpoint_every=ckpt_every, device=device, **kw)
    zero_launches(SQ.LAUNCHES)
    t = time.perf_counter()
    leader.run(max_messages=kill_at, poll_timeout=0.05)
    lead_wall = time.perf_counter() - t
    d_lead = seq_launches_checked(SQ, leader, f"{label} leader")
    if (leader.offset, leader._last_ckpt_offset) != (kill_at, ckpt_every):
        fail(f"{label}: the leader stopped at {leader.offset} with its "
             f"snapshot at {leader._last_ckpt_offset}; want {kill_at}, "
             f"{ckpt_every}")
    leader._write_heartbeat(os.path.join(ck_dir, "serve.health"),
                            leader.offset)
    del leader, b                   # the leader dies: no teardown

    hold = kill_at - kw["batch"]
    t = time.perf_counter()
    rep = Replica(ck_dir, listen="127.0.0.1:0", engine="seq",
                  compat="fixed", checkpoint_every=ckpt_every, poll=0.05,
                  health_every=0.5, max_messages=len(values) - hold,
                  health_file=os.path.join(ck_dir, "standby.health"),
                  device=device, **kw)
    build_s = time.perf_counter() - t
    if rep.svc.offset != ckpt_every:
        fail(f"{label}: the standby restored offset {rep.svc.offset}, the "
             f"snapshot is at {ckpt_every}")
    ses = rep.svc._session
    rc = [None]
    th = threading.Thread(target=lambda: rc.__setitem__(0, rep.run()),
                          daemon=True)
    zero_launches(SQ.LAUNCHES)
    t = time.perf_counter()
    th.start()
    deadline = time.monotonic() + 300
    while rep.svc.offset < hold:
        if not th.is_alive() or time.monotonic() > deadline:
            fail(f"{label}: the follower stopped at {rep.svc.offset} of "
                 f"{hold}")
        time.sleep(0.005)
    catch_up = time.perf_counter() - t
    time.sleep(0.5)
    if rep.svc.offset != hold or rep.follow.discarded == 0:
        fail(f"{label}: the follower went on to {rep.svc.offset} (hold at "
             f"{hold}), {rep.follow.discarded} outputs discarded")
    torch.cuda.synchronize()
    d_follow = ses.dispatches
    if SQ.LAUNCHES["fixed"] != d_follow or d_follow == 0:
        fail(f"{label} follower: {SQ.LAUNCHES['fixed']} kernel launches for "
             f"{d_follow} dispatches")
    zero_launches(SQ.LAUNCHES)
    with open(rep.promote_file, "w") as f:
        json.dump({"failed_at": time.time()}, f)
    t = time.perf_counter()
    th.join(timeout=600)
    prom_wall = time.perf_counter() - t
    if th.is_alive() or rc[0] != 0:
        fail(f"{label}: the promoted standby returned {rc[0]}")
    torch.cuda.synchronize()
    d_prom = ses.dispatches - d_follow
    if SQ.LAUNCHES["fixed"] != d_prom or d_prom == 0:
        fail(f"{label} promoted: {SQ.LAUNCHES['fixed']} kernel launches for "
             f"{d_prom} dispatches")
    gauges = rep.svc.telemetry.snapshot()["gauges"]
    epoch = lease.current_epoch(ck_dir)
    if epoch != 2 or gauges.get("leader_epoch") != 2 \
            or gauges.get("dup_suppressed_total", 0) <= 0 \
            or gauges.get("failover_seconds") is None:
        fail(f"{label}: epoch {epoch}, gauges leader_epoch "
             f"{gauges.get('leader_epoch')} dup_suppressed_total "
             f"{gauges.get('dup_suppressed_total')} failover_seconds "
             f"{gauges.get('failover_seconds')}")
    per_epoch = rows_checked(durable_rows(ck_dir), b1, label)
    log(f"{label}: leader {kill_at} messages in {lead_wall:.3f} s ({d_lead} "
        f"dispatches = launches); standby built and restored offset "
        f"{ckpt_every} in {build_s:.3f} s; follower caught up to {hold} "
        f"(kill point - one batch) in {catch_up:.3f} s ({d_follow} "
        f"dispatches = launches) and held; promotion (promote.json to "
        f"serving, the failover_seconds gauge) {gauges['failover_seconds']} "
        f"s; promoted run {len(values) - hold} messages in {prom_wall:.3f} s "
        f"({d_prom} dispatches = launches); {gauges['dup_suppressed_total']} "
        f"replayed records suppressed; epoch 2; MatchOut rows per epoch "
        f"{per_epoch}, deduped == B1's, no stamp twice (host clock)")
    return d_lead + d_follow + d_prom


def free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


class FirstSeen:
    """Records the wall time each of `paths` first exists (polled every
    10 ms on a thread of its own)."""

    def __init__(self, paths):
        import threading

        self.at = {}
        self._stop = threading.Event()
        self._paths = list(paths)
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def _run(self):
        while not self._stop.wait(0.01):
            for p in self._paths:
                if p not in self.at and os.path.exists(p):
                    self.at[p] = time.time()

    def wait(self, path, timeout, proc, label):
        deadline = time.monotonic() + timeout
        while path not in self.at:
            if proc.poll() is not None or time.monotonic() > deadline:
                fail(f"{label}: no {os.path.basename(path)} (supervisor rc "
                     f"{proc.poll()})")
            time.sleep(0.01)

    def stop(self):
        self._stop.set()
        self._th.join()


def produce_resuming(addr, values, stop, proc, label):
    """Produce `values` up to `stop` to MatchIn at `addr` in batches of
    4096, each (re)connection resuming from the broker's end offset: the
    log then holds each message once whichever leader owns the endpoint.
    -> reconnections."""
    from kme_tpu_torch.bridge.broker import BrokerError
    from kme_tpu_torch.bridge.service import TOPIC_IN
    from kme_tpu_torch.bridge.tcp import TcpBroker

    host, port = addr
    client, pos, reconnects = None, None, -1
    deadline = time.monotonic() + 300
    while pos is None or pos < stop:
        if proc.poll() is not None or time.monotonic() > deadline:
            fail(f"{label}: producing stopped at {pos} of {stop} "
                 f"(supervisor rc {proc.poll()})")
        try:
            if client is None:
                client = TcpBroker(host, port)
                pos = client.end_offset(TOPIC_IN)
                reconnects += 1
            n = min(4096, stop - pos)
            if n > 0:
                client.produce_batch(TOPIC_IN, [(None, v) for v in
                                                values[pos:pos + n]])
            pos += n
        except (OSError, BrokerError):
            # the leader died under the connection, or no leader owns
            # the endpoint yet
            if client is not None:
                with contextlib.suppress(OSError):
                    client.close()
            client = None
            time.sleep(0.05)
    client.close()
    return reconnects


def gpu_apps():
    """`nvidia-smi --query-compute-apps=pid,used_memory`: (the processes
    holding a context on the card, its raw output)."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi --query-compute-apps failed: {r.stderr.strip()}")
    out = r.stdout.strip()
    return len(out.splitlines()) - 1, out


def card_nodes(pid):
    """The card's device nodes (/dev/nvidiaN) that process `pid` holds
    open: a process with a CUDA context on the card holds its node."""
    import re

    nodes = set()
    with contextlib.suppress(OSError):
        for fd in os.listdir(f"/proc/{pid}/fd"):
            with contextlib.suppress(OSError):
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
                if re.fullmatch(r"/dev/nvidia\d+", target):
                    nodes.add(target)
    return sorted(nodes)


def supervised_drill(values, root, b1, cut, standby, serve_extra, label):
    """Phase 14b (`standby`) or 14c: `kme-torch-supervise` over
    `kme-torch-serve` children at the serve defaults, the leader killed at
    the kill point by the `serve.kill` fault (once across incarnations);
    the stream produced over TCP in two parts, the second after the
    standby's first heartbeat, resuming across the kill. -> facts for the
    log."""
    import signal

    ckpt_every, kill_at, part1 = cut
    ck = os.path.join(root, label)
    os.makedirs(ck)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT,
               KME_FAULTS=f"serve.kill:at={kill_at}",
               KME_FAULTS_STATE=os.path.join(root, label + ".faults"))
    cmd = ([sys.executable, "-m", "kme_tpu_torch.cli", "supervise",
            "--checkpoint-dir", ck] + (["--standby"] if standby else [])
           + ["--poll", str(SUPERVISE_POLL), "--grace", str(SUPERVISE_GRACE),
              "--", "--listen", f"127.0.0.1:{port}", "--engine", "seq",
              "--pipeline", "2", "--checkpoint-every", str(ckpt_every),
              "--auto-provision", "--idle-exit", str(FAILOVER_IDLE_EXIT),
              "--health-every", "0.1"] + list(serve_extra))
    hb, sb = os.path.join(ck, "serve.health"), os.path.join(ck,
                                                            "standby.health")
    errpath = os.path.join(root, label + ".stderr")
    apps0 = gpu_apps()[0] if standby else None
    seen = FirstSeen([hb, sb])
    t0 = time.perf_counter()
    with open(errpath, "w") as errf:
        sup = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=errf,
                               stderr=subprocess.STDOUT,
                               start_new_session=True)
    facts = {}
    try:
        seen.wait(hb, 120, sup, label)
        reconnects = produce_resuming(("127.0.0.1", port), values, part1,
                                      sup, label)
        if standby:
            seen.wait(sb, 120, sup, label)
            with open(hb) as f:
                lead_pid = json.load(f)["pid"]
            with open(sb) as f:
                sb_pid = json.load(f)["pid"]
            # nvidia-smi names the processes by pids of another pid
            # namespace here, so a child is known by the card's device
            # node it holds open, and the context count must have grown
            # by the two children
            napps, apps = gpu_apps()
            nodes = {pid: card_nodes(pid) for pid in (lead_pid, sb_pid)}
            if napps < apps0 + 2 or not all(nodes.values()):
                fail(f"{label}: the leader ({lead_pid}) and the standby "
                     f"({sb_pid}) are not both on the card: device nodes "
                     f"{nodes}, {napps} compute apps (before the "
                     f"supervisor: {apps0}): {apps!r}")
            facts["gpu_apps"] = (f"{apps0} -> {napps}; leader {lead_pid} "
                                 f"holds {nodes[lead_pid]}, standby "
                                 f"{sb_pid} holds {nodes[sb_pid]}")
        reconnects += produce_resuming(("127.0.0.1", port), values,
                                       len(values), sup, label)
        rc = sup.wait(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        seen.stop()
        if sup.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(sup.pid, signal.SIGKILL)
            sup.wait()
    with open(errpath) as f:
        err = f.read().splitlines()
    if rc != 0:
        fail(f"{label}: the supervisor exited {rc}: {err[-12:]}")
    with open(os.path.join(ck, "supervisor.json")) as f:
        state = json.load(f)
    recs = state["recoveries"]
    if len(recs) != 1 or recs[0]["fingerprint"] != "exit:-9" \
            or bool(recs[0].get("promoted")) != standby \
            or (standby and recs[0].get("failover_seconds") is None):
        fail(f"{label}: supervisor.json recoveries {recs}")
    per_epoch = rows_checked(durable_rows(ck), b1, label)
    stale_epoch_fenced(ck, label)
    with open(os.path.join(ck, "events-supervisor.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    spawn = {e["kind"]: e["ts"] / 1e6 for e in reversed(events)}
    facts.update({
        "wall_s": round(wall, 3),
        "first_heartbeat_s": round(seen.at[hb] - spawn["supervisor.spawn"],
                                   3),
        "recovery": recs[0], "rows_per_epoch": per_epoch,
        "reconnects": reconnects, "kinds": [e["kind"] for e in events]})
    if standby:
        facts["standby_first_heartbeat_s"] = round(
            seen.at[sb] - spawn["supervisor.standby_spawn"], 3)
    log(f"{label}: " + json.dumps(facts))
    log(f"{label}: deduped MatchOut == B1's, no stamp twice, a produce "
        f"stamped with epoch 1 fenced; said "
        f"{[e for e in err if 'PROMOTED' in e or 'recovered' in e]}")
    return facts


def failover_phase(SQ, values, b1, card, kw=None, cut=None, device="cuda",
                   serve_extra=()):
    """Phase 14: the failover drills (see the module docstring) over
    `values`, the zipf stream's JSON; `b1` = phase 4's (MatchOut lines,
    sha256). -> B1 launches of 14a."""
    import shutil
    import tempfile

    kw = kw or SERVE
    cut = cut or (SERVE_CKPT_EVERY, FAILOVER_KILL_AT, FAILOVER_PART1)
    root = tempfile.mkdtemp(prefix="kme_failover_")
    try:
        t = time.perf_counter()
        launches = follow_and_promote(SQ, values, root, b1, kw, cut, device,
                                      "follow-promote")
        log(f"phase 14a took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        hot = supervised_drill(values, root, b1, cut, True, serve_extra,
                               "supervised-failover")
        log(f"phase 14b took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        cold = supervised_drill(values, root, b1, cut, False, serve_extra,
                                "supervised-cold")
        log(f"phase 14c took {time.perf_counter() - t:.1f} s")
        log(f"failover: hot {hot['recovery']['failover_seconds']} s "
            f"(detection to the promoted standby's first heartbeat) against "
            f"cold {cold['recovery']['recovered_in']} s (detection to the "
            f"restarted child's first heartbeat); a card child's first "
            f"heartbeat {hot['first_heartbeat_s']}, "
            f"{cold['first_heartbeat_s']} s after its spawn (--grace "
            f"{SUPERVISE_GRACE}); card {card}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 15: the chaos drills


class CardChildren:
    """Watches the serve and standby heartbeat files of a chaos run on a
    thread of its own: every 20 ms, the pid each names and the card's
    device nodes that pid holds open (a process with a CUDA context on
    the card holds its node), and each new heartbeat of a path as (its
    own wall time, input offset, `device_ms_per_batch`), with the wall
    time the path first existed; every 0.5 s, the count of processes with
    a context on the card (`nvidia-smi --query-compute-apps`) and the
    host's CPU time counters (/proc/stat: total and idle jiffies)."""

    def __init__(self, paths, card):
        import threading

        self.paths, self.card = list(paths), card
        self.pids, self.on_card, self.errors = set(), {}, []
        self.first = {}
        self.beats = {p: [] for p in self.paths}
        self.load = []
        self.apps0 = gpu_apps()[0] if card else None
        self.apps_max = self.apps0
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def _run(self):
        next_smi = 0.0
        while not self._stop.wait(0.02):
            for path in self.paths:
                try:
                    with open(path) as f:
                        hb = json.load(f)
                    pid = int(hb["pid"])
                except (OSError, ValueError, KeyError, TypeError):
                    continue
                self.first.setdefault(path, time.time())
                beats = self.beats[path]
                if not beats or beats[-1][0] != hb.get("time"):
                    gauges = hb.get("metrics", {}).get("gauges", {})
                    beats.append((hb.get("time"), hb.get("offset"),
                                  gauges.get("device_ms_per_batch")))
                self.pids.add(pid)
                nodes = card_nodes(pid) if self.card else []
                if nodes:
                    self.on_card.setdefault(pid, nodes)
            if time.monotonic() < next_smi:
                continue
            next_smi = time.monotonic() + 0.5
            with contextlib.suppress(OSError, ValueError), \
                    open("/proc/stat") as f:
                jiffies = [int(x) for x in f.readline().split()[1:]]
                self.load.append((time.time(), sum(jiffies),
                                  jiffies[3] + jiffies[4]))
            if self.card:
                r = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60)
                if r.returncode != 0:
                    self.errors.append(r.stderr.strip())
                else:
                    self.apps_max = max(self.apps_max,
                                        len(r.stdout.strip().splitlines()))

    def stop(self):
        self._stop.set()
        self._th.join()

    def busy(self, t_lo, t_hi):
        """The host CPUs' busy share in each 0.5 s sample interval of
        [t_lo, t_hi]: [(interval end, share)]."""
        out = []
        for (_, tot0, idle0), (t, tot, idle) in zip(self.load,
                                                   self.load[1:]):
            if t_lo <= t <= t_hi and tot > tot0:
                out.append((t, round(1 - (idle - idle0) / (tot - tot0), 3)))
        return out


def chaos_drill(root, label, argv, card, device="cuda", min_apps=1,
                states=("state",)):
    """One `python -m kme_tpu_torch.cli chaos --engine seq` run as a
    subprocess, the serve and standby heartbeats under each of its
    `states` directories watched (CardChildren). Fails unless its report
    says ok, every child named in a heartbeat held the card's device
    node, the context count grew by `min_apps`, and each last leader
    heartbeat counts service batches and kernel-counted messages.
    -> (report, wall seconds, the run's stderr lines, the watcher)."""
    import signal

    run_dir = os.path.join(root, label)
    cmd = [sys.executable, "-m", "kme_tpu_torch.cli", "chaos", "--engine",
           "seq", "--device", device, "--seed", "0", "--dir", run_dir,
           "--timeout", str(CHAOS_LIMIT_S), *CHAOS_SERVE, *argv]
    env = {k: v for k, v in os.environ.items()
           if k not in ("KME_FAULTS", "KME_FAULTS_STATE")}
    env["PYTHONPATH"] = ROOT
    errpath = os.path.join(root, label + ".stderr")
    watch = CardChildren([os.path.join(run_dir, st, hb) for st in states
                          for hb in ("serve.health", "standby.health")],
                         card=device != "cpu")
    t0 = time.perf_counter()
    with open(errpath, "w") as errf:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=errf,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        rc = proc.wait(timeout=CHAOS_LIMIT_S + 120)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        wall = time.perf_counter() - t0
        watch.stop()
        # chaos's children share its session: stop whatever is left
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    with open(errpath) as f:
        err = f.read().splitlines()
    try:
        with open(os.path.join(run_dir, "chaos-report.json")) as f:
            report = json.load(f)
    except (OSError, ValueError):
        report = {"ok": False, "failures": ["no readable report"]}
    if rc != 0 or not report.get("ok"):
        fail(f"{label}: chaos exited {rc}, failures "
             f"{report.get('failures')}: {err[-20:]}")
    if device != "cpu":
        off = sorted(watch.pids - set(watch.on_card))
        if not watch.pids or off or watch.errors:
            fail(f"{label}: children {sorted(watch.pids)} seen, these never "
                 f"held the card's device node: {off}; nvidia-smi errors "
                 f"{watch.errors[:2]}")
        if watch.apps_max < watch.apps0 + min_apps:
            fail(f"{label}: {watch.apps_max} processes with a context on the "
                 f"card at most, {watch.apps0} before the run; want "
                 f"{min_apps} more")
    counted = []
    for st in states:
        with open(os.path.join(run_dir, st, "serve.health")) as f:
            counters = json.load(f)["metrics"]["counters"]
        if counters.get("service_batches", 0) <= 0 \
                or counters.get("msgs", 0) <= 0:
            fail(f"{label}: the last leader heartbeat in {st} counts no "
                 f"batch or no kernel-counted message: {counters}")
        counted.append(f"{counters['service_batches']} batches, "
                       f"{counters['msgs']} messages")
    log(f"{label}: children {sorted(watch.pids)} each held "
        f"{sorted({n for v in watch.on_card.values() for n in v})}; "
        f"processes with a card context {watch.apps0} -> {watch.apps_max}; "
        f"last leader heartbeat ({', '.join(states)}): "
        f"{'; '.join(counted)} counted by the kernel")
    return report, wall, err, watch


def recoveries_seen(report, err):
    """The supervisor's recoveries (fingerprint, recovered_in) and what
    each restore said about the snapshots it walked."""
    recs = [(r.get("fingerprint"), r.get("recovered_in"))
            for r in report["supervisor"].get("recoveries", [])]
    restores = [ln for ln in err if "skipping unreadable snapshot" in ln
                or "resumed from snapshot" in ln]
    return recs, restores


def chaos_phase(card, device="cuda"):
    """Phase 15 (see the module docstring): 15a the default gauntlet, 15b
    failover, 15c one storm, each `kme-torch-chaos --engine seq` against
    children on `device` (`cpu` rehearses it with the plain versions, the
    card checks left out). -> {drill: wall seconds}."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="kme_chaos_")
    walls = {}
    try:
        ckpt = ["--checkpoint-every", str(CHAOS_CKPT_EVERY)]
        # 15a: every fault class
        rep, walls["15a"], err, _ = chaos_drill(
            root, "chaos-default", ["--events", str(CHAOS_EVENTS), *ckpt],
            card, device)
        fired = rep["fault_fires"]
        rules = rep["schedule"].count(";")
        if rep["restarts_total"] < 2 or len(fired) != rules \
                or not all(n >= 1 for n in fired.values()):
            fail(f"15a: restarts {rep['restarts_total']}, fault fires "
                 f"{fired} of the {rules} rules of {rep['schedule']}")
        recs, restores = recoveries_seen(rep, err)
        # the schedule asks for three: the torn journal append and
        # serve.kill end the child (exit:-9), serve.stuck stalls it
        unasked = len(recs) - 3
        log(f"15a: {json.dumps(rep['verify'])}; restarts "
            f"{rep['restarts_total']} {recs} ({max(0, unasked)} beyond the "
            f"schedule's three), recovery_seconds {rep['recovery_seconds']}, "
            f"fault fires {fired}, producer {rep['producer']}, wall "
            f"{walls['15a']:.1f} s")
        for ln in restores:
            log(f"15a restore: {ln}")
        # 15b: hot-standby failover
        rep, walls["15b"], err, _ = chaos_drill(
            root, "chaos-failover", ["--scenario", "failover", "--events",
                                     str(CHAOS_EVENTS), *ckpt], card,
            device, min_apps=2)
        fo = rep["failover"]
        log(f"15b: failover_seconds {fo['failover_seconds']} (bound 2.0), "
            f"dup_suppressed_total {fo['dup_suppressed_total']}, "
            f"leader_epoch {fo['leader_epoch']}, stale_epoch_fenced "
            f"{fo['stale_epoch_fenced']}, {json.dumps(rep['verify'])}, "
            f"recovery_seconds {rep['recovery_seconds']}, wall "
            f"{walls['15b']:.1f} s")
        # 15c: the settlement storm at the adaptive overload controller
        rep, walls["15c"], err, _ = chaos_drill(
            root, "chaos-storm", ["--scenario", STORM, "--events",
                                  str(STORM_EVENTS), *ckpt,
                                  "--overload-high-lag", str(STORM_HIGH_LAG)],
            card, device)
        log(f"15c: {STORM} at --overload-high-lag {STORM_HIGH_LAG}: offered "
            f"{rep['offered']}, admitted {rep['admitted']}, shed "
            f"{rep['shed']} by class {rep['shed_by_class']} of "
            f"{rep['offered_by_class']} (rates "
            f"{rep['shed_rates_by_class']}), p99 {rep['slo']['p99_ms']} ms, "
            f"{rep['slo']['tput']} records/s, parity {json.dumps(rep['parity'])}, "
            f"controller {rep['controller_gauges']}, wall "
            f"{walls['15c']:.1f} s; card {card}")
        return walls
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 16: the other failover drills, the Kafka transport, the host tools


def supervisor_spawns(state_dir):
    """The wall times (s) of a supervisor's first child and standby
    spawns, from its event log."""
    spawn = {}
    with open(os.path.join(state_dir, "events-supervisor.jsonl")) as f:
        for ln in f:
            ev = json.loads(ln)
            spawn.setdefault(ev["kind"], ev["ts"] / 1e6)
    return spawn


def first_heartbeats(run_dir, states, watch):
    """Each child's seconds from its supervisor's spawn to its first
    heartbeat: {"<state> serve"|"<state> standby": s}."""
    out = {}
    for st in states:
        spawn = supervisor_spawns(os.path.join(run_dir, st))
        for hb, kind in (("serve", "supervisor.spawn"),
                         ("standby", "supervisor.standby_spawn")):
            path = os.path.join(run_dir, st, hb + ".health")
            if path in watch.first and kind in spawn:
                out[f"{st} {hb}"] = round(watch.first[path] - spawn[kind], 3)
    return out


def failover_drills_phase(card, device="cuda"):
    """Phase 16a and 16b (see the module docstring): `kme-torch-chaos
    --scenario shard-failover` and `--scenario feed-failover` against
    children on `device` (`cpu` rehearses them with the plain versions,
    the card checks left out). -> {drill: wall seconds}."""
    import shutil
    import tempfile

    from kme_tpu_torch.bridge.chaos import _busy_rate

    root = tempfile.mkdtemp(prefix="kme_failover_")
    walls = {}
    try:
        # 16a: two group leaders and the victim's hot standby on one card
        states = tuple(f"group{k}/state" for k in range(SHARD_GROUPS))
        rep, walls["16a"], err, watch = chaos_drill(
            root, "shard-failover",
            ["--scenario", "shard-failover", "--events", str(CHAOS_EVENTS),
             "--groups", str(SHARD_GROUPS), "--prefund", str(FRONT_PREFUND),
             "--cross-frac", str(SHARD_CROSS_FRAC),
             "--checkpoint-every", str(CHAOS_CKPT_EVERY),
             "--grace", str(SUPERVISE_GRACE),
             "--idle-exit", str(SHARD_IDLE_EXIT)],
            card, device, min_apps=SHARD_GROUPS + 1, states=states)
        run_dir = os.path.join(root, "shard-failover")
        victim = rep["victim"]
        unmeasured = [g for g, d in rep["survivor_dips"].items() if d is None]
        if unmeasured:
            fail(f"16a: survivors {unmeasured} show no busy rate during the "
                 f"outage (drained before it, or the window held under two "
                 f"samples): the dip check measured nothing; "
                 f"{rep['survivor_rates']}, substreams {rep['substreams']}")
        with open(os.path.join(run_dir, f"group{victim}", "state",
                               "supervisor.json")) as f:
            rec = next(r for r in json.load(f)["recoveries"]
                       if r.get("promoted"))
        det = float(rec["detected_at"])
        out_hi = det + float(rec["recovered_in"])
        log(f"16a: shard-failover, {rep['groups']} groups, substreams "
            f"{rep['substreams']}, victim g{victim} killed at "
            f"{rep['schedule']}; failover_seconds {rep['failover_seconds']} "
            f"(bound 2.0), outage window {rep['outage_window_s']} s; "
            f"survivors' busy rates (msgs/s, chaos's 10 Hz samples) "
            f"{json.dumps(rep['survivor_rates'])}, dips "
            f"{rep['survivor_dips']} (bound 0.10); duplicate stamps "
            f"{rep['duplicate_stamps']}, stale_epoch_fenced "
            f"{rep['stale_epoch_fenced']}, merged parity "
            f"{'byte-exact' if rep['verify']['ok'] else 'DIVERGED'} "
            f"({rep['verify'].get('merged_lines')} lines), "
            f"cross-shard transfers {rep['cross_shard_transfers']}, trace "
            f"{json.dumps(rep['trace'])}; wall {walls['16a']:.1f} s")
        log(f"16a: seconds from spawn to first heartbeat "
            f"{json.dumps(first_heartbeats(run_dir, states, watch))}")
        for k in range(SHARD_GROUPS):
            path = os.path.join(run_dir, f"group{k}", "state",
                                "serve.health")
            beats = [(t, off) for t, off, _ in watch.beats[path]
                     if t is not None]
            near = [(round(t - det, 3), off, ms)
                    for t, off, ms in watch.beats[path]
                    if t is not None and det - 1.0 <= t <= out_hi + 1.0]
            log(f"16a g{k}{' (victim)' if k == victim else ''}: busy rate "
                f"by the heartbeats' own clock, whole run "
                f"{_busy_rate(beats, 0.0, float('inf'))}, outage "
                f"{_busy_rate(beats, det, out_hi)} msgs/s; heartbeats from "
                f"1 s before detection to 1 s after recovery (s from "
                f"detection, offset, device_ms_per_batch): {near}")
        busy = [(round(t - det, 1), share)
                for t, share in watch.busy(det - 5, out_hi + 5)]
        log(f"16a: the host CPUs' busy share (/proc/stat, 0.5 s intervals, "
            f"s from detection) from 5 s before detection to 5 s after "
            f"recovery: {busy or 'not measured'}")
        # 16b: the feed tier across a card leader's failover
        rep, walls["16b"], err, watch = chaos_drill(
            root, "feed-failover",
            ["--scenario", "feed-failover", "--events", str(CHAOS_EVENTS),
             "--checkpoint-every", str(CHAOS_CKPT_EVERY),
             "--grace", str(SUPERVISE_GRACE)], card, device, min_apps=2)
        subs = rep["subscribers"]
        firsts = first_heartbeats(os.path.join(root, "feed-failover"),
                                  ("state",), watch)
        if rep["feed_reconnects"] < 1 or not all(
                s["byte_exact"] and s["gaps"] == 0 and s["dups"] == 0
                for s in subs):
            fail(f"16b: reconnects {rep['feed_reconnects']}, subscribers "
                 f"{subs}")
        log(f"16b: feed-failover, failover_seconds {rep['failover_seconds']} "
            f"(bound 2.0), feed reconnects {rep['feed_reconnects']}, frames "
            f"{rep['feed']['frames']}, feed_lag p99 {rep['feed_lag_p99_ms']} "
            f"ms, subscribers {json.dumps(subs)}; first heartbeats "
            f"{json.dumps(firsts)}; "
            f"wall {walls['16b']:.1f} s; card {card}")
        return walls
    finally:
        shutil.rmtree(root, ignore_errors=True)


def kafka_stand_in(logs):
    """A minimal in-memory stand-in for the aiokafka client surface that
    `KafkaBroker` calls (producer, consumer with assign/seek/getmany/
    end_offsets, admin, TopicPartition) over `logs` ({topic: [(key bytes,
    value bytes)]}), partition 0 only. -> {module name: module}."""
    import types

    class TopicPartition:
        def __init__(self, topic, partition):
            self.topic, self.partition = topic, partition

        def __hash__(self):
            return hash((self.topic, self.partition))

        def __eq__(self, o):
            return (self.topic, self.partition) == (o.topic, o.partition)

    class Client:
        def __init__(self, **kw):
            self.pos = {}

        async def start(self):
            pass

        async def stop(self):
            pass

        async def close(self):
            pass

        async def flush(self):
            pass

        async def send_and_wait(self, topic, value, key=None, partition=0):
            if partition != 0:
                raise ValueError(f"partition {partition}")
            logs.setdefault(topic, []).append((key, value))
            return types.SimpleNamespace(offset=len(logs[topic]) - 1)

        def assign(self, tps):
            for tp in tps:
                self.pos.setdefault(tp, 0)

        def seek(self, tp, offset):
            self.pos[tp] = offset

        async def getmany(self, *tps, timeout_ms=0, max_records=1024):
            out = {}
            for tp in tps:
                pos = self.pos.get(tp, 0)
                recs = logs.get(tp.topic, [])[pos:pos + max_records]
                if recs:
                    out[tp] = [types.SimpleNamespace(offset=pos + i, key=k,
                                                     value=v)
                               for i, (k, v) in enumerate(recs)]
                    self.pos[tp] = pos + len(recs)
            return out

        async def end_offsets(self, tps):
            return {tp: len(logs.get(tp.topic, [])) for tp in tps}

        async def list_topics(self):
            return list(logs)

        async def create_topics(self, news):
            for n in news:
                logs.setdefault(n.name, [])

    mod = types.ModuleType("aiokafka")
    admin = types.ModuleType("aiokafka.admin")
    mod.TopicPartition = TopicPartition
    mod.AIOKafkaProducer = mod.AIOKafkaConsumer = Client
    admin.AIOKafkaAdminClient = Client
    admin.NewTopic = lambda name, **kw: types.SimpleNamespace(name=name)
    mod.admin = admin
    return {"aiokafka": mod, "aiokafka.admin": admin}


def kafka_phase(SQ, values, b1_prefix, card, device="cuda"):
    """Phase 16c: `kme_tpu_torch.bridge.serve.main([... "--kafka" ...])`
    in process over the first KAFKA_PREFIX messages, the seq engine on
    `device` at the serve defaults, the Kafka cluster an in-memory
    stand-in: its MatchOut must be B1's lines for those messages
    (`b1_prefix`, per message), launches = dispatches. -> B1 launches."""
    import torch

    from kme_tpu_torch.bridge import serve
    from kme_tpu_torch.bridge import service as SV

    P = KAFKA_PREFIX
    logs = {"MatchIn": [(None, v.encode()) for v in values[:P]]}
    mods = kafka_stand_in(logs)
    saved = {name: sys.modules.get(name) for name in mods}
    made = []

    class Service(SV.MatchService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    orig = SV.MatchService
    sys.modules.update(mods)
    SV.MatchService = Service
    try:
        zero_launches(SQ.LAUNCHES)
        t = time.perf_counter()
        rc = serve.main(["--kafka", "stand-in:9092", "--engine", "seq",
                         "--device", device, "--auto-provision",
                         "--max-messages", str(P)])
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        SV.MatchService = orig
        for name, m in saved.items():
            if m is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = m
    if rc != 0 or len(made) != 1:
        fail(f"16c: serve --kafka exited {rc} ({len(made)} services)")
    svc = made[0]
    launches = (seq_launches_checked(SQ, svc, "16c") if device != "cpu"
                else svc._session.dispatches)
    got = [f"{k.decode()} {v.decode()}" for k, v in logs.get("MatchOut", [])]
    want = [ln for m in b1_prefix for ln in m]
    if len(b1_prefix) != P or got != want:
        fail(f"16c: the Kafka-served MatchOut ({len(got)} lines) != B1's "
             f"lines for the first {P} messages ({len(want)} lines)")
    log(f"16c: kme-torch-serve --kafka (the Kafka cluster an in-memory "
        f"stand-in for aiokafka; the card and B1 real): {P} messages in "
        f"{wall:.3f} s = {P / wall:.0f} msg/s (host clock, synchronized; "
        f"the engine built inside), {launches} B1 launches = dispatches, "
        f"MatchOut == B1's lines for those messages ({len(got)} lines); "
        f"card {card}")
    return launches


def host_tools_phase(java_values):
    """Phase 16d: `python -m kme_tpu_torch.cli sim --seed N --json` for
    each of SIM_DIGESTS, and `... oracle --compat java` over the java
    stream, as subprocesses (no JAX on the card machine): the recorded
    digests and the java oracle's MatchOut."""
    import shutil
    import tempfile

    cli = [sys.executable, "-m", "kme_tpu_torch.cli"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    root = tempfile.mkdtemp(prefix="kme_sim_")
    try:
        for seed, want in SIM_DIGESTS.items():
            t = time.perf_counter()
            r = subprocess.run(cli + ["sim", "--seed", str(seed), "--json",
                                      "--out", os.path.join(root, str(seed))],
                               cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=600)
            wall = time.perf_counter() - t
            try:
                doc = json.loads(r.stdout)
            except ValueError:
                doc = {}
            got = (doc.get("trace_digest"), doc.get("out_digest"))
            if r.returncode != 0 or not doc.get("ok") or got != want:
                fail(f"16d: kme-torch-sim --seed {seed} exited "
                     f"{r.returncode}, ok {doc.get('ok')}, digests {got}; "
                     f"recorded {want}: {r.stderr[-2000:]}")
            log(f"16d: kme-torch-sim --seed {seed}: green, trace_digest "
                f"{got[0]}, out_digest {got[1]} (== both packages' CPU "
                f"runs), vtime {doc['vtime']}, counters "
                f"{json.dumps(doc['counters'])}; {wall:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    r = subprocess.run(cli + ["oracle", "--compat", "java"], cwd=ROOT, env=env,
                       input="".join(v + "\n" for v in java_values),
                       capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t
    got = stream_digest(r.stdout.splitlines())
    if r.returncode != 0 or got != (JAVA_LINES, JAVA_SHA256):
        fail(f"16d: kme-torch-oracle --compat java exited {r.returncode}, "
             f"{got[0]} lines sha256 {got[1]}; the java oracle gives "
             f"{JAVA_LINES} lines sha256 {JAVA_SHA256}: {r.stderr[-2000:]}")
    log(f"16d: kme-torch-oracle --compat java over the java stream "
        f"({len(java_values)} messages): {got[0]} lines, sha256 {got[1]} == "
        f"the java oracle's; {wall:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the serial parity replica and the lint

def oracle_run(OracleEngine, msgs, compat):
    """-> (MatchOut lines per message, death index or None, the exception
    at the death, the engine)."""
    eng = OracleEngine(compat)
    lines = []
    for i, m in enumerate(msgs):
        try:
            lines.append([r.wire() for r in eng.process(m.copy())])
        except Exception as e:  # the reference's deaths
            return lines, i, e, eng
    return lines, None, None, eng


def oracle_stores(ora) -> dict:
    orders = {oid: {"action": r.action, "aid": r.aid, "sid": r.sid,
                    "price": r.price, "size": r.size, "next": r.next,
                    "prev": r.prev} for oid, r in ora.orders.items()}
    return {"balances": dict(ora.balances), "positions": dict(ora.positions),
            "books": dict(ora.books), "buckets": dict(ora.buckets),
            "orders": orders}


def replica_run(P, compat, msgs, label):
    """The replica on the card over `msgs` -> (lines per message, engine,
    msgs/s, syncs per message); fails on a death or a state off the
    card."""
    import torch

    eng = P.ParityEngine(compat, P.ParityCaps(**PARITY_CAPS), device="cuda")
    bad = [k for k, v in eng.state.items() if v.device.type != "cuda"]
    if bad:
        fail(f"17 {label}: state tensors {bad} are not on the card")
    t = time.perf_counter()
    try:
        out = eng.process_batch(msgs)
    except P.DeviceParityError as e:
        fail(f"17 {label}: the replica died at message {e.index}: {e}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if eng.captured == 0:
        fail(f"17 {label}: no segment ran from a CUDA graph")
    lines = [[r.wire() for r in recs] for recs in out]
    return lines, eng, len(msgs) / wall, eng.syncs / len(msgs), wall


def parity_phase(card, small_java_lines):
    """Phase 17 (see the module docstring): (a) java at the bench caps
    over harness_stream(4096) == the java oracle, lines and stores; (b)
    phase 2b's stream == the card SeqSession's (B2) lines; (c) fixed mode
    == the fixed oracle, and a java death == the oracle's; (d)
    `kme-torch-lint --gate` exits 0."""
    import torch
    from kme_tpu_torch import opcodes as op
    from kme_tpu_torch.engine import parity as P
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.wire import OrderMsg
    from kme_tpu_torch.workload import harness_stream

    t_phase = time.perf_counter()
    # ---- (a) java at full size against the java oracle
    msgs = harness_stream(PARITY_EVENTS, seed=0)
    t = time.perf_counter()
    want, death, _, ora = oracle_run(OracleEngine, msgs, "java")
    ora_s = time.perf_counter() - t
    if death is not None:
        fail(f"17a: the java oracle died at message {death}")
    got, eng, rate, syncs, wall = replica_run(P, "java", msgs, "a")
    if got != want:
        i = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        fail(f"17a: replica != java oracle at message {i}: {got[i]} vs "
             f"{want[i]}")
    if eng.export_state() != oracle_stores(ora):
        fail("17a: the replica's stores != the java oracle's")
    nlines = sum(len(x) for x in got)
    log(f"17a: ParityEngine('java') on the card over harness_stream("
        f"{PARITY_EVENTS}, seed=0): {len(msgs)} messages, {nlines} lines "
        f"== the java oracle's, export_state == its stores, state on "
        f"{eng.state['ord'].device}, {eng.captured} segment graphs; "
        f"{wall:.2f} s, {rate:.1f} msgs/s, {syncs:.3f} D2H syncs per "
        f"message (oracle {ora_s:.2f} s); {card}")
    del eng

    # ---- (b) cross-evidence: phase 2b's stream against the card's B2
    msgs = harness_stream(1500, seed=3)
    got, eng, rate, syncs, wall = replica_run(P, "java", msgs, "b")
    if got != small_java_lines:
        i = next(i for i, (g, w) in enumerate(zip(got, small_java_lines))
                 if g != w)
        fail(f"17b: replica != phase 2b's card SeqSession (B2) at message "
             f"{i}: {got[i]} vs {small_java_lines[i]}")
    log(f"17b: the replica over phase 2b's harness_stream(1500, seed=3): "
        f"{sum(len(x) for x in got)} lines == the card SeqSession's (B2, "
        f"java mode); {wall:.2f} s, {rate:.1f} msgs/s, {syncs:.3f} syncs "
        f"per message")
    del eng

    # ---- (c) fixed mode against the fixed oracle; a java death
    msgs = harness_stream(1500, seed=3, payout_opcode_bug=False,
                          validate=True)
    want, death, _, ora = oracle_run(OracleEngine, msgs, "fixed")
    if death is not None:
        fail(f"17c: the fixed oracle died at message {death}")
    got, eng, rate, syncs, wall = replica_run(P, "fixed", msgs, "c")
    if got != want:
        i = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        fail(f"17c: replica != fixed oracle at message {i}")
    if eng.export_state() != oracle_stores(ora):
        fail("17c: the replica's stores != the fixed oracle's")
    pays = sum(m.action == op.PAYOUT for m in msgs)
    log(f"17c: ParityEngine('fixed') over harness_stream(1500, seed=3, "
        f"validate): {len(msgs)} messages ({pays} PAYOUT), lines and "
        f"stores == the fixed oracle's; {wall:.2f} s, {rate:.1f} msgs/s, "
        f"{syncs:.3f} syncs per message")
    del eng
    death_msgs = []
    for a in range(4):
        death_msgs += [OrderMsg(action=op.CREATE_BALANCE, aid=a),
                       OrderMsg(action=op.TRANSFER, aid=a, size=200_000)]
    death_msgs += [OrderMsg(action=op.ADD_SYMBOL, sid=1),
                   OrderMsg(action=op.BUY, oid=7, aid=0, sid=1, price=40,
                            size=5),
                   OrderMsg(action=op.SELL, oid=8, aid=1, sid=1, price=60,
                            size=2),
                   OrderMsg(action=op.REMOVE_SYMBOL, sid=1),
                   OrderMsg(action=op.CREATE_BALANCE, aid=9)]
    want, death, exc, _ = oracle_run(OracleEngine, death_msgs, "java")
    eng = P.ParityEngine("java", P.ParityCaps(**PARITY_CAPS), device="cuda")
    try:
        eng.process_batch(death_msgs)
        fail("17c: the replica did not die on REMOVE_SYMBOL of a non-empty "
             "book")
    except P.DeviceParityError as e:
        recs = [[r.wire() for r in x] for x in e.records]
        if (type(exc).__name__, e.code, e.index, recs) != (
                "ReferenceHang", P.ERR_HANG, death, want):
            fail(f"17c: replica death (code {e.code}, index {e.index}, "
                 f"{len(recs)} records) != the oracle's ({exc!r} at "
                 f"{death}, {len(want)} records)")
    log(f"17c: java REMOVE_SYMBOL on a non-empty book: DeviceParityError "
        f"ERR_HANG at message {death} == the oracle's ReferenceHang, the "
        f"{len(want)} messages' records before it equal")

    # ---- (d) the lint gate on this machine
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "kme_tpu_torch.cli", "lint",
                        "--gate"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    summary = [ln for ln in r.stdout.splitlines()
               if ln.startswith("kme-torch-lint:")]
    if r.returncode != 0 or not summary:
        fail(f"17d: kme-torch-lint --gate exited {r.returncode}: "
             f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    log(f"17d: python -m kme_tpu_torch.cli lint --gate: rc 0, "
        f"{summary[-1][len('kme-torch-lint: '):]}; "
        f"{time.perf_counter() - t:.1f} s")
    wall = time.perf_counter() - t_phase
    log(f"phase 17 took {wall:.1f} s")
    if wall > PARITY_PHASE_LIMIT_S:
        log(f"phase 17: {wall:.1f} s is past its {PARITY_PHASE_LIMIT_S:.0f} "
            f"s budget")


# ---------------------------------------------------------------------------
# phase 18: perfgate over what the card wrote

def profiled_service(SQ, values, root, kw, label, device="cuda"):
    """`values` through an in-process broker into a pipelined seq service
    with its history and profiling on: a TSDB at `root`/tsdb (a heartbeat
    every PERFGATE_HEALTH_S), the host profiler, and the device plane into
    `root`/transfer.json. -> (MatchOut lines, wall s, dispatches,
    rows-in-use launches, the `lat_e2e` latency snapshot, the plane)."""
    import torch

    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT, MatchService
    from kme_tpu_torch.telemetry.profiler import read_transfer_artifact

    broker = InProcessBroker()
    provision(broker)
    for v in values:
        broker.produce(TOPIC_IN, None, v)
    art = os.path.join(root, "transfer.json")
    svc = MatchService(broker, engine="seq", compat="fixed", pipeline=2,
                       tsdb=os.path.join(root, "tsdb"), profile=True,
                       profile_artifact=art, device=device, **kw)
    if svc.pipeline != 2:
        fail(f"18 {label}: the service did not take the pipeline")
    zero_launches(SQ.LAUNCHES)
    t = time.perf_counter()
    n = svc.run(max_messages=len(values), poll_timeout=0.05,
                health_every=PERFGATE_HEALTH_S)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ses = svc._session
    if device != "cpu":
        dispatches = seq_launches_checked(SQ, svc, f"18 {label}")
    else:
        dispatches = ses.dispatches
    rows = SQ.LAUNCHES["rows_in_use"]
    if device != "cpu" and rows != (dispatches if ses.cfg.nr > 1 else 0):
        fail(f"18 {label}: {rows} rows-in-use launches for {dispatches} "
             f"dispatches at {ses.cfg.nr} rows per side")
    e2e = svc.telemetry.snapshot()["latencies"]["lat_e2e"]
    svc.close()
    if n != len(values):
        fail(f"18 {label}: served {n} of {len(values)} messages")
    # the artifact keys each plane by its backend
    backend = torch.device(device).type
    plane = dict(read_transfer_artifact(art).get(backend, {}),
                 backend=backend)
    return log_lines(broker, TOPIC_OUT), wall, dispatches, rows, e2e, plane


def perfgate_phase(SQ, values, b1_prefix, b3_prefix, card, device="cuda",
                   kw_a=SERVE, kw_b=PERFGATE_DEEP):
    """Phase 18: (a) services A (`kw_a`, B1) and B (`kw_b`, B3 behind the
    rows-in-use kernel) over `values` (the zipf stream's JSON prefix), each
    MatchOut == the earlier card runs' lines for those messages
    (`b1_prefix`, `b3_prefix`, per message); (b) `python -m
    kme_tpu_torch.cli prof --diff` of A's store against itself (no
    suspect) and against B's (stages whose every ratio is the in-process
    window summaries'), the verdict logged; (c) `python -m
    kme_tpu_torch.perfgate` over a detail artifact of A's own measurements
    and copies with `device_ms_per_batch` x PERFGATE_SLOWDOWN (exit 1,
    `device` named) and that copy tagged `cpu` (advisory, exit 0).
    -> (B1 launches, B3 launches, rows-in-use launches)."""
    import shutil
    import tempfile

    from kme_tpu_torch import perfgate
    from kme_tpu_torch.telemetry import tsdb as tsdbm

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kme_perfgate_")
    env = dict(os.environ, PYTHONPATH=ROOT)

    def cli(mod, *argv):
        r = subprocess.run([sys.executable, "-m", mod, *argv], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        return r.returncode, r.stdout, r.stderr

    try:
        # ---- (a) the two services, each held to the earlier lines
        runs = {}
        for label, kw, want in (("A", kw_a, b1_prefix), ("B", kw_b, b3_prefix)):
            d = os.path.join(root, label)
            os.makedirs(d)
            lines, wall, disp, rows, e2e, plane = profiled_service(
                SQ, values, d, kw, label, device)
            if len(want) != len(values) or per_message(lines) != want:
                fail(f"18 {label}: MatchOut ({len(lines)} lines) != the "
                     f"earlier card run's lines for the first {len(values)} "
                     f"messages ({sum(map(len, want))} lines)")
            store = os.path.join(d, "tsdb")
            samples = len({(src, seq) for src, _ts, seq, _n, _v
                           in tsdbm.read_samples(store)})
            if samples < PERFGATE_MIN_SAMPLES:
                fail(f"18 {label}: {samples} heartbeat samples in the store "
                     f"(at least {PERFGATE_MIN_SAMPLES})")
            runs[label] = dict(store=store, wall=wall, disp=disp, rows=rows,
                               e2e=e2e, plane=plane,
                               summary=tsdbm.window_summary(store))
            log(f"18a {label} (slots {kw['slots']}): {len(values)} messages "
                f"in {wall:.3f} s = {len(values) / wall:.0f} msg/s (host "
                f"clock, synchronized), {disp} dispatches = kernel launches, "
                f"{rows} rows-in-use launches, MatchOut == the earlier "
                f"lines ({len(lines)}); {samples} heartbeat samples, "
                f"{len(runs[label]['summary'])} series; device plane "
                f"{plane.get('kernel_ms_per_dispatch')} ms per dispatch "
                f"(CUDA events); lat_e2e p99 {e2e.get('p99_ms')} ms")
        a, b = runs["A"], runs["B"]

        # ---- (b) kme-torch-prof --diff over the two stores
        rc, out, err = cli("kme_tpu_torch.cli", "prof", "--diff", a["store"],
                           a["store"], "--json")
        try:
            att = json.loads(out)
        except ValueError:
            att = {}
        if rc != 0 or not att.get("stages") or att.get("suspect") is not None:
            fail(f"18b: prof --diff A A exited {rc}, suspect "
                 f"{att.get('suspect')}, {len(att.get('stages') or [])} "
                 f"stages: {err[-2000:]}")
        rc, out, err = cli("kme_tpu_torch.cli", "prof", "--diff", a["store"],
                           b["store"], "--json")
        try:
            att = json.loads(out)
        except ValueError:
            att = {}
        if rc != 0 or not att.get("stages"):
            fail(f"18b: prof --diff A B exited {rc} with "
                 f"{len(att.get('stages') or [])} stages: {err[-2000:]}")
        wa, wb = a["summary"], b["summary"]
        for s in att["stages"]:
            for e in s["evidence"]:
                n = e["name"]
                if (e["baseline"], e["current"], e["ratio"]) != (
                        wa[n], wb[n], round(wb[n] / wa[n], 4)):
                    fail(f"18b: prof --diff's evidence {e} != the window "
                         f"summaries' ({wa.get(n)}, {wb.get(n)})")
        if att != perfgate.attribute_regression(wa, wb):
            fail("18b: prof --diff != attribute_regression in process")
        top = att["stages"][0]
        ev = max(top["evidence"], key=lambda e: e["ratio"])
        log(f"18b: prof --diff A A: rc 0, no suspect; prof --diff A B: rc 0, "
            f"suspect {att['suspect']}, top stage {top['stage']} x"
            f"{top['score']} (its top evidence {ev['name']} {ev['baseline']} "
            f"-> {ev['current']}, x{ev['ratio']}); every ratio == the window "
            f"summaries'; card {card}")
        for ln in perfgate.format_attribution(att).splitlines():
            log(f"18b:   {ln}")

        # ---- (c) the gate over artifacts of A's own measurements
        detail = {"backend": a["plane"].get("backend"),
                  "orders_per_sec": len(values) / a["wall"],
                  "device_ms_per_batch": a["plane"].get(
                      "kernel_ms_per_dispatch"),
                  "p99_ms": a["e2e"].get("p99_ms")}
        if detail["backend"] != "cuda" or not all(detail.values()):
            fail(f"18c: A's detail artifact is incomplete: {detail}")
        slow = dict(detail, device_ms_per_batch=detail["device_ms_per_batch"]
                    * PERFGATE_SLOWDOWN)
        paths = {}
        for name, doc in (("detail", detail), ("slow", slow),
                          ("slow_cpu", dict(slow, backend="cpu"))):
            paths[name] = os.path.join(root, f"{name}.json")
            with open(paths[name], "w") as f:
                json.dump(doc, f)
        rep = os.path.join(root, "report.json")
        gate = "kme_tpu_torch.perfgate"
        rc, _out, err = cli(gate, paths["detail"], paths["detail"])
        if rc != 0 or "gate clean" not in err:
            fail(f"18c: perfgate A A exited {rc}: {err[-2000:]}")
        rc, _out, err = cli(gate, paths["detail"], paths["slow"], "--report",
                            rep)
        with open(rep) as f:
            report = json.load(f)
        if (rc != 1 or report["regressions"] != ["device_ms_per_batch"]
                or report["attribution"]["suspect"] != "device"):
            fail(f"18c: perfgate A against device_ms_per_batch x"
                 f"{PERFGATE_SLOWDOWN} exited {rc}, regressions "
                 f"{report['regressions']}: {err[-2000:]}")
        rc, out, err = cli(gate, paths["detail"], paths["slow"], "--attribute")
        if rc != 1 or "the device stage moved the most" not in out:
            fail(f"18c: perfgate --attribute exited {rc}: {out[-2000:]} "
                 f"{err[-2000:]}")
        rc, _out, err = cli(gate, paths["detail"], paths["slow_cpu"])
        if rc != 0 or "ADVISORY" not in err:
            fail(f"18c: perfgate against the cpu-tagged copy exited {rc}: "
                 f"{err[-2000:]}")
        log(f"18c: python -m kme_tpu_torch.perfgate over A's detail artifact "
            f"{json.dumps(detail)}: A A rc 0; device_ms_per_batch x"
            f"{PERFGATE_SLOWDOWN} rc 1, regressed {report['regressions']}, "
            f"--attribute names device; the copy tagged cpu rc 0 (advisory)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"phase 18 took {wall:.1f} s")
    if wall > PERFGATE_PHASE_LIMIT_S:
        log(f"phase 18: {wall:.1f} s is past its "
            f"{PERFGATE_PHASE_LIMIT_S:.0f} s budget")
    return runs["A"]["disp"], runs["B"]["disp"], runs["B"]["rows"]


def bench_phase(SQ, card):
    """Phase 19: (a) `bench_seq_engine` at the serve defaults on the card,
    with its launches of B1 counted; (b) its detail artifact gated against
    itself and against a copy with `local_orders_per_sec` halved, through
    `python -m kme_tpu_torch.cli bench --gate-current` in subprocesses.
    -> B1 launches."""
    import shutil
    import tempfile

    import torch

    from kme_tpu_torch import benchmarks

    t_phase = time.perf_counter()
    os.environ["KME_BENCH_DEV_REPS"] = str(BENCH_DEV_REPS)
    zero_launches(SQ.LAUNCHES)
    try:
        rec = benchmarks.bench_seq_engine(
            events=BENCH_EVENTS, symbols=SERVE["symbols"],
            accounts=SERVE["accounts"], seed=0, zipf_a=1.2,
            slots=SERVE["slots"], max_fills=SERVE["max_fills"],
            batch=SERVE["batch"], with_java=False, device="cuda")
    except AssertionError as e:
        fail(f"19a: the seq suite's in-run check failed: {e}")
    torch.cuda.synchronize()
    launches = dict(SQ.LAUNCHES)
    d = rec["detail"]
    want = BENCH_DEV_REPS + 1 + 1 + 3
    if launches["fixed"] != want or launches["java"] or \
            launches["rows_in_use"]:
        fail(f"19a: launches {launches}; the suite made {want} seq_scan "
             f"calls of B1 ({BENCH_DEV_REPS} + 1 device-path, 1 warm, 3 "
             f"timed) and none of the others")
    if (d["parity_checked_msgs"] != d["events"] or d["backend"] != "cuda"
            or not d["device_path_s"] > 0
            or not d["device_path_method"].startswith("CUDA events")
            or rec["metric"] != "orders_per_sec_e2e"):
        fail(f"19a: the suite's record is not the card's: {rec['metric']} "
             f"{json.dumps({k: d[k] for k in ('events', 'backend', 'device_path_s', 'device_path_method', 'parity_checked_msgs', 'cap_rejects')})}")
    log(f"19a: bench_seq_engine at the serve defaults, {d['events']} "
        f"messages: {rec['value']} orders/s end to end (best of "
        f"{d['all_run_walls_s']} s), device path {d['device_path_s']} s "
        f"= {d['device_path_msgs_per_sec']} msgs/s (CUDA events), local "
        f"{d['local_orders_per_sec']} orders/s, {d['out_records']} "
        f"records, {d['fetched_mb']} MB fetched, {d['cap_rejects']} "
        f"capacity rejects, phases "
        f"parse {d['parse_s']} plan {d['plan_s']} dispatch "
        f"{d['dispatch_s']} fetch {d['fetch_s']} recon {d['recon_s']} s; "
        f"full-stream parity vs the native judge; B1 launches "
        f"{launches['fixed']}; card {card}")

    root = tempfile.mkdtemp(prefix="kme_bench_")
    env = dict(os.environ, PYTHONPATH=ROOT)
    try:
        base = os.path.join(root, "detail.json")
        with open(base, "w") as f:
            f.write(json.dumps(d))
        slow = os.path.join(root, "slow.json")
        with open(slow, "w") as f:
            f.write(json.dumps(dict(d, local_orders_per_sec=d[
                "local_orders_per_sec"] / 2)))
        for cur, rc_want in ((base, 0), (slow, 1)):
            r = subprocess.run(
                [sys.executable, "-m", "kme_tpu_torch.cli", "bench",
                 "--baseline", base, "--gate-current", cur], cwd=ROOT,
                env=env, capture_output=True, text=True, timeout=120)
            named = "local_orders_per_sec" in r.stderr and \
                "REGRESSION" in r.stderr
            if r.returncode != rc_want or (rc_want == 1) != named:
                fail(f"19b: bench --gate-current {os.path.basename(cur)} "
                     f"exited {r.returncode} (want {rc_want}): "
                     f"{r.stderr[-2000:]}")
        log("19b: python -m kme_tpu_torch.cli bench --baseline D "
            "--gate-current D: rc 0; against D with local_orders_per_sec "
            "halved: rc 1, local_orders_per_sec named")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"phase 19 took {wall:.1f} s")
    if wall > BENCH_PHASE_LIMIT_S:
        log(f"phase 19: {wall:.1f} s is past its "
            f"{BENCH_PHASE_LIMIT_S:.0f} s budget")
    return launches["fixed"]



def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one card")
    try:
        from kme_tpu_torch import native
        from kme_tpu_torch.engine import lanes as L
        from kme_tpu_torch.engine import seq as SQ
        from kme_tpu_torch.engine.lanes import MET_REJ_RISK
        from kme_tpu_torch.ops import rowdma
        from kme_tpu_torch.runtime import seqsession as SS
        from kme_tpu_torch.runtime import session as LS
        from kme_tpu_torch.runtime.seqsession import SeqRouter, SeqSession
        from kme_tpu_torch.wire import WireBatch, dumps_order, parse_order
        from kme_tpu_torch.parallel import seqmesh as SM
        from kme_tpu_torch.workload import (deep_book_stream, harness_stream,
                                            zipf_hot_stream,
                                            zipf_symbol_stream)
    except ImportError as e:
        fail(f"the port's package is not importable here ({e}); run from "
             f"the root of a checkout")
    if "jax" in sys.modules or any(m == "kme_tpu" or m.startswith("kme_tpu.")
                                   for m in sys.modules):
        fail("the port imported JAX or the JAX package")
    kernels = []

    # ---- 1. card and build
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t = time.perf_counter()
    libs = ["seq_step", "rowdma"]
    native.build_many(libs, fresh=True)
    log(f"built {', '.join(libs)} in {time.perf_counter() - t:.1f} s")
    for name in libs:
        log(f"{name}: source sha256 {native.source_sha256(name)}; ptxas:")
        log(native.build_logs.get(name, ""))
    t = time.perf_counter()
    host = native.load_library()
    if host is None:
        fail("KME_NATIVE=0 is set: this run drives the native host path")
    log(f"host runtime {host._name} (g++ sources' sha256 "
        f"{native.host_tag()}…) built or loaded in "
        f"{time.perf_counter() - t:.1f} s")

    # ---- 2. small: card session vs CPU session; 2b. the same in java mode
    small_java_lines = []   # phase 17b's reference
    for label, kw, msgs in (
            ("small", SMALL, zipf_symbol_stream(
                3000, num_symbols=12, num_accounts=200, seed=5,
                payout_per_mille=6)),
            ("small java", SMALL_JAVA, harness_stream(1500, seed=3))):
        cfg_s = SQ.SeqConfig(**kw)
        gpu, cpu = SeqSession(cfg_s), SeqSession(cfg_s, device="cpu")
        for lo in range(0, len(msgs), 700):
            part = msgs[lo:lo + 700]
            lines = gpu.process_wire(part)
            if lines != cpu.process_wire(part):
                fail(f"{label} stream: MatchOut differs in messages {lo}..")
            if kw is SMALL_JAVA:
                small_java_lines.extend(lines)
        torch.cuda.synchronize()
        for k in SQ.state_keys(cfg_s):
            if not torch.equal(gpu.state[k].cpu(), cpu.state[k]):
                fail(f"{label} stream: state plane {k} differs")
        log(f"{label}: {len(msgs)} messages, card == plain version "
            f"(MatchOut lines and all {len(gpu.state)} state planes)")

    # ---- 3. B1 vs plain version at full width
    cfg = SQ.SeqConfig(**FULL)
    msgs, wb = parse_both(parse_order, dumps_order, WireBatch,
                          zipf_symbol_stream(**STREAM), "stream")
    log(f"stream: {len(msgs)} messages, "
        f"{sum(m.action == 200 for m in msgs)} PAYOUT barriers")
    wbatches = wire_batches(WireBatch, wb, cfg.batch)
    B = cfg.batch
    chunks = route_chunks(SQ, SeqRouter, cfg, msgs)
    first_trade = trade_chunk(SQ, chunks)
    last = len(chunks) - 1
    pays = [i for i, c in enumerate(chunks)
            if ((c["act"] == SQ.L_PAYOUT_YES)
                | (c["act"] == SQ.L_PAYOUT_NO)).any()]
    if not pays:
        fail("the stream holds no PAYOUT")
    # a PAYOUT batch of its own when the first-trades batch holds one too
    pay = next((i for i in pays if i not in (first_trade, last)), pays[0])
    checks = sorted({first_trade, pay, last})
    state, max_err, plain_ms, _ = check_batches(SQ, cfg, chunks, checks, "B1")
    log(f"checked batches {checks}: first with trades {first_trade}, "
        f"with a PAYOUT {pay}, last {last}")

    # margin rejects at full width: 512 accounts with 5000 each, so the
    # margin check turns orders away while others still trade
    low = zipf_symbol_stream(4000, num_symbols=1024, num_accounts=512,
                             seed=1, deposit=5000)
    lrouter = SeqRouter(cfg.lanes, cfg.accounts)
    lstate = SQ.make_seq_state(cfg)
    pres, outs, lchunks = [], [], []
    for lo in range(0, len(low), B):
        cols, _ = lrouter.route(low[lo:lo + B])
        lchunks.append(SQ.pack_msgs(cfg, cols, len(cols["act"])))
        pres.append(SQ.state_to_numpy(lstate))
        dm = SQ.msgs_to_device(lchunks[-1], "cuda")
        outs.append(SQ.seq_step(cfg, lstate, dm))
    torch.cuda.synchronize()
    risk = [int(o[0, 2 + MET_REJ_RISK]) for o in outs]
    i = max(range(len(outs)), key=lambda j: (risk[j] > 0
                                             and int(outs[j][0, 1]) > 0,
                                             risk[j]))
    if risk[i] == 0 or int(outs[i][0, 1]) == 0:
        fail(f"low-deposit stream: no batch with both margin rejects and "
             f"fills (rejects per batch {risk})")
    ref_state = SQ.state_from_numpy(cfg, pres[i], "cpu")
    ref_out = SQ.seq_step(cfg, ref_state, SQ.msgs_to_device(lchunks[i], "cpu"))
    post = SQ.state_from_numpy(cfg, pres[i + 1], "cpu") if i + 1 < len(pres) \
        else lstate
    err, bad = planes_equal(SQ, cfg, post, ref_state, outs[i], ref_out)
    max_err = max(max_err, err)
    if bad:
        fail(f"low-deposit batch {i}: kernel != plain version in {bad} "
             f"(max abs err {err})")
    if int(lstate["err"][0, 0]) != 0:
        fail(f"sticky error {int(lstate['err'][0, 0])} in the low-deposit run")
    log(f"low-deposit batch {i}: {int((lchunks[i]['act'] != 0).sum())} "
        f"messages, {risk[i]} margin rejects, fill_total "
        f"{int(outs[i][0, 1])}, kernel == plain version bit for bit")
    del lstate, outs, pres

    # ---- 4. B1 main path: the stream end to end through the session
    ses = SeqSession(cfg)
    b1_prefix = []      # phase 16c's reference
    b1_lines, b1_sha, wall, launches = main_path(SQ, ses, msgs, "B1",
                                                 keep=b1_prefix)
    met = b1_met = ses.metrics()
    canon = SQ.export_canonical(cfg, ses.state)
    if int(canon["err"]) != 0:
        fail(f"sticky error {int(canon['err'])} after the stream")
    neg = int((canon["bal"][canon["bal_used"]] < 0).sum())
    if neg:
        fail(f"{neg} negative balances after the stream")
    if not torch.equal(ses.state["bal_lo"], state["bal_lo"]):
        fail("session run and chunked check run disagree on balances")
    log(f"fills {met['fills']}, accepted trades {met['trades_ok']}, "
        f"capacity rejects {met['rej_capacity']}, risk rejects "
        f"{met['rej_risk']}, barriers {met['barriers']}, open orders "
        f"{met['open_orders']}, positions {met['positions']}")
    cap_128 = met["rej_capacity"]
    del ses, state
    if (b1_lines, b1_sha) != B1_MATCHOUT:
        fail(f"B1: MatchOut {b1_lines} lines sha256 {b1_sha}; earlier runs "
             f"gave {B1_MATCHOUT}")
    native_paths(SQ, SS, cfg, wbatches, (b1_lines, b1_sha), "B1")
    kern_ms, bound_ms = timed_replay(SQ, cfg, chunks, len(msgs), wall, card,
                                     "B1")
    kernels.append(kernel_entry("seq_step", "kme_tpu/engine/seq.py:1549",
                                launches["fixed"], max_err, kern_ms,
                                plain_ms, bound_ms))
    zipf = msgs

    # ---- 3b. B3: deep books (8192 slots) on the same stream
    cfg = SQ.SeqConfig(**DEEP)
    chunks = route_chunks(SQ, SeqRouter, cfg, msgs)
    rows_errs = []
    state, max_err, plain_ms, _ = check_batches(
        SQ, cfg, chunks, checks, "B3",
        rows_checker(SQ, cfg, "B3", rows_errs, []))
    bal_lo = state["bal_lo"].clone()
    del state
    ses = SeqSession(cfg)
    b3_prefix = []      # phase 18's reference for service B
    b3_lines, b3_sha, wall, launches = main_path(SQ, ses, msgs, "B3",
                                                 keep=b3_prefix)
    met = ses.metrics()
    err = int(ses.state["err"][0, 0])
    if err != 0:
        fail(f"B3: sticky error {err} after the stream")
    if not torch.equal(ses.state["bal_lo"], bal_lo):
        fail("B3: session run and chunked check run disagree on balances")
    log(f"B3 fills {met['fills']}, accepted trades {met['trades_ok']}, "
        f"capacity rejects {met['rej_capacity']} (at 128 slots, phase 4: "
        f"{cap_128}), risk rejects {met['rej_risk']}, barriers "
        f"{met['barriers']}, open orders {met['open_orders']}, positions "
        f"{met['positions']}, deepest side {met['max_book_depth']}, sticky "
        f"error {err}")
    del ses
    if (b3_lines, b3_sha) != DEEP_MATCHOUT:
        fail(f"B3: MatchOut {b3_lines} lines sha256 {b3_sha}; earlier runs "
             f"gave {DEEP_MATCHOUT}")
    native_paths(SQ, SS, cfg, wbatches, (b3_lines, b3_sha), "B3")
    kern_ms, bound_ms = timed_replay(SQ, cfg, chunks, len(msgs), wall, card,
                                     "B3")
    kernels.append(kernel_entry("seq_step_deep", "kme_tpu/engine/seq.py:1549",
                                launches["fixed"], max_err, kern_ms,
                                plain_ms, bound_ms))
    rows_launches = launches["rows_in_use"]

    # ---- 3c. B2 with B3: java mode at 8192 slots, the java zipf stream
    cfg = SQ.SeqConfig(**JAVA)
    msgs, wb = parse_both(parse_order, dumps_order, WireBatch,
                          zipf_symbol_stream(**JAVA_STREAM), "java stream")
    java_msgs = msgs
    chunks = route_chunks(SQ, SeqRouter, cfg, msgs)
    first_trade = trade_chunk(SQ, chunks)
    checks = sorted({first_trade, len(chunks) // 2, len(chunks) - 1})
    state, max_err, plain_ms, outs = check_batches(
        SQ, cfg, chunks, checks, "B2",
        rows_checker(SQ, cfg, "B2", rows_errs, []))
    ghosts = int((SQ.unpack_out(cfg, outs[first_trade].numpy(), cfg.batch)
                  ["fills"][3] == 0).sum())
    if ghosts == 0:
        fail(f"B2: the first batch with trades ({first_trade}) holds no Q2 "
             f"ghost fill")
    log(f"B2 checked batches {checks}: the first with trades holds {ghosts} "
        f"zero-size Q2 ghost fills")
    del state, outs
    ses = SeqSession(cfg)
    nlines, sha, wall, launches = main_path(SQ, ses, msgs, "B2")
    if (nlines, sha) != (JAVA_LINES, JAVA_SHA256):
        fail(f"B2: MatchOut {nlines} lines sha256 {sha}; the java oracle "
             f"gives {JAVA_LINES} lines sha256 {JAVA_SHA256}")
    j = SQ.export_java(cfg, ses.state)
    open_orders = int((j["slot_size"] > 0).sum())
    npos = len(j["positions"])
    if int(j["err"]) != 0:
        fail(f"B2: sticky error {int(j['err'])} after the stream")
    if (open_orders, npos) != (JAVA_OPEN_ORDERS, JAVA_POSITIONS):
        fail(f"B2: {open_orders} open orders and {npos} positions at the "
             f"end; the java oracle has {JAVA_OPEN_ORDERS} and "
             f"{JAVA_POSITIONS}")
    log(f"B2 MatchOut == the java oracle's ({JAVA_LINES} lines, sha256 "
        f"{JAVA_SHA256}); {open_orders} open orders, {npos} positions (real "
        f"and Q11 keys), sticky error 0")
    del ses, j
    native_paths(SQ, SS, cfg, wire_batches(WireBatch, wb, cfg.batch),
                 (JAVA_LINES, JAVA_SHA256), "B2")
    kern_ms, bound_ms = timed_replay(SQ, cfg, chunks, len(msgs), wall, card,
                                     "B2")
    kernels.append(kernel_entry("seq_step_java", "kme_tpu/engine/seq.py:1549",
                                launches["java"], max_err, kern_ms, plain_ms,
                                bound_ms))

    # ---- 3d. a deep book, and the rows-in-use kernel alone
    entry = deep_book_phase(SQ, SeqRouter, deep_book_stream, card,
                            rows_errs)
    kernels.append(dict(entry, launches=rows_launches))

    # ---- 6. B4/B5 vs plain; 6b. lanes windows vs plain; 7. lanes main
    # path; 8. B4/B5 timed
    rd_err = check_rowdma(rowdma)
    launches = lanes_path(L, LS, rowdma, zipf, (b1_lines, b1_sha, b1_met))
    kernels.extend(time_rowdma(rowdma, rd_err, launches, card))

    # ---- 10. serving: the service over TCP, checkpoints, the CLI
    unobserved = serving_phase(SQ, rowdma, zipf, java_msgs,
                               (b1_lines, b1_sha), card)

    # ---- 11. the seq fleet and the sharded lanes engine; the fleet's
    # launches of B1 join the main path's
    t = time.perf_counter()
    fleet_launches, fleet_err = fleet_phase(
        SQ, SS, SM, L, LS, rowdma, zipf, wbatches, WireBatch,
        zipf_hot_stream, card)
    b1_entry = kernels[0]
    b1_entry["launches"] += fleet_launches
    b1_entry["max_abs_err"] = max(b1_entry["max_abs_err"], fleet_err)
    log(f"phase 11 took {time.perf_counter() - t:.1f} s; B1 launches on "
        f"the main paths: {b1_entry['launches']} ({fleet_launches} by the "
        f"fleet)")

    # ---- 12. the service's observability; its launches join the main
    # paths'
    t = time.perf_counter()
    b1_obs, b4_obs, b5_obs = observed_phase(
        SQ, rowdma, zipf, (b1_lines, b1_sha), card, unobserved)
    b1_entry["launches"] += b1_obs
    for e in kernels:
        if e["name"] == "rowdma_gather":
            e["launches"] += b4_obs
        elif e["name"] == "rowdma_scatter":
            e["launches"] += b5_obs
    log(f"phase 12 took {time.perf_counter() - t:.1f} s; launches by it: "
        f"B1 {b1_obs}, B4 {b4_obs}, B5 {b5_obs}")

    # ---- 13. the multi-leader front and the feed; its launches of B1
    # join the main paths'
    t = time.perf_counter()
    b1_front = front_phase(SQ, java_msgs)
    b1_entry["launches"] += b1_front
    log(f"phase 13 took {time.perf_counter() - t:.1f} s; B1 launches by "
        f"it: {b1_front}")

    # ---- 14. the failover drills; 14a's launches of B1 join the main
    # paths'
    t = time.perf_counter()
    values = [dumps_order(m) for m in zipf]
    b1_failover = failover_phase(SQ, values, (b1_lines, b1_sha), card)
    b1_entry["launches"] += b1_failover
    log(f"phase 14 took {time.perf_counter() - t:.1f} s; B1 launches by "
        f"14a: {b1_failover}")

    # ---- 15. the chaos drills: `kme-torch-chaos` against children that
    # run B1 on the card (their launches are not counted in this process)
    t = time.perf_counter()
    walls = chaos_phase(card)
    log(f"phase 15 took {time.perf_counter() - t:.1f} s ({walls})")

    # ---- 16. the other failover drills (their children's launches are
    # not counted here), the Kafka transport (its launches of B1 join the
    # main paths') and the host-only tools
    t = time.perf_counter()
    walls = failover_drills_phase(card)
    b1_kafka = kafka_phase(SQ, values, b1_prefix, card)
    b1_entry["launches"] += b1_kafka
    host_tools_phase([dumps_order(m) for m in java_msgs])
    log(f"phase 16 took {time.perf_counter() - t:.1f} s ({walls}); B1 "
        f"launches by 16c: {b1_kafka}")

    # ---- 17. the serial parity replica on the card, against the oracles
    # and B2's lines; the lint gate
    parity_phase(card, small_java_lines)

    # ---- 18. perfgate over the card's own TSDB stores and artifacts; its
    # launches of B1, B3 and the rows-in-use kernel join the main paths'
    pg_b1, pg_b3, pg_rows = perfgate_phase(
        SQ, values[:PERFGATE_PREFIX], b1_prefix, b3_prefix, card)
    for e in kernels:
        e["launches"] += {"seq_step": pg_b1, "seq_step_deep": pg_b3,
                          "seq_rows_in_use": pg_rows}.get(e["name"], 0)
    log(f"phase 18: launches by it: B1 {pg_b1}, B3 {pg_b3}, rows-in-use "
        f"{pg_rows}")

    # ---- 19. the benchmark's seq suite and its gate; its launches of B1
    # join the main paths'
    b1_entry["launches"] += bench_phase(SQ, card)

    # ---- 20. summary
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
