"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the whole run (one card)

Drives the port's main path — wire JSON -> SeqSession.process_wire ->
the seq_step CUDA kernel -> MatchOut lines — at the width of the
`kme-serve` defaults (1024 symbols, 4096 accounts, 128 slots, 16 max
fills, 1024-message batches), and holds the kernel bit for bit against
its plain PyTorch version. Phases, in order; any failure exits non-zero:

1. card and build: the card's name and power limit, a fresh build of
   the kernel, its source's sha256 and its ptxas report;
2. small: a small stream through a session on the card and one on the
   CPU (plain version) must give the same MatchOut lines and planes;
3. kernel vs plain at full width: three batches of the zipf stream (the
   first with trades, one with a PAYOUT, the last) must leave
   bit-identical state planes, header rows and used fill prefix; so
   must one full-width batch of a low-deposit stream, where the margin
   check rejects orders;
4. the stream end to end through process_wire, with the kernel's launch
   count held to the dispatch count, then a timed replay of the same
   dispatches (CUDA events) with each dispatch's byte bound;
5. summary: one `kernels` JSON line, then the device line last.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

FULL = dict(lanes=1024, slots=128, accounts=4096, max_fills=16, batch=1024,
            pos_cap=1 << 17, fill_cap=1 << 15, probe_max=64)
SMALL = dict(lanes=16, slots=128, accounts=256, max_fills=16, batch=256,
             pos_cap=1 << 12, fill_cap=1 << 12, probe_max=8)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
ROW_BYTES = 128 * 4


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


def batch_bytes(SQ, cfg, cols: dict, out, pre: dict, post: dict,
                barriers: int) -> int:
    """Least bytes one dispatch must move, counted from this batch: its
    message columns read once; each state row its messages must read,
    once per plane (the book blocks of book-touching messages, the
    lane rows, the balance rows of takers, makers and credited accounts,
    the hash rows at the home tiles of the takers' and makers' position
    keys, and for an executed PAYOUT the whole key plane plus the amount
    rows where the lane's keys sit, from the pre-batch hash); each state
    row it changed, written once; the output's used rows."""
    import numpy as np

    B, NR, A = cfg.batch, cfg.nr, cfg.accounts
    act, lane, aid = cols["act"], cols["lane"], cols["aid"]
    res = SQ.unpack_out(cfg, out.cpu().numpy(), B)
    f_aid = res["fills"][1].astype(np.int64)
    f_lane = np.repeat(lane.astype(np.int64), res["nfill"])
    dev = act != SQ.L_NOP
    read = {}
    book = np.isin(act, [SQ.L_BUY, SQ.L_SELL, SQ.L_CANCEL, SQ.L_PAYOUT_YES,
                         SQ.L_PAYOUT_NO, SQ.L_REMOVE_SYMBOL])
    blk = (lane[book].astype(np.int64)[:, None] * 2 * NR
           + np.arange(2 * NR)).ravel()
    for k in ("bo_lo", "bo_hi", "ba", "bp", "bs", "bq"):
        read[k] = [blk]
    for k in ("seqc", "bex", "dep"):
        read[k] = [lane[dev] >> 7]
    accs = [aid[dev].astype(np.int64), f_aid]
    trade = np.isin(act, [SQ.L_BUY, SQ.L_SELL, SQ.L_CANCEL])
    keys = np.concatenate([lane[trade].astype(np.int64) * A + aid[trade] + 1,
                           f_lane * A + f_aid + 1])
    h = ((keys * -1640531527) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    tiles = (h >> 7) & (cfg.caprows - 1)
    for k in ("hk", "ha_lo", "ha_hi", "hv_lo", "hv_hi"):
        read[k] = [tiles]
    pays = np.flatnonzero(np.isin(act, [SQ.L_PAYOUT_YES, SQ.L_PAYOUT_NO]))
    if barriers and len(pays):
        hk = pre["hk"].cpu().numpy()
        read["hk"].append(np.arange(cfg.caprows))
        for i in pays[act[pays] == SQ.L_PAYOUT_YES]:
            klo = int(lane[i]) * A + 1
            mine = (hk >= klo) & (hk < klo + A)
            r = np.flatnonzero(mine.any(axis=1))
            read["ha_lo"].append(r)
            read["ha_hi"].append(r)
            accs.append(hk[mine].astype(np.int64) - klo)
    acc_rows = np.concatenate(accs) >> 7
    for k in ("bal_lo", "bal_hi", "bal_u"):
        read[k] = [acc_rows]
    nread = sum(len(np.unique(np.concatenate(v))) for v in read.values())
    changed = sum(int((pre[k] != post[k]).any(dim=1).sum())
                  for k in SQ.state_keys(cfg))
    ft = int(out[0, 1])
    return (7 * 4 * B + (nread + changed) * ROW_BYTES
            + SQ.used_rows(cfg, ft) * ROW_BYTES)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one card")
    try:
        from kme_tpu_torch import native
        from kme_tpu_torch.engine import seq as SQ
        from kme_tpu_torch.engine.lanes import MET_BARRIERS, MET_REJ_RISK
        from kme_tpu_torch.runtime.seqsession import SeqRouter, SeqSession
        from kme_tpu_torch.wire import dumps_order, parse_order
        from kme_tpu_torch.workload import zipf_symbol_stream
    except ImportError as e:
        fail(f"the port's package is not importable here ({e}); run from "
             f"the root of a checkout")
    if "jax" in sys.modules or any(m == "kme_tpu" or m.startswith("kme_tpu.")
                                   for m in sys.modules):
        fail("the port imported JAX or the JAX package")

    # ---- 1. card and build
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t = time.perf_counter()
    native.build("seq_step", fresh=True)
    log(f"built seq_step in {time.perf_counter() - t:.1f} s from "
        f"csrc/seq_step.cu sha256 {native.source_sha256('seq_step')}; ptxas:")
    log(native.build_logs.get("seq_step", ""))

    # ---- 2. small: card session vs CPU session
    cfg_s = SQ.SeqConfig(**SMALL)
    msgs = zipf_symbol_stream(3000, num_symbols=12, num_accounts=200, seed=5,
                              payout_per_mille=6)
    gpu, cpu = SeqSession(cfg_s), SeqSession(cfg_s, device="cpu")
    for lo in range(0, len(msgs), 700):
        part = msgs[lo:lo + 700]
        if gpu.process_wire(part) != cpu.process_wire(part):
            fail(f"small stream: MatchOut differs in messages {lo}..")
    torch.cuda.synchronize()
    for k in SQ.state_keys(cfg_s):
        if not torch.equal(gpu.state[k].cpu(), cpu.state[k]):
            fail(f"small stream: state plane {k} differs")
    log(f"small: {len(msgs)} messages, card == plain version "
        f"(MatchOut lines and all state planes)")

    # ---- 3. kernel vs plain version at full width
    cfg = SQ.SeqConfig(**FULL)
    t = time.perf_counter()
    msgs = zipf_symbol_stream(100_000, num_symbols=1024, num_accounts=4096,
                              seed=0, payout_per_mille=2)
    wire = [dumps_order(m) for m in msgs]
    msgs = [parse_order(w) for w in wire]
    log(f"stream: {len(msgs)} messages, "
        f"{sum(m.action == 200 for m in msgs)} PAYOUT barriers, parsed from "
        f"JSON in {time.perf_counter() - t:.1f} s")
    B = cfg.batch
    router = SeqRouter(cfg.lanes, cfg.accounts)
    chunks = []
    for lo in range(0, len(msgs), B):
        cols, _ = router.route(msgs[lo:lo + B])
        chunks.append(SQ.pack_msgs(cfg, cols, len(cols["act"])))
    first_trade = next(i for i, c in enumerate(chunks)
                       if ((c["act"] == SQ.L_BUY) | (c["act"] == SQ.L_SELL)).any())
    last = len(chunks) - 1
    pays = [i for i, c in enumerate(chunks)
            if ((c["act"] == SQ.L_PAYOUT_YES)
                | (c["act"] == SQ.L_PAYOUT_NO)).any()]
    if not pays:
        fail("the stream holds no PAYOUT")
    # a PAYOUT batch of its own when the first-trades batch holds one too
    pay = next((i for i in pays if i not in (first_trade, last)), pays[0])
    checks = sorted({first_trade, pay, last})
    state = SQ.make_seq_state(cfg)
    max_err, plain_ms = 0, []
    for i, c in enumerate(chunks):
        dm = SQ.msgs_to_device(c, "cuda")
        if i in checks:
            pre = SQ.state_to_numpy(state)
        out = SQ.seq_step(cfg, state, dm)
        if i in checks:
            torch.cuda.synchronize()
            ref_state = SQ.state_from_numpy(cfg, pre, "cpu")
            t = time.perf_counter()
            ref_out = SQ.seq_step(cfg, ref_state, SQ.msgs_to_device(c, "cpu"))
            plain_ms.append((time.perf_counter() - t) * 1e3)
            err, bad = planes_equal(SQ, cfg, state, ref_state, out, ref_out)
            max_err = max(max_err, err)
            if bad:
                fail(f"batch {i}: kernel != plain version in {bad} "
                     f"(max abs err {err})")
            log(f"batch {i}: {int((c['act'] != 0).sum())} messages, "
                f"fill_total {int(out[0, 1])}, kernel == plain version "
                f"bit for bit (18 planes, {SQ.hdr_rows(cfg)} header rows, "
                f"used fill prefix); plain version {plain_ms[-1]:.1f} ms "
                f"on the host CPU")
    torch.cuda.synchronize()
    if int(state["err"][0, 0]) != 0:
        fail(f"sticky error {int(state['err'][0, 0])} in the checked run")
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

    # ---- 4. the stream end to end through the session
    ses = SeqSession(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SQ.LAUNCHES["seq_step"] = 0
    hasher = hashlib.sha256()
    nlines = 0
    t = time.perf_counter()
    for lo in range(0, len(msgs), B):
        for lines in ses.process_wire(msgs[lo:lo + B]):
            for ln in lines:
                hasher.update(ln.encode())
                hasher.update(b"\n")
            nlines += len(lines)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = SQ.LAUNCHES["seq_step"]
    if launches != ses.dispatches or launches == 0:
        fail(f"launches {launches} != dispatches {ses.dispatches}")
    met = ses.metrics()
    canon = SQ.export_canonical(cfg, ses.state)
    if int(canon["err"]) != 0:
        fail(f"sticky error {int(canon['err'])} after the stream")
    neg = int((canon["bal"][canon["bal_used"]] < 0).sum())
    if neg:
        fail(f"{neg} negative balances after the stream")
    if not torch.equal(ses.state["bal_lo"], state["bal_lo"]):
        fail("session run and chunked check run disagree on balances")
    log(f"end to end: {len(msgs)} messages in {wall:.3f} s = "
        f"{len(msgs) / wall:.0f} msg/s (host clock, synchronized); "
        f"{ses.dispatches} dispatches, {launches} kernel launches")
    phases = dict(ses.phases, lines_s=wall - sum(ses.phases.values()))
    log("phases (s, host clock; fetch_s includes waiting for the kernel, "
        "lines_s is building the MatchOut lines): "
        + json.dumps({k: round(v, 4) for k, v in phases.items()}))
    log(f"fills {met['fills']}, accepted trades {met['trades_ok']}, "
        f"capacity rejects {met['rej_capacity']}, risk rejects "
        f"{met['rej_risk']}, barriers {met['barriers']}, open orders "
        f"{met['open_orders']}, positions {met['positions']}")
    log(f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    log(f"MatchOut: {nlines} lines, sha256 {hasher.hexdigest()}")

    # timed replay of the same dispatches: CUDA events around each launch
    state = SQ.make_seq_state(cfg)
    dev_chunks = [SQ.msgs_to_device(c, "cuda") for c in chunks]
    for c in dev_chunks[:3]:          # warm-up on a scratch state
        SQ.seq_step(cfg, SQ.make_seq_state(cfg), c)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in dev_chunks]
    bytes_per = []
    for (e0, e1), c, hc in zip(ev, dev_chunks, chunks):
        pre = {k: v.clone() for k, v in state.items()}
        e0.record()
        out = SQ.seq_step(cfg, state, c)
        e1.record()
        bytes_per.append(batch_bytes(SQ, cfg, hc, out, pre, state,
                                     int(out[0, 2 + MET_BARRIERS])))
    torch.cuda.synchronize()
    ms = [e0.elapsed_time(e1) for e0, e1 in ev]
    kern_ms = sum(ms) / len(ms)
    bound_ms = sum(bytes_per) / len(bytes_per) / HBM_BYTES_PER_S * 1e3
    log(f"kernel: {kern_ms:.4f} ms per {B}-message dispatch (mean of "
        f"{len(ms)}, min {min(ms):.4f}, max {max(ms):.4f}) = "
        f"{sum(ms) * 1e6 / len(msgs):.0f} ns/message; byte bound "
        f"{bound_ms:.6f} ms per dispatch ({sum(bytes_per) / len(ms):.0f} B "
        f"at 3.35 TB/s); card {card}")
    log(f"kernel time of the stream {sum(ms) / 1e3:.4f} s = "
        f"{sum(ms) / 1e3 / wall:.1%} of the end-to-end wall")

    # ---- 5. summary
    print(json.dumps({"kernels": [{
        "name": "seq_step", "route": "cuda",
        "source": "kme_tpu_torch/csrc/seq_step.cu",
        "replaces": "kme_tpu/engine/seq.py:1549",
        "launches": launches, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": sum(plain_ms) / len(plain_ms),
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
