"""The port's seq_step kernel module against the JAX package's kernel.

The same seeded message columns go through `kme_tpu.engine.seq`'s Pallas
kernel (interpret mode on JAX CPU, as tests/test_seq_engine.py runs it)
and through `kme_tpu_torch.engine.seq.seq_step` on CPU tensors (its plain
PyTorch version). Every value is an integer, so the tolerance is exact
equality: all 18 state planes, the header rows and the used fill prefix.
The CUDA kernel against its plain version is tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from kme_tpu.engine import seq as JSQ
from kme_tpu_torch.engine import seq as SQ

torch.set_num_threads(1)

KW = dict(lanes=8, slots=128, accounts=128, max_fills=32, batch=128,
          pos_cap=1 << 11, fill_cap=1 << 12, probe_max=16)


def _columns(rng, cfg_kw, batches):
    """Seeded lane-level message columns, one (B,) dict per batch: a
    CREATE/TRANSFER/ADD_SYMBOL preamble, crossing trades (some invalid),
    cancels of live and dead oids, transfers, and payout / remove
    barriers with their re-adds."""
    B, S, A = cfg_kw["batch"], cfg_kw["lanes"], 40
    msgs = []
    for a in range(A):
        msgs.append((SQ.L_CREATE, 0, a, 0, 0, 0))
        msgs.append((SQ.L_TRANSFER, 0, a, 0, int(rng.integers(10**4, 10**6)), 0))
    for s in range(S - 2):
        msgs.append((SQ.L_ADD_SYMBOL, 0, 0, 0, 0, s))
    oids = []
    k = 0
    while len(msgs) < B * batches - 4:
        k += 1
        r = rng.random()
        lane = int(min(rng.zipf(1.5) - 1, S - 1))
        if r < 0.70:
            act = SQ.L_BUY if rng.random() < 0.5 else SQ.L_SELL
            price = int(rng.integers(35, 66))
            size = int(rng.integers(1, 25))
            if rng.random() < 0.03:
                price = int(rng.choice([-1, 126, 2**31 - 1]))
            if rng.random() < 0.02:
                size = int(rng.choice([0, -5]))
            oid = int(rng.integers(-2**62, 2**62))
            acc = int(rng.integers(0, A))
            oids.append((oid, lane, acc))
            msgs.append((act, oid, acc, price, size, lane))
        elif r < 0.90 and oids:
            oid, ol, acc = oids[int(rng.integers(0, len(oids)))]
            if rng.random() < 0.2:   # someone else's order: refused
                acc = int(rng.integers(0, A))
            msgs.append((SQ.L_CANCEL, oid, acc, 0, 0, ol))
        elif r < 0.95:
            msgs.append((SQ.L_TRANSFER, 0, int(rng.integers(0, A)), 0,
                         int(rng.integers(-3 * 10**5, 10**5)), 0))
        elif k % 3 == 0:
            act = int(rng.choice([SQ.L_PAYOUT_YES, SQ.L_PAYOUT_NO,
                                  SQ.L_REMOVE_SYMBOL]))
            msgs.append((act, 0, 0, 0, 97, lane))
            msgs.append((SQ.L_ADD_SYMBOL, 0, 0, 0, 0, lane))
    out = []
    for b in range(batches):
        part = msgs[b * B:(b + 1) * B]
        cols = {f: np.array([m[i] for m in part], np.int64)
                for i, f in enumerate(("act", "oid", "aid", "price", "size",
                                       "lane"))}
        out.append((cols, len(part)))
    return out


def _used(cfg, plane):
    """The defined part of an output plane: the header rows and, per fill
    field, the fill_total entries written (the JAX kernel leaves the rest
    of the last fill group uninitialised)."""
    HR, ft = SQ.hdr_rows(cfg), int(plane[0, 1])
    groups = plane[HR:HR + 5 * (-(-ft // 128))].reshape(-1, 5, 128)
    fills = groups.transpose(1, 0, 2).reshape(5, -1)[:, :ft]
    return np.concatenate([plane[:HR].reshape(-1), fills.reshape(-1)])


def _run_both(cfg_kw, batches):
    jcfg, cfg = JSQ.SeqConfig(**cfg_kw), SQ.SeqConfig(**cfg_kw)
    jstep = JSQ.build_seq_step(jcfg)[0]
    jstate = JSQ.make_seq_state(jcfg)
    state = SQ.make_seq_state(cfg, "cpu")
    results = []
    for cols, n in batches:
        jmsgs = JSQ.pack_msgs(jcfg, cols, n)
        msgs = SQ.pack_msgs(cfg, cols, n)
        for f in SQ.MSG_FIELDS:
            assert np.array_equal(jmsgs[f], msgs[f]), f
        jstate, jout = jstep(jstate, jmsgs)
        out = SQ.seq_step(cfg, state, SQ.msgs_to_device(msgs, "cpu"))
        jout, out = np.asarray(jout), out.numpy()
        for k in SQ.state_keys(cfg):
            assert np.array_equal(np.asarray(jstate[k]), state[k].numpy()), k
        assert jout.shape == out.shape
        assert np.array_equal(_used(cfg, jout), _used(cfg, out))
        results.append(SQ.unpack_out(cfg, out, n))
    return results, state


@pytest.mark.parametrize("seed", [0, 1])
def test_seq_step_matches_jax_kernel(seed):
    """Three consecutive batches with preamble, crossing trades, invalid
    trades, cancels, transfers and barriers: planes equal after each."""
    rng = np.random.default_rng(seed)
    res, state = _run_both(KW, _columns(rng, KW, 3))
    met = np.sum([r["metrics"] for r in res], axis=0)
    assert met[SQ.METRIC_NAMES.index("fills")] > 0
    assert met[SQ.METRIC_NAMES.index("barriers")] > 0
    assert met[SQ.METRIC_NAMES.index("cancels_ok")] > 0
    assert met[SQ.METRIC_NAMES.index("rej_risk")] > 0
    assert int(state["err"][0, 0]) == SQ.LERR_OK


def test_seq_step_hash_full_sticky_error():
    """probe_max=1 over a one-tile hash: the HASH_FULL error is sticky
    and both kernels leave the same planes behind it."""
    kw = dict(KW, pos_cap=128, probe_max=1, max_fills=8)
    msgs = [(SQ.L_CREATE, 0, a, 0, 0, 0) for a in range(33)]
    msgs += [(SQ.L_TRANSFER, 0, a, 0, 10**9, 0) for a in range(33)]
    msgs += [(SQ.L_ADD_SYMBOL, 0, 0, 0, 0, s) for s in range(6)]
    oid = 1000
    for s in range(6):   # ~200 distinct (lane, account) positions
        for a in range(32):
            msgs.append((SQ.L_SELL, oid, a, 50, 1, s))
            msgs.append((SQ.L_BUY, oid + 1, a + 1, 55, 1, s))
            oid += 2
    B = kw["batch"]
    batches = []
    for lo in range(0, len(msgs), B):
        part = msgs[lo:lo + B]
        batches.append(({f: np.array([m[i] for m in part], np.int64)
                         for i, f in enumerate(("act", "oid", "aid", "price",
                                                "size", "lane"))}, len(part)))
    res, state = _run_both(kw, batches)
    assert res[-1]["err"] == SQ.LERR_HASH_FULL
    assert int(state["err"][0, 0]) == SQ.LERR_HASH_FULL


def test_seq_step_fillbuf_full_sticky_error():
    """More fills in one call than fill_cap holds: FILLBUF_FULL, with the
    fills beyond the buffer dropped identically."""
    kw = dict(KW, fill_cap=128, batch=256)
    msgs = [(SQ.L_CREATE, 0, a, 0, 0, 0) for a in (1, 2)]
    msgs += [(SQ.L_TRANSFER, 0, a, 0, 10**8, 0) for a in (1, 2)]
    msgs += [(SQ.L_ADD_SYMBOL, 0, 0, 0, 0, s) for s in (0, 1)]
    oid = 1000
    for s in (0, 1):
        for _ in range(80):
            msgs.append((SQ.L_SELL, oid, 1, 50, 1, s))
            oid += 1
    for s in (0, 1):
        for _ in range(3):
            msgs.append((SQ.L_BUY, oid, 2, 55, 30, s))
            oid += 1
    cols = {f: np.array([m[i] for m in msgs], np.int64)
            for i, f in enumerate(("act", "oid", "aid", "price", "size",
                                   "lane"))}
    res, state = _run_both(kw, [(cols, len(msgs))])
    assert res[0]["fill_total"] > 128
    assert res[0]["err"] == SQ.LERR_FILLBUF_FULL


def test_seq_scan_threads_chunks_like_single_steps():
    """seq_scan over K stacked chunks == K seq_step calls in order."""
    cfg = SQ.SeqConfig(**KW)
    batches = _columns(np.random.default_rng(5), KW, 3)
    a, b = SQ.make_seq_state(cfg, "cpu"), SQ.make_seq_state(cfg, "cpu")
    packed = [SQ.pack_msgs(cfg, c, n) for c, n in batches]
    stacked = {f: torch.from_numpy(np.stack([p[f] for p in packed]))
               for f in SQ.MSG_FIELDS}
    outs = SQ.seq_scan(cfg, a, stacked)
    for k, p in enumerate(packed):
        o = SQ.seq_step(cfg, b, SQ.msgs_to_device(p, "cpu"))
        assert torch.equal(outs[k], o)
    for k in SQ.state_keys(cfg):
        assert torch.equal(a[k], b[k]), k


def test_seq_scan_checks_its_inputs():
    cfg = SQ.SeqConfig(**KW)
    state = SQ.make_seq_state(cfg, "cpu")
    msgs = SQ.msgs_to_device(SQ.pack_msgs(cfg, {
        f: np.zeros(0, np.int64) for f in ("act", "oid", "aid", "price",
                                           "size", "lane")}, 0), "cpu")
    bad = dict(msgs, act=msgs["act"].to(torch.int64))
    with pytest.raises(ValueError, match="act"):
        SQ.seq_step(cfg, state, bad)
    with pytest.raises(ValueError, match="bs"):
        SQ.seq_step(cfg, dict(state, bs=state["bs"][:1]), msgs)
    meta = {f: torch.empty(cfg.batch, dtype=torch.int32, device="meta")
            for f in SQ.MSG_FIELDS}
    with pytest.raises(ValueError):
        SQ.seq_step(cfg, {k: v.to("meta") for k, v in state.items()}, meta)

