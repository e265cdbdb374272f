"""The port's package boundary: what it imports, where it runs, and the
modules it copied from the JAX package.

- `import kme_tpu_torch` and every submodule succeed with `jax` and
  `kme_tpu` blocked, and no source of the port imports either;
- nothing falls back to the CPU quietly: without a card the default
  device raises; configurations no mode takes raise;
- the copied workload streams, wire codec, packing and canonical export
  equal the JAX package's.
"""

import ast
import dataclasses
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import kme_tpu.engine.seq as JSQ
import kme_tpu.wire as JW
import kme_tpu.workload as JWL
import kme_tpu_torch.wire as W
import kme_tpu_torch.workload as WL
from kme_tpu_torch.engine import lanes as L
from kme_tpu_torch.engine import seq as SQ
from kme_tpu_torch.runtime.seqsession import SeqSession
from kme_tpu_torch.runtime.session import LaneSession

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(lanes=8, slots=128, accounts=128, max_fills=32, batch=128,
           pos_cap=1 << 11, fill_cap=1 << 12, probe_max=16)

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "kme_tpu" \
                or name.startswith("kme_tpu."):
            raise ImportError(f"blocked: {name}")
        return None

sys.modules["jax"] = None
sys.meta_path.insert(0, Block())
import kme_tpu_torch
names = ["kme_tpu_torch"]
for m in pkgutil.walk_packages(kme_tpu_torch.__path__, "kme_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = [k for k in sys.modules if k == "kme_tpu" or k.startswith("kme_tpu.")]
assert not bad, bad
print(" ".join(sorted(names)))
"""


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "kme_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "serve_ab.py")


def test_port_imports_without_jax_or_kme_tpu():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    mods = set(r.stdout.split())
    for m in ("kme_tpu_torch.engine.seq", "kme_tpu_torch.runtime.seqsession",
              "kme_tpu_torch.wire", "kme_tpu_torch.workload",
              "kme_tpu_torch.native", "kme_tpu_torch.native.sched",
              "kme_tpu_torch.opcodes",
              "kme_tpu_torch.engine.lanes", "kme_tpu_torch.ops.rowdma",
              "kme_tpu_torch.runtime.session",
              "kme_tpu_torch.runtime.sequencer",
              "kme_tpu_torch.runtime.checkpoint",
              "kme_tpu_torch.runtime.javasnap", "kme_tpu_torch.faults",
              "kme_tpu_torch.parallel", "kme_tpu_torch.parallel.seqmesh",
              "kme_tpu_torch.parallel.mesh",
              "kme_tpu_torch.oracle", "kme_tpu_torch.oracle.engine",
              "kme_tpu_torch.oracle.javalong",
              "kme_tpu_torch.native.oracle", "kme_tpu_torch.telemetry",
              "kme_tpu_torch.telemetry.registry",
              "kme_tpu_torch.telemetry.trace", "kme_tpu_torch.bridge",
              "kme_tpu_torch.bridge.broker", "kme_tpu_torch.bridge.clock",
              "kme_tpu_torch.bridge.consume", "kme_tpu_torch.bridge.lease",
              "kme_tpu_torch.bridge.provision",
              "kme_tpu_torch.bridge.serve", "kme_tpu_torch.bridge.service",
              "kme_tpu_torch.bridge.tcp", "kme_tpu_torch.cli"):
        assert m in mods


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_source_imports_no_jax(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "kme_tpu"), \
                f"{path}:{node.lineno} imports {n}"


def test_no_silent_cpu_fallback():
    cfg = SQ.SeqConfig(**CFG)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        SeqSession(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SQ.make_seq_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SQ.import_canonical(cfg, SQ.export_canonical(
            cfg, SQ.make_seq_state(cfg, "cpu")))
    # the lanes engine: session, state and snapshot import
    lcfg = L.LaneConfig(lanes=8, slots=128, accounts=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        LaneSession(lcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LaneSession(lcfg, shards=2)
    # the seq fleet
    from kme_tpu_torch.parallel.seqmesh import SeqMeshSession

    with pytest.raises(RuntimeError, match="CUDA"):
        SeqMeshSession(cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        L.make_lane_state(lcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        L.import_canonical(lcfg, L.export_canonical(
            lcfg, L.make_lane_state(lcfg, "cpu"), 8), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        L.state_from_numpy(lcfg, L.state_to_numpy(
            L.make_lane_state(lcfg, "cpu")))


def test_unported_modes_raise():
    """Every mode of the seq kernel is ported now: java and deep-book
    configurations construct (with java's planes and columns), and what
    no mode takes still raises."""
    for compat in ("fixed", "java"):
        for hbm in (False, True):
            cfg = SQ.SeqConfig(**CFG, compat=compat, hbm_books=hbm)
            state = SQ.make_seq_state(cfg, "cpu")
            assert tuple(state) == SQ.state_keys(cfg)
            assert len(state) == (25 if compat == "java" else 18)
            assert len(SQ.msg_fields(cfg)) == (12 if compat == "java" else 7)
    with pytest.raises(ValueError, match="compat"):
        SQ.SeqConfig(**CFG, compat="python")
    with pytest.raises(ValueError):
        SQ.SeqConfig(**dict(CFG, slots=100))
    with pytest.raises(ValueError, match="offsets"):
        SQ.SeqConfig(**dict(CFG, lanes=1 << 17, accounts=128,
                            slots=1 << 14))


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0 and '"ok"' not in r.stdout


@pytest.mark.parametrize("kind", ["zipf", "zipf_payout", "harness",
                                  "harness_valid", "zipf_hot",
                                  "payout_storm"])
def test_copied_workload_streams_equal(kind):
    if kind in ("zipf_hot", "payout_storm"):
        name = f"{kind}_stream"
        kw = dict(num_symbols=9, num_accounts=30, seed=4)
        a = getattr(JWL, name)(800, **kw)
        b = getattr(WL, name)(800, **kw)
    elif kind.startswith("zipf"):
        kw = dict(num_symbols=9, num_accounts=30, seed=4,
                  payout_per_mille=5 if kind == "zipf_payout" else 0)
        a = JWL.zipf_symbol_stream(800, **kw)
        b = WL.zipf_symbol_stream(800, **kw)
    else:
        kw = dict(seed=6, validate=kind == "harness_valid",
                  payout_opcode_bug=kind == "harness")
        a = JWL.harness_stream(800, **kw)
        b = WL.harness_stream(800, **kw)
    assert [dataclasses.astuple(m) for m in a] == \
        [dataclasses.astuple(m) for m in b]


def test_copied_wire_codec_agrees_on_fuzz():
    rng = random.Random(12)
    vals = [0, 1, -1, 2**31 - 1, -2**31, 2**53, -2**63, 2**63 - 1, 2**70]
    for _ in range(400):
        fields = {f: rng.choice(vals + [rng.randint(-10**6, 10**6)])
                  for f in ("action", "oid", "aid", "sid", "price", "size")}
        nxt = rng.choice([None, rng.randint(0, 2**60)])
        prv = rng.choice([None, -5, rng.randint(0, 2**60)])
        s = W.order_json(*fields.values(), nxt, prv)
        assert s == JW.order_json(*fields.values(), nxt, prv)
        drop = rng.choice([None, "price", "next", "prev"])
        text = s.replace(f'"{drop}":', f'"x{drop}":') if drop else s
        assert dataclasses.astuple(W.parse_order(text)) == \
            dataclasses.astuple(JW.parse_order(text))
        m = W.parse_order(text.encode())
        assert W.dumps_order(m) == JW.dumps_order(JW.parse_order(text))
    for bad in (b"[1]", b'{"price": "x"}', b'{"size": 1.5}'):
        with pytest.raises(ValueError):
            W.parse_order(bad)
        with pytest.raises(ValueError):
            JW.parse_order(bad)
    assert W.REJ_NAMES == JW.REJ_NAMES


def test_pack_unpack_and_reason_codes_equal():
    rng = np.random.default_rng(2)
    jcfg, cfg = JSQ.SeqConfig(**CFG), SQ.SeqConfig(**CFG)
    n = 100
    cols = {"act": rng.integers(0, 10, n), "aid": rng.integers(0, 128, n),
            "price": rng.integers(-5, 130, n), "size": rng.integers(-9, 99, n),
            "lane": rng.integers(0, 8, n),
            "oid": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)}
    a, b = JSQ.pack_msgs(jcfg, cols, n), SQ.pack_msgs(cfg, cols, n)
    for f in SQ.MSG_FIELDS:
        assert np.array_equal(a[f], b[f]) and b[f].dtype == np.int32
    plane = rng.integers(-2**31, 2**31, (SQ.out_rows(cfg), 128),
                         dtype=np.int64).astype(np.int32)
    plane[0, 1] = 300
    ja, pa = JSQ.unpack_out(jcfg, plane, n), SQ.unpack_out(cfg, plane, n)
    assert ja.keys() == pa.keys()
    for k in ja:
        assert np.array_equal(np.asarray(ja[k]), np.asarray(pa[k])), k
    ok, cap = rng.random(n) < 0.5, rng.random(n) < 0.1
    mi = np.sort(rng.choice(150, n, replace=False))
    rej = set(range(150)) - set(mi.tolist())
    assert np.array_equal(
        W.reject_reason_codes(150, mi, cols["act"], ok, cap, rej),
        JW.reject_reason_codes(150, mi, cols["act"], ok, cap, rej))
