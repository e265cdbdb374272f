// Native host-runtime core: the conflict-free scheduler hot loop.
//
// The reference's runtime substrate is native third-party code behind the
// JVM (RocksDB JNI, Kafka clients — SURVEY.md §2.4); here the host
// runtime's hot loop — planning wire messages into conflict-free
// (segment, step, lane, slot) coordinates (kme_tpu/runtime/sequencer.py,
// the semantics authority) — has a C++ implementation bound over a C ABI
// with ctypes. Behavior must match the Python scheduler EXACTLY
// (tests/test_native_sched.py compares full plans field by field); the
// Python implementation remains the fallback when no toolchain exists.
//
// Build: g++ -O3 -shared -fPIC kme_host.cpp -o kme_host.so
// (driven by kme_tpu/native/__init__.py, cached by source hash).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// lane opcodes — must match kme_tpu/engine/lanes.py
constexpr int32_t L_BUY = 1, L_SELL = 2, L_CANCEL = 3, L_CREATE = 4,
                  L_TRANSFER = 5, L_ADD_SYMBOL = 6;
// wire opcodes — must match kme_tpu/opcodes.py
constexpr int64_t OP_ADD_SYMBOL = 0, OP_REMOVE_SYMBOL = 1, OP_BUY = 2,
                  OP_SELL = 3, OP_CANCEL = 4, OP_CREATE_BALANCE = 100,
                  OP_TRANSFER = 101, OP_PAYOUT = 200;

constexpr int32_t ST_OK = 0, ST_CAP_ACCOUNTS = 1, ST_CAP_SYMBOLS = 2;

struct Sched {
  int32_t S, A, width;
  std::unordered_map<int64_t, int32_t> aid_idx;
  std::unordered_map<int64_t, int32_t> sid_lane;
  std::unordered_map<int64_t, int64_t> oid_sid;
  int32_t rr_lane = 0;

  // plan outputs (valid until the next plan() call)
  std::vector<int64_t> p_msg, p_oid;
  std::vector<int32_t> p_seg, p_step, p_lane, p_act, p_aidx, p_price,
      p_size, p_slot;
  std::vector<int64_t> b_msg, b_credit;
  std::vector<int32_t> b_lane, b_mode;
  std::vector<int64_t> r_msg;              // host rejects
  std::vector<int32_t> seg_steps;
  std::vector<int32_t> program;            // (kind, idx) pairs; kind 0=scan 1=barrier
  int64_t err_value = 0;                   // offending aid/sid on capacity error
};

struct PlanState {
  Sched* s;
  std::vector<int32_t> lane_next;
  std::unordered_map<int64_t, int32_t> actor_next;
  std::unordered_map<int32_t, int32_t> step_fill;
  int32_t first_open = 0;
  int32_t seg = 0, seg_height = 0;

  explicit PlanState(Sched* sp) : s(sp), lane_next(sp->S, 0) {}

  void close_segment() {
    if (seg_height > 0) {
      s->seg_steps.push_back(seg_height);
      s->program.push_back(0);  // scan
      s->program.push_back(static_cast<int32_t>(s->seg_steps.size()) - 1);
      seg += 1;
    }
    std::fill(lane_next.begin(), lane_next.end(), 0);
    for (auto& kv : actor_next) kv.second = 0;
    step_fill.clear();
    first_open = 0;
    seg_height = 0;
  }

  void place(int64_t i, int32_t lane, int32_t lane_act, int32_t aidx,
             int64_t oid, int32_t price, int32_t size, bool has_actor,
             int64_t actor_key) {
    int32_t step = lane_next[lane];
    if (has_actor) {
      auto it = actor_next.find(actor_key);
      if (it != actor_next.end() && it->second > step) step = it->second;
    }
    int32_t slot = 0;
    if (s->width > 0) {
      if (first_open > step) step = first_open;
      for (;;) {
        auto it = step_fill.find(step);
        if (it == step_fill.end() || it->second < s->width) break;
        step += 1;
      }
      auto& cnt = step_fill[step];
      slot = cnt;
      cnt += 1;
      for (;;) {
        auto it = step_fill.find(first_open);
        if (it == step_fill.end() || it->second < s->width) break;
        first_open += 1;
      }
    }
    s->p_msg.push_back(i);
    s->p_seg.push_back(seg);
    s->p_step.push_back(step);
    s->p_lane.push_back(lane);
    s->p_act.push_back(lane_act);
    s->p_aidx.push_back(aidx);
    s->p_oid.push_back(oid);
    s->p_price.push_back(price);
    s->p_size.push_back(size);
    s->p_slot.push_back(slot);
    lane_next[lane] = step + 1;
    if (has_actor) actor_next[actor_key] = step + 1;
    if (step + 1 > seg_height) seg_height = step + 1;
  }

  int32_t free_lane(int32_t step_floor) {
    // prefer a lane whose clock is <= the actor clock (no stall),
    // probing round-robin from rr_lane; else the global argmin (first
    // index on ties — matches Python's min())
    for (int32_t probe = 0; probe < s->S; ++probe) {
      int32_t lane = (s->rr_lane + probe) % s->S;
      if (lane_next[lane] <= step_floor) {
        s->rr_lane = (lane + 1) % s->S;
        return lane;
      }
    }
    int32_t best = 0;
    for (int32_t lane = 1; lane < s->S; ++lane)
      if (lane_next[lane] < lane_next[best]) best = lane;
    s->rr_lane = (best + 1) % s->S;
    return best;
  }
};

}  // namespace

extern "C" {

Sched* kme_sched_new(int32_t lanes, int32_t accounts, int32_t width) {
  Sched* s = new Sched();
  s->S = lanes;
  s->A = accounts;
  s->width = width;
  return s;
}

void kme_sched_free(Sched* s) { delete s; }

// Returns ST_* status. Columns are int64 (price/size pre-validated to
// int32 range, oids pre-wrapped to Java-long, by the Python wrapper).
int32_t kme_sched_plan(Sched* s, int64_t n, const int64_t* action,
                       const int64_t* oid, const int64_t* aid,
                       const int64_t* sid, const int64_t* price,
                       const int64_t* size) {
  s->p_msg.clear(); s->p_seg.clear(); s->p_step.clear(); s->p_lane.clear();
  s->p_act.clear(); s->p_aidx.clear(); s->p_oid.clear(); s->p_price.clear();
  s->p_size.clear(); s->p_slot.clear();
  s->b_msg.clear(); s->b_lane.clear(); s->b_mode.clear(); s->b_credit.clear();
  s->r_msg.clear(); s->seg_steps.clear(); s->program.clear();
  s->err_value = 0;

  PlanState ps(s);

  auto acct = [&](int64_t a, int32_t* out) -> bool {
    auto it = s->aid_idx.find(a);
    if (it != s->aid_idx.end()) { *out = it->second; return true; }
    if (static_cast<int32_t>(s->aid_idx.size()) >= s->A) {
      s->err_value = a;
      return false;
    }
    int32_t idx = static_cast<int32_t>(s->aid_idx.size());
    s->aid_idx.emplace(a, idx);
    *out = idx;
    return true;
  };
  auto lane_of = [&](int64_t sym, int32_t* out) -> bool {
    auto it = s->sid_lane.find(sym);
    if (it != s->sid_lane.end()) { *out = it->second; return true; }
    if (static_cast<int32_t>(s->sid_lane.size()) >= s->S) {
      s->err_value = sym;
      return false;
    }
    int32_t lane = static_cast<int32_t>(s->sid_lane.size());
    s->sid_lane.emplace(sym, lane);
    *out = lane;
    return true;
  };

  for (int64_t i = 0; i < n; ++i) {
    const int64_t a = action[i];
    if (a == OP_BUY || a == OP_SELL) {
      int32_t lane, aidx;
      if (!lane_of(sid[i], &lane)) return ST_CAP_SYMBOLS;
      if (!acct(aid[i], &aidx)) return ST_CAP_ACCOUNTS;
      s->oid_sid[oid[i]] = sid[i];
      ps.place(i, lane, a == OP_BUY ? L_BUY : L_SELL, aidx, oid[i],
               static_cast<int32_t>(price[i]), static_cast<int32_t>(size[i]),
               true, aid[i]);
    } else if (a == OP_CANCEL) {
      auto it = s->oid_sid.find(oid[i]);
      if (it == s->oid_sid.end()) {
        s->r_msg.push_back(i);
        continue;
      }
      int32_t lane, aidx;
      if (!lane_of(it->second, &lane)) return ST_CAP_SYMBOLS;
      if (!acct(aid[i], &aidx)) return ST_CAP_ACCOUNTS;
      ps.place(i, lane, L_CANCEL, aidx, oid[i],
               static_cast<int32_t>(price[i]), static_cast<int32_t>(size[i]),
               true, aid[i]);
    } else if (a == OP_CREATE_BALANCE || a == OP_TRANSFER) {
      int32_t aidx;
      if (!acct(aid[i], &aidx)) return ST_CAP_ACCOUNTS;
      int32_t floor = 0;
      auto it = ps.actor_next.find(aid[i]);
      if (it != ps.actor_next.end()) floor = it->second;
      int32_t lane = ps.free_lane(floor);
      ps.place(i, lane, a == OP_CREATE_BALANCE ? L_CREATE : L_TRANSFER,
               aidx, oid[i], static_cast<int32_t>(price[i]),
               static_cast<int32_t>(size[i]), true, aid[i]);
    } else if (a == OP_ADD_SYMBOL) {
      if (sid[i] < 0) {
        s->r_msg.push_back(i);
        continue;
      }
      int32_t lane;
      if (!lane_of(sid[i], &lane)) return ST_CAP_SYMBOLS;
      ps.place(i, lane, L_ADD_SYMBOL, 0, oid[i],
               static_cast<int32_t>(price[i]), static_cast<int32_t>(size[i]),
               false, 0);
    } else if (a == OP_REMOVE_SYMBOL || a == OP_PAYOUT) {
      // abs(INT64_MIN) is not representable (and negating it is UB):
      // the Python authority computes 2^63, which can never match a
      // wrapped map key, so host-reject without negating
      if (sid[i] == INT64_MIN) {
        s->r_msg.push_back(i);
        continue;
      }
      int64_t sym = sid[i] < 0 ? -sid[i] : sid[i];
      auto it = s->sid_lane.find(sym);
      if (it == s->sid_lane.end()) {
        s->r_msg.push_back(i);
        continue;
      }
      ps.close_segment();
      int32_t mode = a == OP_REMOVE_SYMBOL ? 0 : (sid[i] >= 0 ? 1 : 2);
      s->b_msg.push_back(i);
      s->b_lane.push_back(it->second);
      s->b_mode.push_back(mode);
      s->b_credit.push_back(size[i]);
      s->program.push_back(1);  // barrier
      s->program.push_back(static_cast<int32_t>(s->b_msg.size()) - 1);
      // resting-oid routes die with the wipe
      for (auto oit = s->oid_sid.begin(); oit != s->oid_sid.end();) {
        if (oit->second == sym) oit = s->oid_sid.erase(oit);
        else ++oit;
      }
    } else {
      s->r_msg.push_back(i);  // unknown opcode
    }
  }
  ps.close_segment();
  return ST_OK;
}

// ---- plan output getters (pointers valid until the next plan/free) ----
int64_t kme_sched_n_placed(Sched* s) { return (int64_t)s->p_msg.size(); }
const int64_t* kme_sched_p_msg(Sched* s) { return s->p_msg.data(); }
const int32_t* kme_sched_p_seg(Sched* s) { return s->p_seg.data(); }
const int32_t* kme_sched_p_step(Sched* s) { return s->p_step.data(); }
const int32_t* kme_sched_p_lane(Sched* s) { return s->p_lane.data(); }
const int32_t* kme_sched_p_act(Sched* s) { return s->p_act.data(); }
const int32_t* kme_sched_p_aidx(Sched* s) { return s->p_aidx.data(); }
const int64_t* kme_sched_p_oid(Sched* s) { return s->p_oid.data(); }
const int32_t* kme_sched_p_price(Sched* s) { return s->p_price.data(); }
const int32_t* kme_sched_p_size(Sched* s) { return s->p_size.data(); }
const int32_t* kme_sched_p_slot(Sched* s) { return s->p_slot.data(); }
int64_t kme_sched_n_barriers(Sched* s) { return (int64_t)s->b_msg.size(); }
const int64_t* kme_sched_b_msg(Sched* s) { return s->b_msg.data(); }
const int32_t* kme_sched_b_lane(Sched* s) { return s->b_lane.data(); }
const int32_t* kme_sched_b_mode(Sched* s) { return s->b_mode.data(); }
const int64_t* kme_sched_b_credit(Sched* s) { return s->b_credit.data(); }
int64_t kme_sched_n_rejects(Sched* s) { return (int64_t)s->r_msg.size(); }
const int64_t* kme_sched_r_msg(Sched* s) { return s->r_msg.data(); }
int64_t kme_sched_n_segments(Sched* s) { return (int64_t)s->seg_steps.size(); }
const int32_t* kme_sched_seg_steps(Sched* s) { return s->seg_steps.data(); }
int64_t kme_sched_n_program(Sched* s) { return (int64_t)s->program.size() / 2; }
const int32_t* kme_sched_program(Sched* s) { return s->program.data(); }
int64_t kme_sched_err_value(Sched* s) { return s->err_value; }

// ---- id-space state (for checkpoint export/import + reconstruction) ----
int64_t kme_sched_n_accounts(Sched* s) { return (int64_t)s->aid_idx.size(); }
int64_t kme_sched_n_symbols(Sched* s) { return (int64_t)s->sid_lane.size(); }
int64_t kme_sched_n_routes(Sched* s) { return (int64_t)s->oid_sid.size(); }
int32_t kme_sched_rr_lane(Sched* s) { return s->rr_lane; }
void kme_sched_set_rr_lane(Sched* s, int32_t v) { s->rr_lane = v; }

void kme_sched_export_accounts(Sched* s, int64_t* keys, int32_t* vals) {
  int64_t i = 0;
  for (auto& kv : s->aid_idx) { keys[i] = kv.first; vals[i] = kv.second; ++i; }
}
void kme_sched_export_symbols(Sched* s, int64_t* keys, int32_t* vals) {
  int64_t i = 0;
  for (auto& kv : s->sid_lane) { keys[i] = kv.first; vals[i] = kv.second; ++i; }
}
void kme_sched_export_routes(Sched* s, int64_t* keys, int64_t* vals) {
  int64_t i = 0;
  for (auto& kv : s->oid_sid) { keys[i] = kv.first; vals[i] = kv.second; ++i; }
}
void kme_sched_import_accounts(Sched* s, int64_t n, const int64_t* keys,
                               const int32_t* vals) {
  s->aid_idx.clear();
  for (int64_t i = 0; i < n; ++i) s->aid_idx.emplace(keys[i], vals[i]);
}
void kme_sched_import_symbols(Sched* s, int64_t n, const int64_t* keys,
                              const int32_t* vals) {
  s->sid_lane.clear();
  for (int64_t i = 0; i < n; ++i) s->sid_lane.emplace(keys[i], vals[i]);
}
void kme_sched_import_routes(Sched* s, int64_t n, const int64_t* keys,
                             const int64_t* vals) {
  s->oid_sid.clear();
  for (int64_t i = 0; i < n; ++i) s->oid_sid.emplace(keys[i], vals[i]);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch plan: route + H2D staging pack in one call (the plan half of the
// native host path). Calls the seq router through its own C ABI (same
// shared object) and packs the routed columns straight into the stacked
// (K, B) int32 scan-input planes, replacing SeqSession._plan's numpy
// zero-pad + int64 split. Plane order matches the scan's input dict:
//   [act, aid, price, size, lane, oid_lo, oid_hi], plane-major, K*B each.
// ---------------------------------------------------------------------------

extern "C" {
int32_t kme_router_route(void*, int64_t, const int64_t*, const int64_t*,
                         const int64_t*, const int64_t*, const int64_t*,
                         const int64_t*);
int64_t kme_router_n_routed(void*);
const int32_t* kme_router_o_act(void*);
const int32_t* kme_router_o_aidx(void*);
const int32_t* kme_router_o_price(void*);
const int32_t* kme_router_o_size(void*);
const int32_t* kme_router_o_lane(void*);
const int64_t* kme_router_o_oid(void*);
}

namespace {

// Rotating plane buffers: the Python side hands the planes to the jit
// dispatch zero-copy, and double-buffered serving keeps up to two packed
// batches in flight — four buffers give a 2x safety margin before a
// plane is overwritten.
struct Pack {
  static constexpr int NBUF = 4;
  int32_t* buf[NBUF] = {nullptr, nullptr, nullptr, nullptr};
  int64_t cap[NBUF] = {0, 0, 0, 0};
  int cur = NBUF - 1;
  int64_t err_index = -1;
  ~Pack() {
    for (int i = 0; i < NBUF; ++i) delete[] buf[i];
  }
};

}  // namespace

extern "C" {

void* kme_pack_new() { return new Pack(); }
void kme_pack_free(void* p) { delete static_cast<Pack*>(p); }

// Envelope-check + route + pack one batch. Returns K (the power-of-two
// chunk count, >= 1) on success, or:
//   -1 account-capacity exhausted   (router err_value holds the id)
//   -2 symbol-capacity exhausted
//   -3 price/size outside int32     (kme_pack_err_index holds the index;
//                                    id maps untouched, like the Python
//                                    wrapper's pre-route envelope check)
int64_t kme_plan_batch(void* pack, void* router, int64_t n,
                       const int64_t* action, const int64_t* oid,
                       const int64_t* aid, const int64_t* sid,
                       const int64_t* price, const int64_t* size,
                       int32_t B) {
  Pack& pk = *static_cast<Pack*>(pack);
  pk.err_index = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (price[i] < INT32_MIN || price[i] > INT32_MAX ||
        size[i] < INT32_MIN || size[i] > INT32_MAX) {
      pk.err_index = i;
      return -3;
    }
  }
  int32_t rc = kme_router_route(router, n, action, oid, aid, sid, price,
                                size);
  if (rc != 0) return -(int64_t)rc;
  const int64_t nr = kme_router_n_routed(router);
  int64_t nk = nr > 0 ? (nr + B - 1) / B : 1;
  int64_t K = 1;
  while (K < nk) K <<= 1;
  const int64_t total = K * (int64_t)B;
  pk.cur = (pk.cur + 1) % Pack::NBUF;
  int32_t*& b = pk.buf[pk.cur];
  if (pk.cap[pk.cur] < 7 * total) {
    delete[] b;
    b = new int32_t[7 * total];
    pk.cap[pk.cur] = 7 * total;
  }
  std::memset(b, 0, sizeof(int32_t) * 7 * total);
  std::memcpy(b + 0 * total, kme_router_o_act(router), nr * 4);
  std::memcpy(b + 1 * total, kme_router_o_aidx(router), nr * 4);
  std::memcpy(b + 2 * total, kme_router_o_price(router), nr * 4);
  std::memcpy(b + 3 * total, kme_router_o_size(router), nr * 4);
  std::memcpy(b + 4 * total, kme_router_o_lane(router), nr * 4);
  const int64_t* roid = kme_router_o_oid(router);
  int32_t* lo = b + 5 * total;
  int32_t* hi = b + 6 * total;
  for (int64_t i = 0; i < nr; ++i) {
    // numpy split64 semantics: low 32 bits reinterpreted as int32,
    // high 32 via arithmetic shift then truncating cast
    lo[i] = (int32_t)(uint32_t)(uint64_t)roid[i];
    hi[i] = (int32_t)(roid[i] >> 32);
  }
  return K;
}

const int32_t* kme_pack_planes(void* p) {
  Pack& pk = *static_cast<Pack*>(p);
  return pk.buf[pk.cur];
}
int64_t kme_pack_err_index(void* p) {
  return static_cast<Pack*>(p)->err_index;
}

// Per-shard submission-queue slice (seqmesh async dispatch): gather
// one shard's rows for `n` windows out of a stacked (K, shards*bw)
// int32 plane into a dense zero-padded (kpad, bw) segment plane. One
// memcpy per window row; out-of-range window indices are skipped (the
// Python wrapper never produces them — defensive only).
void kme_shard_slice(const int32_t* src, int64_t K, int64_t shards,
                     int64_t bw, int64_t shard, const int64_t* win_idx,
                     int64_t n, int64_t kpad, int32_t* dst) {
  if (kpad > 0)
    std::memset(dst, 0, sizeof(int32_t) * (size_t)(kpad * bw));
  for (int64_t i = 0; i < n && i < kpad; ++i) {
    const int64_t w = win_idx[i];
    if (w < 0 || w >= K) continue;
    std::memcpy(dst + i * bw, src + (w * shards + shard) * bw,
                sizeof(int32_t) * (size_t)bw);
  }
}

}  // extern "C"
