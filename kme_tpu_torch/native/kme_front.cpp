// Native front-door acceptor: the one-C-call-per-batch ingress stage.
//
// The PR 6 host path showed the idiom (kme_plan_batch: one call plans
// and packs a whole batch); this file applies it to the front of the
// pipeline. kme_front_accept validates a buffer of binary order
// frames, computes the rendezvous group route for every row
// (kme_group_assign, PR 9), and — when given pack/router handles —
// chains straight into kme_plan_batch to emit the (K,B) scan planes.
// The GIL is taken once per batch instead of once per order; Python
// only reads back column/group pointers.
//
// Everything here delegates to the existing single authorities in this
// shared object: frame validation + decode live in kme_wire.cpp
// (kme_parse_frames), group choice in kme_router.cpp
// (kme_group_assign), planning in kme_host.cpp (kme_plan_batch).
// The byte-exact Python twin is bridge/front.py accept_frames.
//
// Built together with the other sources by kme_tpu/native/__init__.py.

#include <cstdint>
#include <vector>

extern "C" {
// same shared object, other translation units
void* kme_parse_new();
void kme_parse_free(void*);
int64_t kme_parse_frames(void*, const uint8_t*, int64_t);
int64_t kme_parse_err_off(void*);
const int64_t* kme_parse_col(void*, int32_t);
const uint8_t* kme_parse_hnext(void*);
const uint8_t* kme_parse_hprev(void*);
const int64_t* kme_parse_tid(void*);
const uint8_t* kme_parse_htid(void*);
int64_t kme_parse_emit(void*);
const char* kme_parse_emit_buf(void*);
const int64_t* kme_parse_emit_off(void*);
void kme_group_assign(int64_t, const int64_t*, int32_t, int64_t,
                      int32_t*);
int64_t kme_plan_batch(void*, void*, int64_t, const int64_t*,
                       const int64_t*, const int64_t*, const int64_t*,
                       const int64_t*, const int64_t*, int32_t);
}

namespace {

struct Front {
  void* parse;
  std::vector<int64_t> keys;
  std::vector<int32_t> gsym, gacct, groups;
  int64_t plan_k = 0;
  Front() : parse(kme_parse_new()) {}
  ~Front() { kme_parse_free(parse); }
};

// symbol_key (bridge/front.py): abs with INT64_MIN passthrough.
inline int64_t symbol_key(int64_t sid) {
  return (sid < 0 && sid != INT64_MIN) ? -sid : sid;
}

}  // namespace

extern "C" {

void* kme_front_new() { return new Front(); }
void kme_front_free(void* p) { delete static_cast<Front*>(p); }

// Validate + decode + group-route one buffer of binary frames, and
// (when pack/router are non-null) plan+pack the batch in the same
// call. Returns the row count, or the negative kme_parse_frames
// validation code (-1..-5; offending offset via kme_front_err_off).
// The plan result K (incl. its negative capacity/envelope codes) is
// read via kme_front_plan_k, NOT the return value — a plan refusal
// still leaves valid columns/groups for the caller to re-route.
//
// Routing-key choice mirrors front.py route_line: account ops
// (CREATE=100 / TRANSFER=101) route by aid under salt_acct; CANCEL=4
// routes by oid and everything else by symbol_key(sid), both under
// salt_sym. Both assignments are computed full-width by the single
// authority kme_group_assign, then selected per row.
int64_t kme_front_accept(void* h, const uint8_t* buf, int64_t len,
                         int32_t ngroups, int64_t salt_sym,
                         int64_t salt_acct, void* pack, void* router,
                         int32_t B) {
  Front& F = *static_cast<Front*>(h);
  F.plan_k = 0;
  int64_t n = kme_parse_frames(F.parse, buf, len);
  if (n < 0) return n;
  const int64_t* act = kme_parse_col(F.parse, 0);
  const int64_t* oid = kme_parse_col(F.parse, 1);
  const int64_t* aid = kme_parse_col(F.parse, 2);
  const int64_t* sid = kme_parse_col(F.parse, 3);
  F.keys.resize(n);
  F.gsym.resize(n);
  F.gacct.resize(n);
  F.groups.resize(n);
  for (int64_t i = 0; i < n; i++)
    F.keys[i] = act[i] == 4 ? oid[i] : symbol_key(sid[i]);
  kme_group_assign(n, F.keys.data(), ngroups, salt_sym, F.gsym.data());
  kme_group_assign(n, aid, ngroups, salt_acct, F.gacct.data());
  for (int64_t i = 0; i < n; i++)
    F.groups[i] = (act[i] == 100 || act[i] == 101) ? F.gacct[i]
                                                   : F.gsym[i];
  if (pack && router)
    F.plan_k = kme_plan_batch(pack, router, n, act, oid, aid, sid,
                              kme_parse_col(F.parse, 4),
                              kme_parse_col(F.parse, 5), B);
  return n;
}

const int32_t* kme_front_groups(void* p) {
  return static_cast<Front*>(p)->groups.data();
}
int64_t kme_front_plan_k(void* p) {
  return static_cast<Front*>(p)->plan_k;
}
int64_t kme_front_err_off(void* p) {
  return kme_parse_err_off(static_cast<Front*>(p)->parse);
}
const int64_t* kme_front_col(void* p, int32_t i) {
  return kme_parse_col(static_cast<Front*>(p)->parse, i);
}
const uint8_t* kme_front_hnext(void* p) {
  return kme_parse_hnext(static_cast<Front*>(p)->parse);
}
const uint8_t* kme_front_hprev(void* p) {
  return kme_parse_hprev(static_cast<Front*>(p)->parse);
}
const int64_t* kme_front_tid(void* p) {
  return kme_parse_tid(static_cast<Front*>(p)->parse);
}
const uint8_t* kme_front_htid(void* p) {
  return kme_parse_htid(static_cast<Front*>(p)->parse);
}
// Canonical-JSON emission for the accepted rows (broker value bytes);
// delegates to the pinned kme_wire.cpp emitter.
int64_t kme_front_json(void* p) {
  return kme_parse_emit(static_cast<Front*>(p)->parse);
}
const char* kme_front_json_buf(void* p) {
  return kme_parse_emit_buf(static_cast<Front*>(p)->parse);
}
const int64_t* kme_front_json_off(void* p) {
  return kme_parse_emit_off(static_cast<Front*>(p)->parse);
}

}  // extern "C"
