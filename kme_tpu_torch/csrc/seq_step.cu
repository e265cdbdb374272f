// seq_step: the sequential matching kernel for Hopper (sm_90a), in every
// configuration of the TPU kernel.
//
// Replaces kme_tpu/engine/seq.py `build_seq_step` (the Pallas kernel body
// :346-1531 launched by `pl.pallas_call` at :1549) and `build_seq_scan`
// (:1576): K chunks of B messages run in ONE launch, the chunk loop
// inside the kernel. The state planes (same names, shapes and int32
// lo/hi split as the JAX package) are updated in place; the output plane
// layout is byte-for-byte the JAX one (kme_tpu_torch/engine/seq.py
// `out_rows`). One template, two instantiations:
//
// - seq_scan_kernel<false>, entry kme_seq_scan: compat='fixed';
// - seq_scan_kernel<true>, entry kme_seq_scan_java: compat='java' (the
//   JAVA branches of the Pallas body: Q1 merged symbol-0 book, Q2 ghost
//   fill, Q11 128-bit-key tombstoned position hash :566-754, raw-id
//   tables :897-914, fatal LERR_JAVA_DOMAIN / LERR_JAVA_CAP, no barriers
//   and no dep plane).
//
// hbm_books=True (the TPU's deep books, :785-805) is the same kernel at
// more rows per side (NR = slots/128, 64 at 8192 slots). The TPU needs a
// separate path because VMEM cannot hold deep books, so it keeps them in
// HBM and copies one symbol's rows into a VMEM cache at each switch. Here
// every book row is read in place from device memory at any depth (at
// 8192 slots x 1024 symbols the six book planes take 403 MB).
//
// What bounds it on this card: not bandwidth and not arithmetic. Each
// message reads and writes a few hundred bytes of state, but message m+1
// may depend on every byte message m wrote (same book, same account, same
// hash tile), so the work is one sequential dependence chain of loads,
// warp reductions and stores. Its time is the chain's latency: the
// dependent operations a message executes times the latency of each,
// with no second warp to hide any of it. The chain cannot be split, so
// the kernel runs on ONE warp of one block: every scalar the TPU kernel
// parks in its SMEM row is a register all 32 lanes hold (warp-uniform
// control flow, no block barriers), each lane owns 4 of a row's 128
// columns (one 16-byte load per lane per row), and a 128-wide masked
// reduction is a per-lane reduction plus ONE warp-wide integer min or max
// (`__reduce_min_sync`, a single REDUX operation, where a shuffle tree
// takes five dependent shuffle-and-compare steps). A position is looked
// up once per update (the entry found is written in place), a message's
// scalar stores go out together between one pair of warp barriers, and a
// taker's balance is carried in a register and stored once. Tensor
// cores, TMA tiles and thread block clusters have nothing to do here:
// the work is int32 compares on one chain, not tiles of independent
// data. Three things keep the chain short at any book depth:
//
// 1. Walk only the rows in use. A rest always takes the lowest free
//    slot, so live orders sit in a side's low rows. `occ[lane][side]` is
//    one more than the highest row that can hold a nonzero size; every
//    book pass (sweep copy and write-back, fill search, Q2 ghost, own-side
//    search, CANCEL, barrier wipe) walks r < occ, not r < NR, and the
//    free-slot search returns the first hole below occ, else slot occ*128
//    while occ < NR. `occ` is no state plane: `rows_in_use_kernel` derives
//    it from `bs` before every launch of the chain kernel (one block per
//    (lane, side) on all SMs: the one parallel part of the work), and the
//    chain keeps it current: a rest raises its side's occ, a barrier wipe
//    zeroes both sides', nothing else lowers it. At NR = 1 occ is 1 and
//    neither kernel touches the scratch.
// 2. One pass per selection. The best maker is the lexicographic minimum
//    of (price*sgn, seq, flat slot): `lexmin` reduces that triple in one
//    walk (a per-lane best, then three warp mins: the least k1, the
//    least k2 beside it, the least slot beside both) where the TPU kernel
//    takes three masked mins, each a walk of its own. The Q2 ghost, the barrier
//    wipe's (price, seq, slot) and the Q9 tail echo's (highest seq, then
//    lowest slot) go the same way. The keys are the wrapped values the
//    three masked mins compare, BIG the "none" value, so ties and
//    out-of-domain java prices resolve as on the TPU.
// 3. Stage a trade's book rows in shared memory, all at once. The first
//    thing a trade does is to start cp.async copies (16 bytes a lane a
//    row, all rows in flight) of the occ rows of the opposite side's sizes
//    (the sweep scratch `wsz`, as on the TPU) and, when they fit the STAGE
//    rows the launcher sized, of its prices and seqs and of the own
//    side's three planes. They land while the taker's position lookup
//    waits on device memory; one wait before the sweep, and the
//    up-to-max_fills fill searches, the Q2 search and the own-side search
//    read shared memory: one trip to device memory where each search
//    would make its own. A deeper side reads bp/bq in place. The sweep
//    never writes bp/bq, and a rest lands in device memory after every
//    read of the trade, so the staged copies cannot go stale; a merged
//    (Q1) book searches its own side on the staged, post-sweep sizes.
//
// Shared memory: NR + 2 + 5*STAGE rows of 512 bytes (73 KB at 8192 slots
// and 16 staged rows); above 48 KB the launcher opts in to more.
//
// Java wrap arithmetic: signed overflow is undefined in C++, so every
// 32-bit wrap is done in uint32_t and every 64-bit lo/hi value is joined
// into uint64_t on load and split on store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LN = 128;
constexpr int BIG = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

constexpr int L_NOP = 0, L_BUY = 1, L_SELL = 2, L_CANCEL = 3, L_CREATE = 4,
              L_TRANSFER = 5, L_ADD_SYMBOL = 6, L_PAYOUT_YES = 7,
              L_PAYOUT_NO = 8, L_REMOVE_SYMBOL = 9;
constexpr int LERR_OK = 0, LERR_FILLBUF_FULL = 3, LERR_HASH_FULL = 4,
              LERR_JAVA_DOMAIN = 5, LERR_JAVA_CAP = 6;
constexpr int AMASK = (1 << 30) - 1;  // java: ba = aid index | is_buy << 30
constexpr int N_METRICS = 12, NB = 16, HIST_LANE0 = 2 + N_METRICS;

struct Args {
  const int32_t *act, *oidlo, *oidhi, *aid, *price, *size, *lane;
  // java mode only: raw Java-long aid / sid (lo, hi) and the Q1 flag
  const int32_t *aidrlo, *aidrhi, *sidrlo, *sidrhi, *flags;
  // state planes: deliberately NOT const/__restrict__, so no load goes
  // through the non-coherent read-only path while the kernel writes them
  int32_t *bo_lo, *bo_hi, *ba, *bp, *bs, *bq, *seqc, *bex, *bal_lo,
      *bal_hi, *bal_u, *ha_lo, *ha_hi, *hv_lo, *hv_hi, *err;
  int32_t *hk, *dep;                                    // fixed mode only
  int32_t *hka_lo, *hka_hi, *hkb_lo, *hkb_hi, *hstate,  // java mode only
      *araw_lo, *araw_hi, *sraw_lo, *sraw_hi;
  int32_t *out;
  int32_t *occ;  // (S, 2) scratch: rows in use per (lane, side); NR > 1 only
  int K, S, NR, A, E, B, CAPR, FB, PROBE, STAGE;
};

// ---- wrap arithmetic -----------------------------------------------------
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t wneg(int32_t a) {
  return (int32_t)(0u - (uint32_t)a);
}
__device__ __forceinline__ int64_t add64(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t sub64(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t j64(int32_t lo, int32_t hi) {
  return (int64_t)(((uint64_t)(uint32_t)hi << 32) | (uint64_t)(uint32_t)lo);
}
// the JAX kernel's `_muls64`: i32 x small i32 via a 16-bit split, each
// partial wrapped at 32 bits (exact for |b| <= 2^14)
__device__ __forceinline__ int64_t muls64(int32_t a, int32_t b) {
  int32_t t1 = wmul(a & 0xFFFF, b);
  int32_t t2 = wmul(a >> 16, b);
  return (int64_t)t2 * 65536 + (int64_t)t1;
}
__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a < b ? b : a;
}
__device__ __forceinline__ int32_t lo32(int64_t v) {
  return (int32_t)(uint32_t)(uint64_t)v;
}
__device__ __forceinline__ int32_t hi32(int64_t v) {
  return (int32_t)(uint32_t)((uint64_t)v >> 32);
}
// postRemoveAdjustments' arithmetic (KProcessor.java:325-333): the
// available adjustment and the balance credit of removing an order
__device__ __forceinline__ void margin(bool isbuy, int32_t price,
                                      int32_t size, int64_t amt,
                                      int64_t avail, int64_t& adj,
                                      int64_t& rel) {
  const int32_t sgnd = isbuy ? size : wneg(size);
  const int64_t blocked = sub64(amt, avail);
  const int64_t nsg = -(int64_t)sgnd;
  adj = isbuy ? max64(min64(blocked, 0), nsg) : min64(max64(blocked, 0), nsg);
  const int32_t unit = isbuy ? price : wsub(price, 100);
  rel = muls64(wadd(sgnd, lo32(adj)), unit);
}

// ---- warp primitives -----------------------------------------------------
// the warp's min / max in one REDUX operation (sm_80 and later)
__device__ __forceinline__ int wmin(int v) {
  return __reduce_min_sync(FULL, v);
}
__device__ __forceinline__ int wmax(int v) {
  return __reduce_max_sync(FULL, v);
}
// one scalar store by lane 0, ordered against every lane's earlier reads
// and later reads of the same word
__device__ __forceinline__ void sput(int32_t* p, int idx, int32_t v) {
  __syncwarp();
  if (threadIdx.x == 0) p[idx] = v;
  __syncwarp();
}
__device__ __forceinline__ void sput64(int32_t* lo, int32_t* hi, int idx,
                                       int64_t v) {
  __syncwarp();
  if (threadIdx.x == 0) {
    lo[idx] = (int32_t)(uint32_t)(uint64_t)v;
    hi[idx] = (int32_t)(uint32_t)((uint64_t)v >> 32);
  }
  __syncwarp();
}
__device__ __forceinline__ int4 ld4(const int32_t* p) {
  return *reinterpret_cast<const int4*>(p);
}
__device__ __forceinline__ void st4(int32_t* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}
__device__ __forceinline__ int el(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// 16 bytes, device memory -> shared memory, asynchronously (through L1,
// like the plain loads of the same rows)
__device__ __forceinline__ void cp16(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ---- one-pass lexicographic selection -------------------------------------
struct Key3 {
  int k1, k2, k3;
};
// The lexicographic minimum of (k1, k2, flat slot) over the slots of
// `rows` book rows that `key` accepts; {BIG, BIG, BIG} when it accepts
// none (or only keys that the masked mins' BIG would hide). `w`, `p`, `q`
// point at row 0 of the side's size, price and seq rows, in shared or
// device memory; key(flat, size, price, seq, k1&, k2&) -> accepted. One
// walk keeps each lane's least triple (branch-free compares), then three
// warp mins pick the least k1, the least k2 beside it, the least slot
// beside both.
template <class F>
__device__ __forceinline__ Key3 lexmin(int rows, int tid, const int32_t* w,
                                       const int32_t* p, const int32_t* q,
                                       F key) {
  Key3 best = {BIG, BIG, BIG};
  for (int r = 0; r < rows; ++r) {
    const int o = r * LN + 4 * tid;
    const int4 w4 = ld4(w + o), p4 = ld4(p + o), q4 = ld4(q + o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int k1, k2;
      const bool ok = key(o + j, el(w4, j), el(p4, j), el(q4, j), k1, k2);
      // slots come in rising order, so a tie on (k1, k2) keeps the first
      const bool lt = ok & ((k1 < best.k1) | ((k1 == best.k1) & (k2 < best.k2)));
      best.k1 = lt ? k1 : best.k1;
      best.k2 = lt ? k2 : best.k2;
      best.k3 = lt ? o + j : best.k3;
    }
  }
  const int s1 = wmin(best.k1);
  if (s1 >= BIG) return {BIG, BIG, BIG};
  const int s2 = wmin(best.k1 == s1 ? best.k2 : INT32_MAX);
  const int s3 = wmin(best.k1 == s1 && best.k2 == s2 ? best.k3 : INT32_MAX);
  return {s1, s2, s3};
}

__device__ __forceinline__ int hbucket(int v) {
  int b = 0;
#pragma unroll
  for (int k = 0; k < NB - 1; ++k) b += v >= (1 << k);
  return b;
}

// ---- engine state access -------------------------------------------------
struct Eng {
  Args a;
  int tid, tmask;

  __device__ void set_err(int code) {
    if (a.err[0] == LERR_OK) sput(a.err, 0, code);
  }
  __device__ int64_t bal(int acc) { return j64(a.bal_lo[acc], a.bal_hi[acc]); }
  __device__ void bal_add(int acc, int64_t d) {
    sput64(a.bal_lo, a.bal_hi, acc, add64(bal(acc), d));
  }
  __device__ int64_t val(const int32_t* lo, const int32_t* hi, int e) {
    return j64(lo[e], hi[e]);
  }

  // -- position hash: tile-granular linear probing from a Fibonacci home
  __device__ int home(int key) {
    return ((int32_t)((uint32_t)key * 0x9E3779B9u) >> 7) & tmask;
  }
  __device__ void tile(int t, int key, int& hx, int& em) {
    int4 v = ld4(a.hk + t * LN + 4 * tid);
    int h = BIG, e = BIG;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      int k = el(v, j);
      if (k == key) h = 4 * tid + j;
      if (k == 0) e = 4 * tid + j;
    }
    hx = wmin(h);
    em = wmin(e);
  }
  // -> flat entry or -1 (absent)
  __device__ int h_find(int key) {
    int t0 = home(key), hx, em;
    tile(t0, key, hx, em);
    if (hx < BIG) return t0 * LN + hx;
    if (em < BIG || 1 >= a.PROBE) return -1;
    int t = (t0 + 1) & tmask, probes = 1, res = -1;
    while (true) {
      tile(t, key, hx, em);
      bool stop = hx < BIG || em < BIG || probes + 1 >= a.PROBE;
      if (hx < BIG) res = t * LN + hx;
      t = (t + 1) & tmask;
      ++probes;
      if (stop) break;
    }
    return res;
  }
  // find-or-insert -> flat entry or -1 (= HASH_FULL)
  __device__ int h_claim(int key) {
    int t0 = home(key), hx, em;
    tile(t0, key, hx, em);
    if (hx < BIG) return t0 * LN + hx;
    if (em < BIG) {
      sput(a.hk, t0 * LN + em, key);
      return t0 * LN + em;
    }
    if (1 >= a.PROBE) return -1;
    int t = (t0 + 1) & tmask, probes = 1, res = -1;
    while (true) {
      tile(t, key, hx, em);
      bool ins = hx >= BIG && em < BIG;
      if (hx < BIG) res = t * LN + hx;
      if (ins) {
        res = t * LN + em;
        sput(a.hk, res, key);
      }
      bool stop = hx < BIG || ins || probes + 1 >= a.PROBE;
      t = (t + 1) & tmask;
      ++probes;
      if (stop) break;
    }
    return res;
  }
  __device__ int pos_key(int lane, int acc) { return lane * a.A + acc + 1; }
  // -> the position's entry or -1 (absent: amt = avail = 0)
  __device__ int pos_get(int lane, int acc, int64_t& amt, int64_t& avail) {
    const int e = h_find(pos_key(lane, acc));
    jvals(e, amt, avail);
    return e;
  }
  // Write the position whose lookup gave entry `e`. No store lies between
  // a lookup and its write, so a found entry is written in place, where a
  // second probe would end; an absent one is claimed. -> err flag
  __device__ bool pos_set(int e, int lane, int acc, int64_t amt,
                          int64_t avail) {
    if (e < 0) e = h_claim(pos_key(lane, acc));
    if (e < 0) return true;
    __syncwarp();
    if (tid == 0) {
      a.ha_lo[e] = lo32(amt);
      a.ha_hi[e] = hi32(amt);
      a.hv_lo[e] = lo32(avail);
      a.hv_hi[e] = hi32(avail);
    }
    __syncwarp();
    return false;
  }
  // fillOrder's position half (KProcessor.java:276-287), fixed mode
  __device__ bool fill_one(int lane, int acc, int32_t sgn_fill) {
    int64_t amt, avail;
    const int e = pos_get(lane, acc, amt, avail);
    int64_t na = add64(amt, sgn_fill), nv = add64(avail, sgn_fill);
    return pos_set(e, lane, acc, na, na == 0 ? 0 : nv);
  }
  // postRemoveAdjustments (KProcessor.java:325-333): the balance credit
  __device__ int64_t release_margin(int lane, int acc, bool isbuy,
                                    int32_t price, int32_t size) {
    int64_t amt, avail, adj, rel;
    const int e = pos_get(lane, acc, amt, avail);
    margin(isbuy, price, size, amt, avail, adj, rel);
    if (adj != 0 && pos_set(e, lane, acc, amt, add64(avail, adj)))
      set_err(LERR_HASH_FULL);
    return rel;
  }

  // -- java position hash (Q11): 128-bit keys k = (a lo, a hi, b lo, b hi)
  // — the real (aid, sid) key or an (amount, available) key — with a state
  // plane (0 empty, 1 live, 2 tombstone), tile-granular linear probing
  __device__ int jhome(int4 k) {
    const uint32_t h = (uint32_t)k.x * 0x9E3779B9u ^
                       (uint32_t)k.y * 0x85EBCA6Bu ^
                       (uint32_t)k.z * 0xC2B2AE35u ^ (uint32_t)k.w * 69069u;
    return ((int32_t)h >> 7) & tmask;
  }
  // one tile -> lane minima: live match, empty, reusable (not live)
  __device__ void jtile(int t, int4 k, int& hx, int& em, int& fr) {
    const int o = t * LN + 4 * tid;
    const int4 s4 = ld4(a.hstate + o), al = ld4(a.hka_lo + o),
               ah = ld4(a.hka_hi + o), bl = ld4(a.hkb_lo + o),
               bh = ld4(a.hkb_hi + o);
    int h = BIG, e = BIG, f = BIG;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      const int st = el(s4, j);
      if (st == 1 && el(al, j) == k.x && el(ah, j) == k.y &&
          el(bl, j) == k.z && el(bh, j) == k.w)
        h = 4 * tid + j;
      if (st == 0) e = 4 * tid + j;
      if (st != 1) f = 4 * tid + j;
    }
    hx = wmin(h);
    em = wmin(e);
    fr = wmin(f);
  }
  // -> flat entry or -1; `err` when nothing was found and the probe bound
  // was reached. Tombstones are passed over, an empty slot ends the probe.
  __device__ int jfind(int4 k, bool& err) {
    const int t0 = jhome(k);
    int hx, em, fr;
    jtile(t0, k, hx, em, fr);
    err = false;
    if (hx < BIG) return t0 * LN + hx;
    if (em < BIG || 1 >= a.PROBE) {
      err = 1 >= a.PROBE;
      return -1;
    }
    int t = (t0 + 1) & tmask, probes = 1, res = -1;
    while (true) {
      jtile(t, k, hx, em, fr);
      const bool stop = hx < BIG || em < BIG || probes + 1 >= a.PROBE;
      if (hx < BIG) res = t * LN + hx;
      t = (t + 1) & tmask;
      ++probes;
      if (stop) break;
    }
    err = res < 0 && probes >= a.PROBE;
    return res;
  }
  // -> the live match if there is one, else the first reusable slot on the
  // probe path (lowest lane of the first tile with one), else -1
  __device__ int jslot(int4 k) {
    const int t0 = jhome(k);
    int hx, em, fr;
    jtile(t0, k, hx, em, fr);
    int res = hx < BIG ? t0 * LN + hx : -1;
    int reuse = fr < BIG ? t0 * LN + fr : -1;
    if (!(hx < BIG || em < BIG || 1 >= a.PROBE)) {
      int t = (t0 + 1) & tmask, probes = 1;
      while (true) {
        jtile(t, k, hx, em, fr);
        if (reuse < 0 && fr < BIG) reuse = t * LN + fr;
        if (hx < BIG) res = t * LN + hx;
        const bool stop = hx < BIG || em < BIG || probes + 1 >= a.PROBE;
        t = (t + 1) & tmask;
        ++probes;
        if (stop) break;
      }
    }
    return res >= 0 ? res : reuse;
  }
  __device__ void jvals(int e, int64_t& amt, int64_t& avail) {
    amt = e >= 0 ? val(a.ha_lo, a.ha_hi, e) : 0;
    avail = e >= 0 ? val(a.hv_lo, a.hv_hi, e) : 0;
  }
  __device__ void jwrite(int e, int4 k, int64_t amt, int64_t avail) {
    if (e < 0) return;
    __syncwarp();
    if (tid == 0) {
      a.hstate[e] = 1;
      a.hka_lo[e] = k.x;
      a.hka_hi[e] = k.y;
      a.hkb_lo[e] = k.z;
      a.hkb_hi[e] = k.w;
      a.ha_lo[e] = lo32(amt);
      a.ha_hi[e] = hi32(amt);
      a.hv_lo[e] = lo32(avail);
      a.hv_hi[e] = hi32(avail);
    }
    __syncwarp();
  }
  // insert-or-update `k`; a probe path with no room is HASH_FULL
  __device__ void jclaim(int4 k, int64_t amt, int64_t avail) {
    const int e = jslot(k);
    jwrite(e, k, amt, avail);
    if (e < 0) set_err(LERR_HASH_FULL);
  }
  // fillOrder, java (Q11, KProcessor.java:276-287): the first fill creates
  // the real (aid, sid) entry; later fills read it but write, or at zero
  // delete, the (amount, available) key. -> err flag
  __device__ bool jfill_one(int4 real, int32_t sgn_fill) {
    bool err;
    const int e = jfind(real, err);
    if (e < 0) {
      if (!err) jclaim(real, (int64_t)sgn_fill, (int64_t)sgn_fill);
      return err;
    }
    int64_t amt, avail;
    jvals(e, amt, avail);
    const int64_t na = add64(amt, sgn_fill), nv = add64(avail, sgn_fill);
    const int4 target = make_int4(lo32(amt), hi32(amt), lo32(avail),
                                  hi32(avail));
    if (na == 0) {
      bool terr;
      const int te = jfind(target, terr);
      if (te >= 0) sput(a.hstate, te, 2);  // tombstone
    } else {
      jclaim(target, na, nv);
    }
    return false;
  }
  // postRemoveAdjustments, java: the 2-argument setPosition writes the
  // adjustment to the (amount, available) key (Q11); the real entry stays
  __device__ int64_t jrelease_margin(int4 real, bool isbuy, int32_t price,
                                     int32_t size) {
    bool err;
    int64_t amt, avail, adj, rel;
    jvals(jfind(real, err), amt, avail);
    margin(isbuy, price, size, amt, avail, adj, rel);
    if (adj != 0)
      jclaim(make_int4(lo32(amt), hi32(amt), lo32(avail), hi32(avail)), amt,
             add64(avail, adj));
    return rel;
  }
};

template <bool JAVA>
__global__ void __launch_bounds__(32, 1) seq_scan_kernel(Args args) {
  extern __shared__ __align__(16) int32_t smem[];
  Eng g;
  g.a = args;
  g.tid = threadIdx.x;
  g.tmask = args.CAPR - 1;
  const Args& a = g.a;
  const int tid = g.tid;
  const int NR = a.NR, W = NR * LN, B = a.B, BR = B / LN;
  const int NROWS = 1 + 5 * BR + 5 * (a.FB / LN);
  int32_t* wsz = smem;           // sweep scratch: opposite side sizes
  int32_t* fslot = smem + W;     // swept maker slots
  int32_t* fsize = fslot + LN;   // swept fill sizes
  const int SW = a.STAGE * LN;
  int32_t* sp = fsize + LN;      // staged opposite side prices,
  int32_t* sq = sp + SW;         // seqs;
  int32_t* ow = sq + SW;         // staged own side sizes,
  int32_t* op = ow + SW;         // prices,
  int32_t* oq = op + SW;         // seqs
  const bool deep = NR > 1;      // occ is kept; else every side has 1 row

  for (int k = 0; k < a.K; ++k) {
    const size_t mo = (size_t)k * B;
    int32_t* out = a.out + (size_t)k * NROWS * LN;
    int hist[4] = {0, 0, 0, 0};   // this lane's 4 columns of row 0
    int32_t met[N_METRICS];
#pragma unroll
    for (int i = 0; i < N_METRICS; ++i) met[i] = 0;
    int fill_total = 0;

    auto hist_obs = [&](int lane0, int v) {
      int c = lane0 + hbucket(v);
#pragma unroll
      for (int j = 0; j < 4; ++j) hist[j] += c == 4 * tid + j;
    };

    for (int m = 0; m < B; ++m) {
      const int act = a.act[mo + m], lane = a.lane[mo + m];
      const int acc = a.aid[mo + m];
      const int32_t limit = a.price[mo + m], size = a.size[mo + m];
      const int32_t t_oidlo = a.oidlo[mo + m], t_oidhi = a.oidhi[mo + m];
      const bool is_buy = act == L_BUY;
      const bool is_trade = is_buy || act == L_SELL;
      const bool is_cancel = act == L_CANCEL;
      const bool is_barrier = act == L_PAYOUT_YES || act == L_PAYOUT_NO ||
                              act == L_REMOVE_SYMBOL;
      // Q1 (java): symbol 0's buys and sells share one book, side 0
      const bool merged = JAVA && (a.flags[mo + m] & 1) != 0;
      const int side = merged ? 0 : is_buy ? 0 : 1;
      const int opp = merged ? 0 : 1 - side;
      const int32_t sgn = is_buy ? 1 : -1;
      const int base_own = (lane * 2 * NR + side * NR) * LN;
      const int base_opp = (lane * 2 * NR + opp * NR) * LN;
      // java: the actor's real position key (raw aid, raw sid)
      const int4 real =
          JAVA ? make_int4(a.aidrlo[mo + m], a.aidrhi[mo + m],
                           a.sidrlo[mo + m], a.sidrhi[mo + m])
               : make_int4(0, 0, 0, 0);
      if (JAVA) {
        // raw-id tables, before the message's own logic
        if (is_trade || is_cancel || act == L_CREATE || act == L_TRANSFER) {
          __syncwarp();
          if (tid == 0) {
            a.araw_lo[acc] = real.x;
            a.araw_hi[acc] = real.y;
          }
          __syncwarp();
        }
        if (act == L_ADD_SYMBOL) {
          __syncwarp();
          if (tid == 0) {
            a.sraw_lo[lane] = real.z;
            a.sraw_hi[lane] = real.w;
          }
          __syncwarp();
        }
      }

      const bool bex_v = a.bex[lane] != 0;
      // rows in use of the lane's buy and sell side
      int occ0 = 1, occ1 = 1;
      if (deep && (is_trade || is_cancel || is_barrier)) {
        occ0 = a.occ[2 * lane];
        occ1 = a.occ[2 * lane + 1];
      }
      const int64_t bal = g.bal(acc);
      const bool bal_ok = a.bal_u[acc] != 0;

      // ---- CREATE / TRANSFER / ADD_SYMBOL
      const bool create_ok = act == L_CREATE && !bal_ok;
      const bool transfer_ok = act == L_TRANSFER && bal_ok &&
                               !(bal < (int64_t)wneg(size));
      const bool addsym_ok = act == L_ADD_SYMBOL && !bex_v;
      if (create_ok) sput(a.bal_u, acc, 1);
      if (transfer_ok) g.bal_add(acc, (int64_t)size);
      if (addsym_ok) sput(a.bex, lane, 1);

      bool t_ok = false, t_acc = false, capr = false, append = false;
      bool do_rest = false, c_ok = false;
      int32_t resid_v = size, nf = 0, tail_lo = 0, tail_hi = 0, nempt_v = 0;

      // ---- TRADE
      if (is_trade) {
        // Stage the rows in use of both sides first, so that the copies
        // fly while the position lookup below waits on device memory:
        // the opposite side's sizes into the sweep scratch (reset on
        // EVERY trade message, rejected ones too) with its prices and
        // seqs, and the own side's three planes (a merged book's own side
        // is the swept one). A side deeper than STAGE rows keeps its
        // prices and seqs in place.
        const int occ_opp = opp ? occ1 : occ0, occ_own = side ? occ1 : occ0;
        const bool st_opp = occ_opp <= a.STAGE;
        const bool st_own = !merged && occ_own <= a.STAGE;
        __syncwarp();
        for (int r = 0; r < occ_opp; ++r) {
          const int o = r * LN + 4 * tid;
          cp16(wsz + o, a.bs + base_opp + o);
          if (st_opp) {
            cp16(sp + o, a.bp + base_opp + o);
            cp16(sq + o, a.bq + base_opp + o);
          }
        }
        for (int r = 0; st_own && r < occ_own; ++r) {
          const int o = r * LN + 4 * tid;
          cp16(ow + o, a.bs + base_own + o);
          cp16(op + o, a.bp + base_own + o);
          cp16(oq + o, a.bq + base_own + o);
        }
        cp_commit();
        const int32_t seqv = a.seqc[lane];
        const bool valid = limit >= 0 && limit < 126 && size > 0;
        const int32_t sgnd = is_buy ? size : wneg(size);
        int64_t pamt, pav;
        int e_actor = -1;
        if (JAVA) {
          // no valid gate: out-of-domain fields are fatal
          if (!valid) g.set_err(LERR_JAVA_DOMAIN);
          bool ferr;
          e_actor = g.jfind(real, ferr);
          g.jvals(e_actor, pamt, pav);
        } else {
          e_actor = g.pos_get(lane, acc, pamt, pav);
        }
        const int64_t nsg = -(int64_t)sgnd;
        const int64_t adj = is_buy ? max64(min64(pav, 0), nsg)
                                   : min64(max64(pav, 0), nsg);
        const int32_t unit = is_buy ? limit : wsub(limit, 100);
        const int64_t risk =
            muls64(wadd(sgnd, (int32_t)(uint32_t)(uint64_t)adj), unit);
        t_ok = (JAVA || valid) && bex_v && bal_ok && !(bal < risk);

        // phase 1: non-mutating sweep over the scratch copy of the
        // opposite side's sizes
        cp_wait_all();
        __syncwarp();
        const int32_t* pp = st_opp ? sp : a.bp + base_opp;
        const int32_t* qq = st_opp ? sq : a.bq + base_opp;
        int32_t remaining = t_ok ? size : 0;
        int nfill = 0, nempt = 0;
        bool ovf = false, emptied = false;
        while (remaining > 0) {
          // best price*sgn, then lowest seq, then lowest flat slot
          const Key3 best = lexmin(
              occ_opp, tid, wsz, pp, qq,
              [&](int, int w, int32_t p, int q, int& k1, int& k2) {
                k1 = wmul(p, sgn);
                k2 = q;
                return w > 0 && wmul(wsub(p, limit), sgn) <= 0;
              });
          if (best.k1 >= BIG) break;   // no crossing maker: anyc false
          if (nfill >= a.E) {          // exceed: the max_fills envelope
            ovf = true;
            break;
          }
          const int flat = best.k3;
          const int32_t have = wsz[flat];
          const int32_t fill = min(remaining, have);
          __syncwarp();
          if (tid == 0) {
            wsz[flat] = have - fill;
            fslot[nfill] = flat;
            fsize[nfill] = fill;
          }
          __syncwarp();
          remaining -= fill;
          emptied = have == fill;
          nempt += emptied;
          ++nfill;
        }
        const int32_t residual = remaining;

        if (JAVA && t_ok && residual == 0 && emptied) {
          // Q2 (KProcessor.java:237): with the taker exhausted and its last
          // maker emptied, the next best maker whose price >= limit (either
          // direction) gives one zero-size fill
          const Key3 ghost = lexmin(
              occ_opp, tid, wsz, pp, qq,
              [&](int, int w, int32_t p, int q, int& k1, int& k2) {
                k1 = wmul(p, sgn);
                k2 = q;
                return w > 0;
              });
          if (ghost.k1 < BIG && pp[ghost.k3] >= limit) {
            if (nfill >= a.E) {
              g.set_err(LERR_JAVA_CAP);
            } else {
              __syncwarp();
              if (tid == 0) {
                fslot[nfill] = ghost.k3;
                fsize[nfill] = 0;
              }
              __syncwarp();
              ++nfill;
            }
          }
        }

        // capacity envelope + Q9 bucket-tail echo (own side): the lowest
        // free slot, and of the live orders at `limit` the highest seq's
        // lowest slot. A merged (Q1) book sees the sweep's sizes on its
        // own side too.
        int ffree = BIG;
        const Key3 tail = lexmin(
            occ_own, tid,
            merged ? wsz : st_own ? ow : a.bs + base_own,
            merged ? pp : st_own ? op : a.bp + base_own,
            merged ? qq : st_own ? oq : a.bq + base_own,
            [&](int flat, int w, int32_t p, int q, int& k1, int& k2) {
              if (w == 0) ffree = min(ffree, flat);
              k1 = ~q;   // highest seq first
              k2 = 0;
              return w > 0 && p == limit;
            });
        int free_flat = wmin(ffree);
        // no hole below occ: the first slot above it, unless the side is
        // full
        if (free_flat >= BIG && occ_own < NR) free_flat = occ_own * LN;
        const bool nonempty = tail.k3 < BIG;
        const int tfc = nonempty ? tail.k3 : 0;
        tail_lo = a.bo_lo[base_own + tfc];
        tail_hi = a.bo_hi[base_own + tfc];
        const bool rest_want = t_ok && residual > 0;
        const bool over = t_ok && (ovf || (rest_want && free_flat >= BIG));
        if (JAVA) {
          if (over) g.set_err(LERR_JAVA_CAP);  // fatal, never a reject
        } else {
          capr = over;
        }
        t_acc = t_ok && !capr;
        do_rest = rest_want && t_acc && free_flat < BIG;
        append = nonempty && do_rest;

        // phase 2: apply
        if (t_acc) {
          // the taker's balance: no one else's moves in a trade, so it
          // is carried in a register and stored once
          int64_t nbal = sub64(bal, risk);
          if (JAVA) {
            // 3-argument setPosition: the real key keeps its amount
            if (adj != 0) g.jwrite(e_actor, real, pamt, sub64(pav, adj));
          } else if (adj != 0 &&
                     g.pos_set(e_actor, lane, acc, pamt, sub64(pav, adj))) {
            g.set_err(LERR_HASH_FULL);
          }
          __syncwarp();
          for (int r = 0; r < occ_opp; ++r)
            st4(a.bs + base_opp + r * LN + 4 * tid,
                ld4(wsz + r * LN + 4 * tid));
          __syncwarp();
          for (int e2 = 0; e2 < nfill; ++e2) {
            const int flat = fslot[e2];
            const int32_t fill = fsize[e2];
            const int maid = JAVA ? a.ba[base_opp + flat] & AMASK
                                  : a.ba[base_opp + flat];
            const int32_t mprice = a.bp[base_opp + flat];
            const int pf = fill_total + e2;
            if (pf < a.FB && tid == 0) {
              int32_t* fr = out + (size_t)(1 + 5 * BR + (pf >> 7) * 5) * LN +
                            (pf & 127);
              fr[0] = a.bo_lo[base_opp + flat];
              fr[LN] = a.bo_hi[base_opp + flat];
              fr[2 * LN] = maid;
              fr[3 * LN] = mprice;
              fr[4 * LN] = fill;
            }
            const int32_t msz = is_buy ? wneg(fill) : fill;
            bool me, te;
            if (JAVA) {
              me = g.jfill_one(make_int4(a.araw_lo[maid], a.araw_hi[maid],
                                         real.z, real.w),
                               msz);
              te = g.jfill_one(real, wneg(msz));
            } else {
              me = g.fill_one(lane, maid, msz);
              te = g.fill_one(lane, acc, wneg(msz));
            }
            nbal = add64(nbal, (int64_t)wmul(wneg(msz), wsub(limit, mprice)));
            if (me || te) g.set_err(LERR_HASH_FULL);
          }
          sput64(a.bal_lo, a.bal_hi, acc, nbal);
          if (fill_total + nfill > a.FB) g.set_err(LERR_FILLBUF_FULL);
          if (do_rest) {
            const int s = base_own + free_flat;
            __syncwarp();
            if (tid == 0) {
              a.bo_lo[s] = t_oidlo;
              a.bo_hi[s] = t_oidhi;
              a.ba[s] = JAVA ? acc | ((int32_t)is_buy << 30) : acc;
              a.bp[s] = limit;
              a.bs[s] = residual;
              a.bq[s] = seqv;
              a.seqc[lane] = wadd(seqv, 1);
              if (deep && free_flat / LN + 1 > occ_own)
                a.occ[2 * lane + side] = free_flat / LN + 1;
            }
            __syncwarp();
          }
          resid_v = residual;
          nf = nfill;
          nempt_v = nempt;
        }
      }

      // ---- CANCEL
      if (is_cancel) {
        int f[2];
        for (int s = 0; s < 2; ++s) {
          const int bb = (lane * 2 * NR + s * NR) * LN;
          int loc = BIG;
          for (int r = 0; r < (s ? occ1 : occ0); ++r) {
            int4 w4 = ld4(a.bs + bb + r * LN + 4 * tid);
            int4 l4 = ld4(a.bo_lo + bb + r * LN + 4 * tid);
            int4 h4 = ld4(a.bo_hi + bb + r * LN + 4 * tid);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (el(w4, j) > 0 && el(l4, j) == t_oidlo && el(h4, j) == t_oidhi)
                loc = min(loc, r * LN + 4 * tid + j);
          }
          f[s] = wmin(loc);
        }
        const int c_side = f[0] < BIG ? 0 : 1;
        const int c_flat = f[c_side];
        const int cb = (lane * 2 * NR + c_side * NR) * LN;
        const int32_t c_ba = c_flat < BIG ? a.ba[cb + c_flat] : -1;
        if (c_flat < BIG && (JAVA ? c_ba & AMASK : c_ba) == acc) {
          c_ok = true;
          // merged (Q1) books hold both directions in side 0, so java reads
          // the direction from the ba tag bit
          const bool c_isbuy = JAVA ? ((c_ba >> 30) & 1) != 0 : c_side == 0;
          const int32_t c_price = a.bp[cb + c_flat];
          const int32_t c_size = a.bs[cb + c_flat];
          sput(a.bs, cb + c_flat, 0);
          g.bal_add(acc, JAVA ? g.jrelease_margin(real, c_isbuy, c_price,
                                                  c_size)
                              : g.release_margin(lane, acc, c_isbuy, c_price,
                                                 c_size));
        }
      }

      // ---- BARRIERS (payout / remove; never routed in java mode)
      const bool barrier_do = !JAVA && is_barrier && bex_v;
      if (barrier_do) {
        // wipe both sides with margin release: buy side first, (price,
        // seq) order within a side
        for (int ws = 0; ws < 2; ++ws) {
          const int bb = (lane * 2 * NR + ws * NR) * LN;
          while (true) {
            const Key3 first = lexmin(
                ws ? occ1 : occ0, tid, a.bs + bb, a.bp + bb, a.bq + bb,
                [&](int, int w, int32_t p, int q, int& k1, int& k2) {
                  k1 = p;
                  k2 = q;
                  return w > 0;
                });
            if (first.k1 >= BIG) break;
            const int fc = first.k3;
            const int o_aid = a.ba[bb + fc];
            const int32_t o_price = a.bp[bb + fc], o_size = a.bs[bb + fc];
            sput(a.bs, bb + fc, 0);
            g.bal_add(o_aid, g.release_margin(lane, o_aid, ws == 0, o_price,
                                              o_size));
          }
        }
        sput(a.bex, lane, 0);
        if (deep) {   // both sides are empty now
          sput(a.occ, 2 * lane, 0);
          sput(a.occ, 2 * lane + 1, 0);
        }
        if (act != L_REMOVE_SYMBOL) {
          // payout: credit (YES) / just delete (NO) the lane's positions
          // — a hash scan; a zeroed amt/avail IS deletion (keys stay).
          // Each live entry is a distinct account, so lanes credit their
          // own columns' accounts without conflict.
          const int klo = lane * a.A + 1;
          const bool credit = act == L_PAYOUT_YES;
          __syncwarp();
          for (int tr = 0; tr < a.CAPR; ++tr) {
            const int o = tr * LN + 4 * tid;
            int4 k4 = ld4(a.hk + o);
            bool mine[4], any = false;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              mine[j] = el(k4, j) >= klo && el(k4, j) < klo + a.A;
              any |= mine[j];
            }
            if (!__any_sync(FULL, any)) continue;
            if (credit) {
              int4 lo4 = ld4(a.ha_lo + o), hi4 = ld4(a.ha_hi + o);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int64_t amt = j64(el(lo4, j), el(hi4, j));
                if (mine[j] && amt != 0) {
                  const int acc2 = el(k4, j) - klo;
                  const int64_t v = add64(
                      j64(a.bal_lo[acc2], a.bal_hi[acc2]),
                      (int64_t)((uint64_t)amt * (uint64_t)(int64_t)size));
                  a.bal_lo[acc2] = (int32_t)(uint32_t)(uint64_t)v;
                  a.bal_hi[acc2] = (int32_t)(uint32_t)((uint64_t)v >> 32);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (mine[j]) {
                a.ha_lo[o + j] = 0;
                a.ha_hi[o + j] = 0;
                a.hv_lo[o + j] = 0;
                a.hv_hi[o + j] = 0;
              }
            }
          }
          __syncwarp();
        }
      }

      // ---- dep plane (fixed mode) + histograms + outputs + metrics
      if (t_acc) hist_obs(HIST_LANE0, nf);
      if (!JAVA && (t_acc || c_ok || barrier_do)) {
        const int32_t newd =
            barrier_do ? 0
                       : wsub(wsub(wadd(a.dep[lane], (int32_t)do_rest), nempt_v),
                              (int32_t)c_ok);
        sput(a.dep, lane, newd);
        if (t_acc || c_ok) hist_obs(HIST_LANE0 + NB, newd);
      }
      bool ok;
      if (is_trade) ok = t_acc;
      else if (is_cancel) ok = c_ok;
      else if (act == L_CREATE) ok = create_ok;
      else if (act == L_TRANSFER) ok = transfer_ok;
      else if (act == L_ADD_SYMBOL) ok = addsym_ok;
      else if (is_barrier) ok = barrier_do;
      else ok = act == L_NOP;
      if (tid == 0) {
        out[(size_t)(1 + 0 * BR) * LN + m] =
            (int32_t)ok | ((int32_t)capr << 1) | ((int32_t)append << 2);
        out[(size_t)(1 + 1 * BR) * LN + m] = resid_v;
        out[(size_t)(1 + 2 * BR) * LN + m] = nf;
        out[(size_t)(1 + 3 * BR) * LN + m] = tail_lo;
        out[(size_t)(1 + 4 * BR) * LN + m] = tail_hi;
      }
      met[0] = wadd(met[0], act != L_NOP);
      met[1] = wadd(met[1], t_acc);
      met[2] = wadd(met[2], nf);
      met[3] = wadd(met[3], t_acc ? wsub(size, resid_v) : 0);
      met[4] = wadd(met[4], capr);
      met[5] = wadd(met[5], is_trade && !t_ok);
      met[6] = wadd(met[6], do_rest);
      met[7] = wadd(met[7], c_ok);
      met[8] = wadd(met[8], is_cancel && !c_ok);
      met[9] = wadd(met[9], transfer_ok);
      met[10] = wadd(met[10], (act == L_CREATE && !create_ok) ||
                                  (act == L_TRANSFER && !transfer_ok) ||
                                  (act == L_ADD_SYMBOL && !addsym_ok));
      met[11] = wadd(met[11], barrier_do);
      fill_total += nf;
    }

    // batch occupancy: ONE observation per non-empty call
    if (met[0] > 0) hist_obs(HIST_LANE0 + 2 * NB, met[0]);
    __syncwarp();
    const int32_t errv = a.err[0];
    int32_t row[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tid + j;
      int32_t v = hist[j];   // zero outside the histogram window
      if (c == 0) v = errv;
      if (c == 1) v = fill_total;
#pragma unroll
      for (int i = 0; i < N_METRICS; ++i)
        if (c == 2 + i) v = met[i];
      row[j] = v;
    }
    st4(out + 4 * tid, make_int4(row[0], row[1], row[2], row[3]));
    __syncwarp();
  }
}

// occ[lane][side] = one more than the highest of the side's NR rows that
// holds a nonzero size (0: the side is empty). One block per (lane, side).
__global__ void __launch_bounds__(256)
    rows_in_use_kernel(const int32_t* __restrict__ bs,
                       int32_t* __restrict__ occ, int NR) {
  const int32_t* side = bs + (size_t)blockIdx.x * NR * LN;
  int top = 0;
  for (int i = threadIdx.x; i < NR * (LN / 4); i += blockDim.x) {
    const int4 v = ld4(side + 4 * i);
    if ((v.x | v.y | v.z | v.w) != 0) top = max(top, i / (LN / 4) + 1);
  }
  __shared__ int part[8];
  top = wmax(top);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = top;
  __syncthreads();
  if (threadIdx.x < 32) {
    top = wmax(threadIdx.x < 8 ? part[threadIdx.x] : 0);
    if (threadIdx.x == 0) occ[blockIdx.x] = top;
  }
}

template <bool JAVA>
int launch(const Args& a, void* stream) {
  const size_t smem =
      (size_t)(a.NR + 2 + 5 * a.STAGE) * LN * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        seq_scan_kernel<JAVA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  seq_scan_kernel<JAVA>
      <<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// dims = K, S, NR, A, E, B, CAPR, FB, PROBE, STAGE
void set_dims(Args& a, const int* dims) {
  a.K = dims[0];
  a.S = dims[1];
  a.NR = dims[2];
  a.A = dims[3];
  a.E = dims[4];
  a.B = dims[5];
  a.CAPR = dims[6];
  a.FB = dims[7];
  a.PROBE = dims[8];
  a.STAGE = dims[9];
}

}  // namespace

// Plain C entries. They return the launch's cudaGetLastError() (0 =
// launched). Fixed mode: ptrs = 7 message columns (K, B), 18 state
// planes, the (K, rows, 128) output, the (S, 2) rows-in-use scratch
// (filled by kme_rows_in_use on the same stream when NR > 1).
extern "C" int kme_seq_scan(void** ptrs, int nptrs, const int* dims,
                            int ndims, void* stream) {
  if (nptrs != 27 || ndims != 10) return (int)cudaErrorInvalidValue;
  Args a = {};
  int i = 0;
  const int32_t** msg[7] = {&a.act, &a.oidlo, &a.oidhi, &a.aid,
                            &a.price, &a.size, &a.lane};
  for (auto p : msg) *p = static_cast<const int32_t*>(ptrs[i++]);
  int32_t** st[18] = {&a.bo_lo, &a.bo_hi, &a.ba,   &a.bp,     &a.bs,
                      &a.bq,    &a.seqc,  &a.bex,  &a.bal_lo, &a.bal_hi,
                      &a.bal_u, &a.hk,    &a.ha_lo, &a.ha_hi, &a.hv_lo,
                      &a.hv_hi, &a.dep,   &a.err};
  for (auto p : st) *p = static_cast<int32_t*>(ptrs[i++]);
  a.out = static_cast<int32_t*>(ptrs[i++]);
  a.occ = static_cast<int32_t*>(ptrs[i++]);
  set_dims(a, dims);
  return launch<false>(a, stream);
}

// Java mode: ptrs = 12 message columns (the 7 of fixed mode, aidr lo/hi,
// sidr lo/hi, flags), 25 state planes, the output, the scratch.
extern "C" int kme_seq_scan_java(void** ptrs, int nptrs, const int* dims,
                                 int ndims, void* stream) {
  if (nptrs != 39 || ndims != 10) return (int)cudaErrorInvalidValue;
  Args a = {};
  int i = 0;
  const int32_t** msg[12] = {&a.act,    &a.oidlo,  &a.oidhi, &a.aid,
                             &a.price,  &a.size,   &a.lane,  &a.aidrlo,
                             &a.aidrhi, &a.sidrlo, &a.sidrhi, &a.flags};
  for (auto p : msg) *p = static_cast<const int32_t*>(ptrs[i++]);
  int32_t** st[25] = {&a.bo_lo,   &a.bo_hi,   &a.ba,      &a.bp,
                      &a.bs,      &a.bq,      &a.seqc,    &a.bex,
                      &a.bal_lo,  &a.bal_hi,  &a.bal_u,   &a.hka_lo,
                      &a.hka_hi,  &a.hkb_lo,  &a.hkb_hi,  &a.hstate,
                      &a.ha_lo,   &a.ha_hi,   &a.hv_lo,   &a.hv_hi,
                      &a.araw_lo, &a.araw_hi, &a.sraw_lo, &a.sraw_hi,
                      &a.err};
  for (auto p : st) *p = static_cast<int32_t*>(ptrs[i++]);
  a.out = static_cast<int32_t*>(ptrs[i++]);
  a.occ = static_cast<int32_t*>(ptrs[i++]);
  set_dims(a, dims);
  return launch<true>(a, stream);
}

// The rows-in-use prologue: bs (sides * NR, 128) -> occ (sides,), sides =
// 2 * lanes.
extern "C" int kme_rows_in_use(const void* bs, void* occ, int sides, int NR,
                               void* stream) {
  if (sides <= 0 || NR <= 0) return (int)cudaErrorInvalidValue;
  rows_in_use_kernel<<<sides, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bs), static_cast<int32_t*>(occ), NR);
  return (int)cudaGetLastError();
}
