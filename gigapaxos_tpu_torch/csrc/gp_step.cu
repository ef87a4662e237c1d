// gp_step.cu — the consensus step as one hand-written CUDA kernel (sm_90a).
//
// Replaces the JAX package's device program (what XLA fused per dispatch):
//   * gigapaxos_tpu/ops/engine.py:step            (one consensus round, all G
//     groups of one replica: promise, R-peer fold, accept, learn, in-order
//     execute, majority frontier, election / carryover / hole no-ops /
//     retire / preempt, stop gating, K-lane admission, non-member freeze);
//   * gigapaxos_tpu/ops/engine.py:_decode_lanes / _decode_coord (the
//     compact-blob decode, folded into the peer loop one row at a time);
//   * gigapaxos_tpu/ops/engine.py:make_blob + pack_blob (the compact encode,
//     fused here as the epilogue, written straight into the [NB] vector in
//     Blob._fields order == the D wire-frame body);
//   * the heat accumulator of gigapaxos_tpu/parallel/spmd.py:_build_packed
//     (optional pointer: heat += n_committed + n_admitted).
// gp_make_blob_kernel is make_blob + pack_blob alone (initial blob, the
// manager's publish snapshot, the stacked face's first exchange).
//
// Bound.  The step is all-int32 control logic with no matrix products: it
// moves bytes and does little arithmetic, so device-memory bandwidth bounds
// it.  Per group per replica-step it reads the state (12 + 7W words), the R
// gathered blob rows (R * (4 + 4W)), K request words, and writes the state,
// the out vector (6 + 3W) and the blob (4 + 4W).
//
// Design.  One thread per (group, ring lane): W consecutive lanes of a warp
// form one group's segment (one warp per group at W = 32, 32/W groups per
// warp below that), so every [G, W] plane is read and written as coalesced
// 128-byte rows and every [G] value is a segment-uniform broadcast load.
// Reductions over the ring (any, masked max, lane lookups) are
// __ballot_sync / __shfl_*_sync with width = W.  The R-peer fold runs as a
// loop inside the thread with its carries in registers; the carryover fold
// (second pass over the peers) runs only in segments that reached a prepare
// quorum, since its result is used nowhere else.  The W-offset execute loop
// and the K admission loop stop as soon as no segment of the warp can take
// another slot (exact: after the first miss nothing more is taken).
// State is written out of place: the kernel never writes a buffer it reads.
// The kernel allocates nothing and launches on the caller's stream.
//
// Integer semantics match XLA's int32 exactly: additions, subtractions,
// multiplications and left shifts wrap (done in uint32 and reinterpreted);
// right shifts of signed values stay arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

#define GP_NLEAF 19
#define GP_BLOCK 128

struct GpStepArgs {
  const int32_t* st_in[GP_NLEAF];  // EngineState._fields order
  int32_t* st_out[GP_NLEAF];
  const int32_t* gathered;  // [R, NB] compact blob rows
  const uint8_t* heard;     // [R] bool (stacked: [R, R], row = replica)
  const int32_t* req;       // [G, K] (stacked: [R, G, K])
  const uint8_t* want;      // [G] bool (stacked: [R, G])
  int32_t* out_vec;         // [M] StepOutputs._fields order (stacked: [R, M])
  int32_t* blob;            // [NB] Blob._fields order, or null (stacked: [R, NB])
  const int32_t* heat_in;   // [G] or null
  int32_t* heat_out;        // [G] or null (may alias heat_in)
  int32_t G, W, K, R, my_id, stacked;
};

struct GpBlobArgs {
  const int32_t* st_in[GP_NLEAF];
  int32_t* blob;            // [NB] (stacked: [n_rep, NB])
  int32_t G, W, n_rep;
};

namespace {

// EngineState leaf indices
enum {
  L_MEMBER_MASK, L_MAJORITY, L_VERSION, L_STOPPED, L_TAG, L_BAL, L_EXEC_SLOT,
  L_ACC_BAL, L_ACC_VID, L_ACC_SLOT, L_DEC_VID, L_DEC_SLOT, L_APP_HASH,
  L_N_EXECD, L_C_PHASE, L_C_BAL, L_C_NEXT_SLOT, L_C_PROP_VID, L_C_PROP_SLOT
};

constexpr int32_t NULLV = -1;
constexpr int32_t BIG = 1 << 30;
constexpr int32_t STOP_BIT = 1 << 30;
constexpr int32_t NOOP_VID = 0;
constexpr int32_t WRAP_MAX = 15;
constexpr int32_t WRAP_BIAS = 16;
constexpr int32_t DELTA_MAX = 0xFFFE;
constexpr int32_t INT32_MIN_V = (int32_t)0x80000000u;
constexpr int IDLE = 0, PREPARING = 1, ACTIVE = 2;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t shl32(int32_t a, int s) {
  return (int32_t)((uint32_t)a << s);
}
__device__ __forceinline__ int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
__device__ __forceinline__ int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

// (h * 31 + vid) ^ (vid << 7), int32 wraparound
__device__ __forceinline__ int32_t mix32(int32_t h, int32_t v) {
  return (int32_t)(((uint32_t)h * 31u + (uint32_t)v) ^ ((uint32_t)v << 7));
}

// one sender's lane planes from its meta word + anchors (_decode_lanes)
__device__ __forceinline__ int32_t wrap_dec(int32_t w, int32_t ebase, int kbits, int j) {
  return w != 0 ? (shl32(add32(ebase, w - WRAP_BIAS), kbits) | j) : NULLV;
}

__device__ __forceinline__ void decode_lane(int32_t meta, int32_t pbal, int32_t pexec,
                                            int j, int kbits, int32_t& a_bal,
                                            int32_t& a_slot, int32_t& d_slot,
                                            int32_t& p_slot) {
  const int32_t d = meta & 0xFFFF;
  const int32_t aw = (meta >> 16) & 31;
  const int32_t dw = (meta >> 21) & 31;
  const int32_t pw = (meta >> 26) & 31;
  const int32_t eb = pexec >> kbits;
  a_bal = d != 0 ? sub32(pbal, d - 1) : NULLV;
  a_slot = wrap_dec(aw, eb, kbits, j);
  d_slot = wrap_dec(dw, eb, kbits, j);
  p_slot = wrap_dec(pw, eb, kbits, j);
}

__device__ __forceinline__ int32_t wrap_enc(int32_t slot, int32_t ebase, int kbits, bool& ok) {
  const int32_t c = sub32(slot >> kbits, ebase);
  ok = (slot != NULLV) && (c >= -WRAP_MAX) && (c <= WRAP_MAX);
  return ok ? c + WRAP_BIAS : 0;
}

// make_blob of one (group, lane): writes the lane's four [G, W] blob words
// and, from lane 0, the four [G] words.  blob points at this replica's row.
__device__ __forceinline__ void encode_blob(
    int32_t* blob, long long G, long long GW, long long g, int j, int kbits,
    int32_t tag, int32_t bal, int32_t exec_slot, int32_t c_phase, int32_t c_bal,
    int32_t acc_bal, int32_t acc_vid, int32_t acc_slot, int32_t dec_vid,
    int32_t dec_slot, int32_t c_prop_vid, int32_t c_prop_slot, int W) {
  const int32_t eb = exec_slot >> kbits;
  bool acc_in, dec_ok, prop_ok;
  int32_t acc_w = wrap_enc(acc_slot, eb, kbits, acc_in);
  const int32_t delta = sub32(bal, acc_bal);
  const bool acc_ok = acc_in && acc_bal != NULLV && delta >= 0 && delta <= DELTA_MAX;
  acc_w = acc_ok ? acc_w : 0;
  const int32_t acc_d = acc_ok ? delta + 1 : 0;
  const int32_t dec_w = wrap_enc(dec_slot, eb, kbits, dec_ok);
  const bool preparing = c_phase == PREPARING;
  const bool active = c_phase == ACTIVE;
  const int32_t prop_w = wrap_enc(active ? c_prop_slot : NULLV, eb, kbits, prop_ok);
  const int32_t meta = acc_d | shl32(acc_w, 16) | shl32(dec_w, 21) | shl32(prop_w, 26);
  const long long lo = g * W + j;
  blob[4 * G + lo] = acc_ok ? acc_vid : NULLV;
  blob[4 * G + GW + lo] = dec_ok ? dec_vid : NULLV;
  blob[4 * G + 2 * GW + lo] = prop_ok ? c_prop_vid : NULLV;
  blob[4 * G + 3 * GW + lo] = meta;
  if (j == 0) {
    blob[g] = tag;
    blob[G + g] = bal;
    blob[2 * G + g] = exec_slot;
    blob[3 * G + g] = preparing ? c_bal : (active ? (c_bal | INT32_MIN_V) : NULLV);
  }
}

__device__ __forceinline__ int32_t seg_max(int32_t v, int W) {
  for (int off = W >> 1; off > 0; off >>= 1)
    v = imax(v, __shfl_xor_sync(FULL, v, off, W));
  return v;
}

__global__ void __launch_bounds__(GP_BLOCK) gp_step_kernel(const GpStepArgs a) {
  const int W = a.W, K = a.K, R = a.R;
  const long long G = a.G;
  const int kbits = __ffs(W) - 1;
  const int t = threadIdx.x;
  const int j = t & (W - 1);
  const int segbase = (t & 31) & ~(W - 1);
  const unsigned segmask = (W == 32) ? FULL : (((1u << W) - 1u) << segbase);
  const long long g_raw = (long long)blockIdx.x * (GP_BLOCK / W) + t / W;
  const bool valid = g_raw < G;
  // lanes past the last group compute on group G-1 (every lane must take
  // part in the warp shuffles) and write nothing
  const long long g = valid ? g_raw : G - 1;
  const int rep = a.stacked ? (int)blockIdx.y : 0;
  const int my_id = a.stacked ? rep : a.my_id;
  const long long GW = G * W;
  const long long NB = 4 * G + 4 * GW;
  const long long M = 6 * G + 3 * GW;
  const long long ig = (long long)rep * G + g;
  const long long igw = (long long)rep * GW + g * W + j;

  const int32_t member_mask = a.st_in[L_MEMBER_MASK][ig];
  const int32_t majority = a.st_in[L_MAJORITY][ig];
  const int32_t version = a.st_in[L_VERSION][ig];
  const int32_t stopped0 = a.st_in[L_STOPPED][ig];
  const int32_t tag = a.st_in[L_TAG][ig];
  const int32_t bal0 = a.st_in[L_BAL][ig];
  const int32_t exec0 = a.st_in[L_EXEC_SLOT][ig];
  const int32_t acc_bal0 = a.st_in[L_ACC_BAL][igw];
  const int32_t acc_vid0 = a.st_in[L_ACC_VID][igw];
  const int32_t acc_slot0 = a.st_in[L_ACC_SLOT][igw];
  const int32_t dec_vid0 = a.st_in[L_DEC_VID][igw];
  const int32_t dec_slot0 = a.st_in[L_DEC_SLOT][igw];
  const int32_t app_hash0 = a.st_in[L_APP_HASH][ig];
  const int32_t n_execd0 = a.st_in[L_N_EXECD][ig];
  const int32_t c_phase0 = a.st_in[L_C_PHASE][ig];
  const int32_t c_bal0 = a.st_in[L_C_BAL][ig];
  const int32_t c_next0 = a.st_in[L_C_NEXT_SLOT][ig];
  const int32_t c_prop_vid0 = a.st_in[L_C_PROP_VID][igw];
  const int32_t c_prop_slot0 = a.st_in[L_C_PROP_SLOT][igw];

  const uint8_t* heard = a.heard + (a.stacked ? (long long)rep * R : 0);
  const int32_t* gv = a.gathered;

  // ---- live senders + 1. promise ----
  unsigned live_bits = 0;
  int32_t max_prep = INT32_MIN_V, max_prop = INT32_MIN_V;
  for (int r = 0; r < R; ++r) {
    const int32_t* row = gv + (long long)r * NB;
    const int32_t pcoord = row[3 * G + g];
    const bool lv = heard[r] != 0 && ((member_mask >> r) & 1) && row[g] == tag;
    live_bits |= (lv ? 1u : 0u) << r;
    const int32_t prep = pcoord >= 0 ? pcoord : NULLV;
    const int32_t prop = (pcoord < 0 && pcoord != NULLV) ? (pcoord & 0x7FFFFFFF) : NULLV;
    max_prep = imax(max_prep, lv ? prep : NULLV);
    max_prop = imax(max_prop, lv ? prop : NULLV);
  }
  int32_t new_bal = imax(bal0, imax(max_prep, max_prop));
  unsigned win_bits = 0;
  if (max_prop != NULLV) {
    for (int r = 0; r < R; ++r) {
      const int32_t pcoord = gv[(long long)r * NB + 3 * G + g];
      const bool lv = (live_bits >> r) & 1;
      const int32_t prop = (pcoord < 0 && pcoord != NULLV) ? (pcoord & 0x7FFFFFFF) : NULLV;
      win_bits |= ((lv ? prop : NULLV) == max_prop ? 1u : 0u) << r;
    }
  }

  // ---- 2+3. the peer fold: accept winner, learn, decision-ring merge ----
  int32_t p_slot = NULLV, p_vid = NULLV;
  int32_t s_c = NULLV, b_c = NULLV, det_vid = NULLV, n_match = 0;
  int32_t c1_s = BIG, c1_v = NULLV;
  const long long lo = g * W + j;
  for (int r = 0; r < R; ++r) {
    const int32_t* row = gv + (long long)r * NB;
    const int32_t pbal = row[G + g];
    const int32_t pexec = row[2 * G + g];
    const int32_t a_vid = row[4 * G + lo];
    const int32_t d_vid = row[4 * G + GW + lo];
    const int32_t pr_vid = row[4 * G + 2 * GW + lo];
    const int32_t meta = row[4 * G + 3 * GW + lo];
    int32_t a_bal, a_slot, d_slot, pr_slot;
    decode_lane(meta, pbal, pexec, j, kbits, a_bal, a_slot, d_slot, pr_slot);
    const bool lv = (live_bits >> r) & 1;
    const bool w = (win_bits >> r) & 1;
    p_slot = imax(p_slot, w ? pr_slot : NULLV);
    p_vid = imax(p_vid, w ? pr_vid : NULLV);
    const bool ok = lv && a_slot != NULLV;
    const int32_t s_r = ok ? a_slot : NULLV;
    const int32_t b_r = ok ? a_bal : NULLV;
    const bool better = ok && (s_r > s_c || (s_r == s_c && b_r > b_c));
    const bool same = ok && s_r == s_c && b_r == b_c;
    n_match = better ? 1 : n_match + (same ? 1 : 0);
    if (better) { s_c = s_r; b_c = b_r; det_vid = a_vid; }
    const bool okd = lv && d_slot != NULLV && d_slot >= exec0;
    if (okd && d_slot < c1_s) { c1_s = d_slot; c1_v = d_vid; }
  }
  const bool detected = n_match >= majority && s_c != NULLV;

  // ---- 2. accept ----
  const bool acc_ok = max_prop == new_bal && max_prop != NULLV && stopped0 == 0;
  const bool in_win = p_slot >= exec0 && p_slot < add32(exec0, W) && p_vid != NULLV;
  const bool do_acc = acc_ok && in_win;
  const int32_t acc_bal = do_acc ? max_prop : acc_bal0;
  const int32_t acc_vid = do_acc ? p_vid : acc_vid0;
  const int32_t acc_slot = do_acc ? p_slot : acc_slot0;
  const bool acc_changed = do_acc && (acc_bal != acc_bal0 || acc_vid != acc_vid0 ||
                                      acc_slot != acc_slot0);

  // ---- 3. learn ----
  const int32_t c0_s = (dec_slot0 != NULLV && dec_slot0 >= exec0) ? dec_slot0 : BIG;
  const int32_t c2_s = (detected && s_c != NULLV && s_c >= exec0) ? s_c : BIG;
  const int32_t best = imin(imin(c0_s, c1_s), c2_s);
  const bool have = best < BIG;
  const int32_t dec_vid = have ? (best == c0_s ? dec_vid0 : (best == c1_s ? c1_v : det_vid))
                               : dec_vid0;
  const int32_t dec_slot = have ? best : dec_slot0;

  // ---- 4. execute: advance the in-order frontier ----
  int32_t h = app_hash0, n_execd = n_execd0, n_adv = 0;
  bool stop_seen = false, run_prev = true, my_run = false;
  int32_t my_vid_at = NULLV;
  for (int o = 0; o < W; ++o) {
    if (!__any_sync(FULL, run_prev)) break;
    const int32_t slot_o = add32(exec0, o);
    const bool eq = dec_slot == slot_o;
    const bool hit = (__ballot_sync(FULL, eq) & segmask) != 0;
    const int32_t v = seg_max(eq ? dec_vid : NULLV, W);
    const bool take = run_prev && hit;
    if (take && v > 0) { h = mix32(h, v); n_execd = add32(n_execd, 1); }
    stop_seen = stop_seen || (take && (v & STOP_BIT) != 0);
    n_adv += take ? 1 : 0;
    if (j == o) { my_run = take; my_vid_at = v; }
    run_prev = take;
  }
  const int32_t exec_new = add32(exec0, n_adv);
  const int32_t stopped = imax(stopped0, stop_seen ? 1 : 0);

  // ---- majority-rank execute frontier (O(R^2) rank count) ----
  int32_t maj_exec = INT32_MIN_V;
  for (int x = 0; x < R; ++x) {
    const int32_t ge_x = ((live_bits >> x) & 1) ? gv[(long long)x * NB + 2 * G + g] : NULLV;
    int rank = 0;
    for (int y = 0; y < R; ++y) {
      const int32_t ge_y = ((live_bits >> y) & 1) ? gv[(long long)y * NB + 2 * G + g] : NULLV;
      rank += ge_x <= ge_y ? 1 : 0;
    }
    maj_exec = imax(maj_exec, rank >= majority ? ge_x : NULLV);
  }
  maj_exec = imax(maj_exec, 0);

  // ---- 5. coordinator ----
  int32_t phase = c_phase0;
  if (phase != IDLE && new_bal > c_bal0) phase = IDLE;  // preempted
  const bool inert = member_mask == 0;
  const bool orphaned = (new_bal & 31) == my_id && new_bal != NULLV;
  const bool want = a.want[(long long)rep * G + g] != 0;
  const bool start = (want || orphaned) && phase == IDLE && !inert && stopped == 0;
  const int32_t start_bal = shl32(add32(new_bal >> 5, 1), 5) | my_id;
  const int32_t c_bal = start ? start_bal : c_bal0;
  if (start) phase = PREPARING;
  if (phase == PREPARING) new_bal = imax(new_bal, c_bal);

  unsigned prom_bits = 0;
  int32_t n_promise = 1, prom_exec = INT32_MIN_V;
  for (int r = 0; r < R; ++r) {
    const int32_t* row = gv + (long long)r * NB;
    const bool pr = row[G + g] == c_bal && ((live_bits >> r) & 1) && r != my_id;
    prom_bits |= (pr ? 1u : 0u) << r;
    n_promise += pr ? 1 : 0;
    prom_exec = imax(prom_exec, pr ? row[2 * G + g] : NULLV);
  }
  const bool won = phase == PREPARING && n_promise >= majority;

  // carryover: only read where it is used (segments that won a quorum)
  int32_t co_slot = NULLV, co_bal = NULLV, co_vid = NULLV;
  if (won) {
    for (int r = 0; r < R; ++r) {
      if (!((prom_bits >> r) & 1)) continue;
      const int32_t* row = gv + (long long)r * NB;
      int32_t a_bal, a_slot, d_slot, pr_slot;
      decode_lane(row[4 * G + 3 * GW + lo], row[G + g], row[2 * G + g], j, kbits,
                  a_bal, a_slot, d_slot, pr_slot);
      const bool ok = a_slot != NULLV && a_slot >= exec0;
      if (ok && (a_slot > co_slot || (a_slot == co_slot && a_bal > co_bal))) {
        co_slot = a_slot; co_bal = a_bal; co_vid = row[4 * G + lo];
      }
    }
    const bool my_ok = acc_slot != NULLV && acc_slot >= exec0;
    if (my_ok && (acc_slot > co_slot || (acc_slot == co_slot && acc_bal > co_bal))) {
      co_slot = acc_slot; co_bal = acc_bal; co_vid = acc_vid;
    }
  }
  const bool co_has = co_slot != NULLV;
  if (won) phase = ACTIVE;
  const int32_t floor_ = imax(exec_new, prom_exec);
  int32_t c_prop_vid = won ? (co_has ? co_vid : NULLV) : c_prop_vid0;
  int32_t c_prop_slot = won ? (co_has ? co_slot : NULLV) : c_prop_slot0;
  const int32_t max_co_slot = seg_max(co_slot, W);
  const int32_t next_on_win = imax(floor_, add32(max_co_slot, 1));
  int32_t c_next = won ? next_on_win : c_next0;

  // hole-filling no-ops in [floor, next)
  const int32_t exp_slot = add32(exec_new, sub32(j, exec_new) & (W - 1));
  if (won && exp_slot >= floor_ && exp_slot < c_next && c_prop_slot != exp_slot &&
      dec_slot != exp_slot) {
    c_prop_vid = NOOP_VID;
    c_prop_slot = exp_slot;
  }

  // retire learned / below-frontier proposals; surface preempted vids
  const bool is_active = phase == ACTIVE;
  const bool retire = c_prop_slot != NULLV && (dec_slot == c_prop_slot || c_prop_slot < exec0);
  const int32_t preempted =
      (retire && dec_vid != c_prop_vid && c_prop_vid > 0) ? c_prop_vid : NULLV;
  if (retire) { c_prop_vid = NULLV; c_prop_slot = NULLV; }

  // stop-request ordering
  const bool stopping =
      (__ballot_sync(FULL, c_prop_vid != NULLV && (c_prop_vid & STOP_BIT) != 0) & segmask) != 0;
  const bool dec_stop =
      (__ballot_sync(FULL, dec_slot != NULLV && dec_slot >= exec0 && (dec_vid & STOP_BIT) != 0) &
       segmask) != 0;
  const bool may_admit = is_active && stopped == 0 && !stopping && !dec_stop;

  // ---- admission: consecutive slots from c_next, contiguous prefix ----
  if (is_active) c_next = imax(c_next, exec_new);
  const int32_t bound = add32(maj_exec, W);
  const int32_t my_req = j < K ? a.req[((long long)rep * G + g) * K + j] : NULLV;
  bool adm_prev = true, no_stop_before = true;
  int32_t n_admit = 0;
  for (int k = 0; k < K; ++k) {
    if (!__any_sync(FULL, adm_prev)) break;
    const int32_t rk = __shfl_sync(FULL, my_req, k, W);
    const int32_t cand = add32(c_next, k);
    const int lk = cand & (W - 1);
    const int32_t busy = __shfl_sync(FULL, c_prop_slot, lk, W);
    int32_t dec_at = __shfl_sync(FULL, dec_slot, lk, W);
    if (W > 1) dec_at = imax(dec_at, NULLV);  // masked max over the ring
    const bool can = may_admit && no_stop_before && rk != NULLV && cand < bound &&
                     busy == NULLV && dec_at != cand;
    const bool adm = adm_prev && can;
    if (adm && j == lk) { c_prop_vid = rk; c_prop_slot = cand; }
    n_admit += adm ? 1 : 0;
    adm_prev = adm;
    no_stop_before = no_stop_before && !(rk != NULLV && (rk & STOP_BIT) != 0);
  }
  c_next = add32(c_next, n_admit);

  // ---- non-member rows stay frozen; write state', outputs, blob ----
  if (!valid) return;  // no warp collectives below
  const bool m = ((member_mask >> my_id) & 1) == 1;
  const int32_t o_stopped = m ? stopped : stopped0;
  const int32_t o_bal = m ? new_bal : bal0;
  const int32_t o_exec = m ? exec_new : exec0;
  const int32_t o_acc_bal = m ? acc_bal : acc_bal0;
  const int32_t o_acc_vid = m ? acc_vid : acc_vid0;
  const int32_t o_acc_slot = m ? acc_slot : acc_slot0;
  const int32_t o_dec_vid = m ? dec_vid : dec_vid0;
  const int32_t o_dec_slot = m ? dec_slot : dec_slot0;
  const int32_t o_hash = m ? h : app_hash0;
  const int32_t o_n_execd = m ? n_execd : n_execd0;
  const int32_t o_phase = m ? phase : c_phase0;
  const int32_t o_c_bal = m ? c_bal : c_bal0;
  const int32_t o_c_next = m ? c_next : c_next0;
  const int32_t o_cpv = m ? c_prop_vid : c_prop_vid0;
  const int32_t o_cps = m ? c_prop_slot : c_prop_slot0;

  a.st_out[L_ACC_BAL][igw] = o_acc_bal;
  a.st_out[L_ACC_VID][igw] = o_acc_vid;
  a.st_out[L_ACC_SLOT][igw] = o_acc_slot;
  a.st_out[L_DEC_VID][igw] = o_dec_vid;
  a.st_out[L_DEC_SLOT][igw] = o_dec_slot;
  a.st_out[L_C_PROP_VID][igw] = o_cpv;
  a.st_out[L_C_PROP_SLOT][igw] = o_cps;

  int32_t* out = a.out_vec + (long long)rep * M;
  out[2 * G + lo] = (m && my_run) ? my_vid_at : NULLV;           // exec_vid
  out[5 * G + GW + lo] = (m && acc_changed) ? 1 : 0;              // acc_new
  out[6 * G + 2 * GW + lo] = m ? preempted : NULLV;               // preempted_vid

  if (j == 0) {
    a.st_out[L_MEMBER_MASK][ig] = member_mask;
    a.st_out[L_MAJORITY][ig] = majority;
    a.st_out[L_VERSION][ig] = version;
    a.st_out[L_STOPPED][ig] = o_stopped;
    a.st_out[L_TAG][ig] = tag;
    a.st_out[L_BAL][ig] = o_bal;
    a.st_out[L_EXEC_SLOT][ig] = o_exec;
    a.st_out[L_APP_HASH][ig] = o_hash;
    a.st_out[L_N_EXECD][ig] = o_n_execd;
    a.st_out[L_C_PHASE][ig] = o_phase;
    a.st_out[L_C_BAL][ig] = o_c_bal;
    a.st_out[L_C_NEXT_SLOT][ig] = o_c_next;
    const int32_t n_comm = m ? n_adv : 0;
    const int32_t n_adm = m ? n_admit : 0;
    out[g] = n_comm;                                  // n_committed
    out[G + g] = exec0;                               // exec_base
    out[2 * G + GW + g] = n_adm;                      // n_admitted
    out[3 * G + GW + g] = m ? maj_exec : 0;           // maj_exec
    out[4 * G + GW + g] = o_hash;                     // app_hash
    out[5 * G + 2 * GW + g] = o_bal != bal0 ? 1 : 0;  // bal_new
    if (a.heat_out != nullptr)
      a.heat_out[g] = add32(add32(a.heat_in[g], n_comm), n_adm);
  }
  if (a.blob != nullptr) {
    encode_blob(a.blob + (long long)rep * NB, G, GW, g, j, kbits, tag, o_bal, o_exec,
                o_phase, o_c_bal, o_acc_bal, o_acc_vid, o_acc_slot, o_dec_vid,
                o_dec_slot, o_cpv, o_cps, W);
  }
}

// make_blob + pack_blob: one thread per (group, lane); grid.y = replica
__global__ void __launch_bounds__(256) gp_make_blob_kernel(const GpBlobArgs a) {
  const int W = a.W;
  const long long G = a.G;
  const long long GW = G * W;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= GW) return;
  const int kbits = __ffs(W) - 1;
  const long long g = e / W;
  const int j = (int)(e % W);
  const int rep = blockIdx.y;
  const long long ig = (long long)rep * G + g;
  const long long igw = (long long)rep * GW + e;
  const int32_t* const* s = a.st_in;
  encode_blob(a.blob + (long long)rep * (4 * G + 4 * GW), G, GW, g, j, kbits,
              s[L_TAG][ig], s[L_BAL][ig], s[L_EXEC_SLOT][ig], s[L_C_PHASE][ig],
              s[L_C_BAL][ig], s[L_ACC_BAL][igw], s[L_ACC_VID][igw], s[L_ACC_SLOT][igw],
              s[L_DEC_VID][igw], s[L_DEC_SLOT][igw], s[L_C_PROP_VID][igw],
              s[L_C_PROP_SLOT][igw], W);
}

}  // namespace

extern "C" {

int gp_step_args_size() { return (int)sizeof(GpStepArgs); }
int gp_blob_args_size() { return (int)sizeof(GpBlobArgs); }

// Launch gp_step_kernel on `stream`; returns cudaGetLastError() (0 = ok).
int gp_step_launch(const GpStepArgs* a, void* stream) {
  if (a->W < 1 || a->W > 32 || (a->W & (a->W - 1)) || a->K > a->W || a->R < 1 ||
      a->R > 32 || a->G < 1)
    return (int)cudaErrorInvalidValue;
  const long long gpb = GP_BLOCK / a->W;
  dim3 grid((unsigned)((a->G + gpb - 1) / gpb), a->stacked ? (unsigned)a->R : 1u);
  gp_step_kernel<<<grid, GP_BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Launch gp_make_blob_kernel on `stream`; returns cudaGetLastError().
int gp_make_blob_launch(const GpBlobArgs* a, void* stream) {
  if (a->W < 1 || (a->W & (a->W - 1)) || a->G < 1 || a->n_rep < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)a->G * a->W;
  dim3 grid((unsigned)((n + 255) / 256), (unsigned)a->n_rep);
  gp_make_blob_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
