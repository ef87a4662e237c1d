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
//   * the N-substep dispatch of gigapaxos_tpu/parallel/spmd.py:_build_packed
//     (the packed face's lax.fori_loop: N rounds with the state resident,
//     MY gathered row refreshed from the advancing state, peers' rows
//     frozen, want at substep 0 only) as ONE launch (n_sub = N);
//   * the N-substep loop of gigapaxos_tpu/parallel/spmd.py:_build_stacked
//     (every replica advancing, the blob exchange re-read each substep) as
//     ONE launch over clusters of R CTAs (cluster = 1), R <= 8.
// gp_make_blob_kernel is make_blob + pack_blob alone (initial blob, the
// manager's publish snapshot, the stacked face's first exchange).
//
// Bound.  The step is int32 control logic with no matrix products.  Per
// group per replica-step it reads the state (12 + 7W words), the R gathered
// blob rows (R * (4 + 4W); once per launch on the stacked face), K request
// words, and writes the state, the out vector (6 + 3W) and the blob
// (4 + 4W): device-memory bandwidth bounds it, and at W = 32 (one warp per
// group) the instructions a warp issues per group come next.
//
// What held the first design back: R was a runtime loop bound, so each
// thread issued its gathered-row loads one after another behind
// data-dependent control with nothing copied ahead (37.5% occupancy, about
// a third of the memory rate at the headline); every [G] word was a
// separate load or 4-byte store per group; the stacked face ran one replica
// after another, so each re-read the [R, NB] blob matrix from device
// memory; and the execute and admission loops spent W and K rounds of votes
// and shuffles per warp.
//
// Design.
//   * Compile-time R and W: gp_step_kernel<R, W> for W in {8, 16, 32} and
//     R in {1..5} (every peer loop unrolled, every row's words loaded
//     independently), and <0, 0> with runtime bounds for every other shape
//     the wrapper accepts (W <= 32 a power of two, R <= 32): same source.
//   * A tile is T groups (the launcher picks T; the ring is
//     GP_RING = 2 stages deep, which ran every path's shape at least as
//     fast as 3 on an H100).  Each input of a tile is one contiguous
//     segment: the 12 [G] state words, the 7 [G, W] planes, each gathered
//     row's 4 [G] words and 4 lane planes, the [T, K] requests and the
//     heat.  A persistent grid (at most the CTAs the card holds at once,
//     and never more than the work items) walks the tiles; the CTA brings
//     each item's segments into shared memory with TMA 1-D bulk copies
//     completing on an mbarrier, GP_RING items ahead (each thread issues
//     one segment's copy), so bytes stay in flight whatever the
//     occupancy.  A launch whose offsets are not all
//     16-byte aligned (G % 4 != 0, or a pointer off 16 bytes) fills the
//     same ring with plain loads, one item at a time: same kernel, same
//     compute.
//   * One thread per (group, ring lane), W lanes a segment; every input is
//     read from shared memory.  The [G] outputs (12 state, 6 out, 4 blob
//     words, heat) are gathered in shared memory and written once per tile
//     as coalesced 16-byte stores; the [G, W] planes go out as coalesced
//     rows straight from the threads.
//   * Stacked face: the work items are (tile, replica) with the replica
//     fastest, so the R CTAs stepping one tile run together and read its R
//     gathered rows through L2: the matrix leaves device memory once.
//   * Execute: each lane marks the offset of its decided slot from the
//     frontier in a warp-wide OR; when no two lanes of a segment mark one
//     offset (always so under the ring convention) the frontier advance is
//     the mask's trailing ones and the hash folds over a shared-memory row,
//     with no votes.  A segment with a collision (a state off the ring
//     convention) runs the exact W-round loop.  Admission is exact in O(1):
//     lane j can only take request k = (j - c_next) mod W, so each lane
//     tests its own k and two ballots give the admitted prefix.
//   * N substeps in one launch (n_sub > 1).  N launches would read and
//     write the whole state N times; the work needs it once.  A tile's
//     stage holds its state, its R gathered rows, the heat and all N
//     request tiles [N][T][K] (the requests are a few percent of a tile's
//     bytes, and the ring brings the next tile's stage, requests and all,
//     while this one runs its N substeps).  After each substep but the
//     last the CTA writes the new state back into the stage (not to
//     device memory), stores that substep's out-ring row, adds the
//     substep's decisions and admissions into the staged heat, and
//     replaces MY gathered row in the stage by the blob of the new state;
//     peers' rows stay as loaded.  The last substep writes state', blob
//     and heat to device memory once.  Two barriers a substep: every lane
//     has read the stage before any lane overwrites it (lanes past a
//     tile's last group read that group), and the stage is whole again
//     before the next substep reads it.
//   * The stacked face's N substeps as one launch (cluster = 1): a cluster
//     of R CTAs per tile, CTA rank r holding replica r's state in its
//     stage for the whole dispatch, so the state leaves and enters device
//     memory once, and the [R, NB] blob matrix never exists in device
//     memory.  Each CTA holds two exchange buffers of R blob rows.  At an
//     item's start from the loaded state, and after each substep but the
//     last from the new one, every thread stores its (group, lane)'s blob
//     words into row r of one buffer in all R CTAs of the cluster
//     (distributed shared memory stores, which do not wait for a reply);
//     one cluster barrier (arrive after the stores, wait before the next
//     substep) makes them visible, and each CTA steps reading the rows
//     from its own shared memory, with its row of heard.  The barrier also
//     orders the CTA's own threads, so a substep takes one cluster barrier
//     and one CTA barrier.  Double buffering keeps it to one cluster
//     barrier a substep: a CTA stores into the other buffer of its peers
//     while they may still read this one.  A cluster holds at most 8 CTAs
//     (the portable size), so R <= 8; the wrapper keeps N launches for
//     larger R.
// State is written out of place: the kernel never writes a buffer it reads.
// The kernel allocates nothing and launches on the caller's stream.
//
// Integer semantics match XLA's int32 exactly: additions, subtractions,
// multiplications and left shifts wrap (done in uint32 and reinterpreted);
// right shifts of signed values stay arithmetic; the coord word keeps
// ACTIVE in the sign bit.

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define GP_NLEAF 19
#define GP_MAX_THREADS 256
#define GP_MAX_SMEM 232448  // what one block may use on sm_90
#define GP_NOUT 23          // [G] output words staged per group
#define GP_NINST 16         // 15 fixed instantiations + the generic one
#define GP_RING 2           // stages of the input ring
#define GP_MAX_DEV 64       // devices the launch plan keeps
#define GP_MAX_CLUSTER 8    // the portable cluster size

// The source builds three times (ops/gp_kernels.py), one mode each, so the
// three compile in parallel and the one-substep kernel carries none of the
// substep loop's registers (with the loop in it, it ran 12-16% slower):
//   0  gp_step: one substep (the packed face at N = 1, the stacked grid),
//      and gp_make_blob;
//   1  gp_step_n: the packed face's N substeps in one launch;
//   2  gp_step_cluster: the stacked face's N substeps over clusters.
#ifndef GP_STEP_MODE
#define GP_STEP_MODE 0
#endif

// With N = n_sub substeps the requests and the out vectors gain a leading
// [N] axis: packed req [N, G, K] and out [N, M]; cluster req [N, R, G, K]
// and out [N, R, M] (the stacked grid runs N = 1).
struct GpStepArgs {
  const int32_t* st_in[GP_NLEAF];  // EngineState._fields order
  int32_t* st_out[GP_NLEAF];
  const int32_t* gathered;  // [R, NB] compact blob rows (cluster: not read)
  const uint8_t* heard;     // [R] bool (stacked: [R, R], row = replica)
  const int32_t* req;       // [G, K] (stacked: [R, G, K])
  const uint8_t* want;      // [G] bool (stacked: [R, G]); substep 0 only
  int32_t* out_vec;         // [M] StepOutputs._fields order (stacked: [R, M])
  int32_t* blob;            // [NB] Blob._fields order, or null (stacked: [R, NB])
  const int32_t* heat_in;   // [G] or null
  int32_t* heat_out;        // [G] or null (may alias heat_in)
  int32_t G, W, K, R, my_id, stacked;
  int32_t T;                // set by the launcher: groups per tile
  int32_t aligned;          // set by the launcher: bulk copies and 16-byte stores
  int32_t n_sub;            // substeps in this launch (>= 1; 1 on the stacked grid)
  int32_t cluster;          // stacked: one cluster of R CTAs a tile (R <= 8)
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

// The tile's [G] state words in shared memory, in EngineState order with
// the [G, W] leaves left out; and the 7 [G, W] leaves.
__host__ __device__ __forceinline__ int g1_leaf(int i) { return i < 7 ? i : i + 5; }
__host__ __device__ __forceinline__ int gw_leaf(int i) { return i < 5 ? 7 + i : 12 + i; }

// One ring stage, in words (every segment a multiple of 4 words, T % 4 == 0):
//   [12][T] state words | [7][T*W] state planes | [R][4][T] gathered words |
//   [R][4][T*W] gathered lane planes (not in cluster mode) | [NQ][T][K]
//   requests (NQ = the substeps) | [T] heat
// then, once per CTA: 2 x [23][T] staged [G] outputs (one item stores from
// one while the next computes into the other) | [T][W] execute scratch |
// cluster mode: 2 exchange buffers, each the R replicas' blob rows laid out
// as the stage's gathered rows ([R][4][T] words | [R][4][T*W] lane planes)
// | GP_RING mbarriers.
struct Layout {
  int T, W, R, K, TW, o_sw, o_b1, o_bw, o_req, o_heat, stage, xbuf, xwords;
  __host__ __device__ Layout(int T_, int W_, int R_, int K_, int NQ, bool X)
      : T(T_), W(W_), R(R_), K(K_), TW(T_ * W_) {
    const int rs = X ? 0 : R;  // gathered rows in the stage
    o_sw = 12 * T;
    o_b1 = o_sw + 7 * TW;
    o_bw = o_b1 + 4 * rs * T;
    o_req = o_bw + 4 * rs * TW;
    o_heat = o_req + NQ * T * K;
    stage = o_heat + T;
    xbuf = 4 * R * (T + TW);
    xwords = X ? 2 * xbuf : 0;
  }
  __host__ __device__ long long smem_bytes() const {
    return 4LL * ((long long)GP_RING * stage + 2 * GP_NOUT * T + TW + xwords) +
           8LL * GP_RING;
  }
};

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
// trailing ones of x (32 when every bit is set)
__device__ __forceinline__ int ones_tail(unsigned x) { return __clz(__brev(~x)); }
// trailing zeros of x (32 when x == 0)
__device__ __forceinline__ int zeros_tail(unsigned x) { return __clz(__brev(x)); }

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

struct Words4 {
  int32_t w[4];
};

// make_blob of one (group, lane): the lane's four [G, W] blob words
// (acc_vid, dec_vid, prop_vid, lane_meta)
__device__ __forceinline__ Words4 lane_words(
    int kbits, int32_t bal, int32_t exec_slot, int32_t c_phase, int32_t acc_bal,
    int32_t acc_vid, int32_t acc_slot, int32_t dec_vid, int32_t dec_slot,
    int32_t c_prop_vid, int32_t c_prop_slot) {
  const int32_t eb = exec_slot >> kbits;
  bool acc_in, dec_ok, prop_ok;
  int32_t acc_w = wrap_enc(acc_slot, eb, kbits, acc_in);
  const int32_t delta = sub32(bal, acc_bal);
  const bool acc_ok = acc_in && acc_bal != NULLV && delta >= 0 && delta <= DELTA_MAX;
  acc_w = acc_ok ? acc_w : 0;
  const int32_t acc_d = acc_ok ? delta + 1 : 0;
  const int32_t dec_w = wrap_enc(dec_slot, eb, kbits, dec_ok);
  const int32_t prop_w = wrap_enc(c_phase == ACTIVE ? c_prop_slot : NULLV, eb, kbits, prop_ok);
  const int32_t meta = acc_d | shl32(acc_w, 16) | shl32(dec_w, 21) | shl32(prop_w, 26);
  return {{acc_ok ? acc_vid : NULLV, dec_ok ? dec_vid : NULLV,
           prop_ok ? c_prop_vid : NULLV, meta}};
}

// the four words at dst[l * stride]
template <typename S>
__device__ __forceinline__ void put4(int32_t* dst, S stride, const Words4& v) {
  dst[0] = v.w[0];
  dst[stride] = v.w[1];
  dst[2 * stride] = v.w[2];
  dst[3 * stride] = v.w[3];
}

// lane_words written at dst[l * stride]: a blob row's 4 * G + l * GW +
// g * W + j, or a shared-memory row's planes
__device__ __forceinline__ void encode_lanes(
    int32_t* dst, long long stride, int kbits,
    int32_t bal, int32_t exec_slot, int32_t c_phase, int32_t acc_bal,
    int32_t acc_vid, int32_t acc_slot, int32_t dec_vid, int32_t dec_slot,
    int32_t c_prop_vid, int32_t c_prop_slot) {
  put4(dst, stride, lane_words(kbits, bal, exec_slot, c_phase, acc_bal, acc_vid, acc_slot,
                               dec_vid, dec_slot, c_prop_vid, c_prop_slot));
}

// the blob's coord word: the prepare ballot, or the proposal ballot with the
// sign bit set while ACTIVE, else NULL
__device__ __forceinline__ int32_t coord_word(int32_t c_phase, int32_t c_bal) {
  return c_phase == PREPARING ? c_bal : (c_phase == ACTIVE ? (c_bal | INT32_MIN_V) : NULLV);
}

// make_blob of one group: its four [G] blob words (tag, bal, exec_slot,
// coord)
__device__ __forceinline__ Words4 group_words(int32_t tag, int32_t bal, int32_t exec_slot,
                                              int32_t c_phase, int32_t c_bal) {
  return {{tag, bal, exec_slot, coord_word(c_phase, c_bal)}};
}

// group_words at dst[l * stride]
__device__ __forceinline__ void blob_words(int32_t* dst, int stride, int32_t tag, int32_t bal,
                                           int32_t exec_slot, int32_t c_phase, int32_t c_bal) {
  put4(dst, stride, group_words(tag, bal, exec_slot, c_phase, c_bal));
}

// Cluster mode: one (group, lane)'s blob words of this replica (CTA rank
// crank) into row crank of exchange buffer xb in every CTA of the cluster,
// its own included (distributed shared memory stores; the cluster
// barrier's arrive releases them, its wait acquires them in the peers);
// the group's [G] words from lane 0.  The buffer's rows are laid out as
// the stage's gathered rows.
__device__ __forceinline__ void push_row(int32_t* xb, const Layout& L, int R, int crank, int gi,
                                         int j, int W, const Words4& lw, bool lane0,
                                         const Words4& gw) {
  cg::cluster_group cluster = cg::this_cluster();
  int32_t* lp = xb + 4 * R * L.T + crank * 4 * L.TW + gi * W + j;
  int32_t* gp = xb + crank * 4 * L.T + gi;
#pragma unroll
  for (int r = 0; r < GP_MAX_CLUSTER; ++r) {
    if (r < R) {
      put4(cluster.map_shared_rank(lp, r), L.TW, lw);
      if (lane0) put4(cluster.map_shared_rank(gp, r), L.T, gw);
    }
  }
}

// a segment's W lane bits of a ballot, rotated so that bit k is lane
// (c0 + k) mod W
__device__ __forceinline__ unsigned seg_rot(unsigned ballot, int segbase, unsigned wmask,
                                            int c0, int W) {
  const unsigned b = (ballot >> segbase) & wmask;
  return c0 == 0 ? b : (((b >> c0) | (b << (W - c0))) & wmask);
}

// ---- shared-memory barriers and bulk copies (PTX) ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// waits for a phase; a wait that never ends (bytes armed that no copy
// brings) traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0, spins = 0;
  do {
    if (++spins == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the cluster barrier split in two (all threads of every CTA of the
// cluster): arrive releases this thread's earlier writes; wait returns once
// every thread of the cluster has arrived, and acquires their writes
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// orders this thread's earlier generic-proxy writes to shared memory before
// later async-proxy (bulk copy) writes to the same words
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Input segment i of work item (rep, tile at t0 with n groups): its source,
// its offset in the stage and its length, in words.  Order: the 12 [G]
// state words, the 7 [G, W] planes, each gathered row's 4 [G] words and 4
// lane planes (not in cluster mode: the rows come from the peers' shared
// memory), the n_sub request tiles, the heat (when given).
struct Seg {
  const int32_t* src;
  int off, words;
};

// nq: the substeps of the launch (the kernel's NS, a constant 1 in mode 0)
template <bool CL>
__device__ __forceinline__ int n_segs(const GpStepArgs& a, int R, int nq) {
  return 19 + (CL ? 0 : 8 * R) + nq + (a.heat_in != nullptr ? 1 : 0);
}

template <bool CL>
__device__ __forceinline__ Seg input_seg(const GpStepArgs& a, const Layout& L, int nq, int i,
                                         int rep, long long t0, int n) {
  const long long G = a.G, GW = G * L.W, NB = 4 * G + 4 * GW;
  if (i < 12) return {a.st_in[g1_leaf(i)] + rep * G + t0, i * L.T, n};
  if (i < 19)
    return {a.st_in[gw_leaf(i - 12)] + rep * GW + t0 * L.W, L.o_sw + (i - 12) * L.TW, n * L.W};
  i -= 19;
  if (!CL) {
    if (i < 8 * L.R) {
      const int r = i >> 3, l = i & 7;
      const int32_t* row = a.gathered + r * NB;
      if (l < 4) return {row + l * G + t0, L.o_b1 + (r * 4 + l) * L.T, n};
      return {row + 4 * G + (l - 4) * GW + t0 * L.W, L.o_bw + (r * 4 + l - 4) * L.TW, n * L.W};
    }
    i -= 8 * L.R;
  }
  if (i < nq) {
    // substep i's [G, K] tile: req[i, rep] ([N, R, G, K] stacked, [N, G, K] packed)
    const long long rows = (long long)i * (a.stacked ? L.R : 1) + rep;
    return {a.req + (rows * G + t0) * L.K, L.o_req + i * L.T * L.K, n * L.K};
  }
  return {a.heat_in + t0, L.o_heat, n};
}

// bring one work item's segments into a stage: thread 0 arms the barrier
// with the item's bytes (its one arrival), and thread t issues segment t
// (a copy that lands before the arming leaves the transaction count
// negative for a while; the phase cannot complete before the arrival)
template <bool CL>
__device__ __forceinline__ void issue_item(const GpStepArgs& a, const Layout& L, int nq,
                                           int rep, long long t0, int n, int32_t* stage,
                                           uint64_t* bar, int tid, int nthr) {
  if (tid == 0) {
    const int per = 12 + 7 * L.W + (CL ? 0 : 4 * L.R * (1 + L.W)) + nq * L.K +
                    (a.heat_in != nullptr ? 1 : 0);
    mbar_expect_tx(bar, (uint32_t)(4 * n * per));
  }
  const int ns = n_segs<CL>(a, L.R, nq);
  for (int i = tid; i < ns; i += nthr) {
    const Seg s = input_seg<CL>(a, L, nq, i, rep, t0, n);
    if (s.words > 0) bulk_g2s(stage + s.off, s.src, (uint32_t)(4 * s.words), bar);
  }
}

// the destination of staged [G] output word i (0-11 state in g1 order,
// 12-17 out, 18-21 blob, 22 heat) for replica rep; the out words go to out
// row orow (substep * rows a substep + replica)
__device__ __forceinline__ int32_t* out_dst(const GpStepArgs& a, int i, int rep, int orow) {
  const long long G = a.G, GW = G * a.W;
  if (i < 12) return a.st_out[g1_leaf(i)] + rep * G;
  if (i < 18) {
    const long long M = 6 * G + 3 * GW;
    const int k = i - 12;
    const long long off = k == 0 ? 0 : k == 1 ? G : k == 2 ? 2 * G + GW
                        : k == 3 ? 3 * G + GW : k == 4 ? 4 * G + GW : 5 * G + 2 * GW;
    return a.out_vec + (long long)orow * M + off;
  }
  if (i < 22) return a.blob + rep * (4 * G + 4 * GW) + (i - 18) * G;
  return a.heat_out;
}

// store staged [G] output words w0 .. w0 + cnt - 1 of a tile (n groups at
// t0), one coalesced run per word; index 18 + nb and above is the heat
// (word 22: no blob words when the launch writes no blob)
__device__ __forceinline__ void store_staged(const GpStepArgs& a, const int32_t* sO, int T,
                                             int n, long long t0, int rep, int orow, bool bulk,
                                             int w0, int cnt, int nb, int tid, int nthr) {
  if (bulk) {
    const int n4 = n >> 2;  // n % 4 == 0 on an aligned launch
    for (int e = tid; e < cnt * n4; e += nthr) {
      const int i = e / n4, q = e - i * n4;
      const int w = w0 + i < 18 + nb ? w0 + i : 22;
      reinterpret_cast<int4*>(out_dst(a, w, rep, orow) + t0)[q] =
          reinterpret_cast<const int4*>(sO + w * T)[q];
    }
  } else {
    for (int e = tid; e < cnt * n; e += nthr) {
      const int i = e / n, q = e - i * n;
      const int w = w0 + i < 18 + nb ? w0 + i : 22;
      out_dst(a, w, rep, orow)[t0 + q] = sO[w * T + q];
    }
  }
}

// registers bounded for 3 CTAs an SM (80 a thread): at W <= 16 three ran
// faster than four on an H100, and at W = 32 the two read within 2% of each
// other, either way from one run to the next.  CL: the cluster mode (the
// stacked face's N substeps, one CTA per replica of a tile).
template <int RC, int WC>
__global__ void __launch_bounds__(GP_MAX_THREADS, 3)
    gp_step_kernel(const __grid_constant__ GpStepArgs a) {
  constexpr bool CL = GP_STEP_MODE == 2;
  const int R = RC > 0 ? RC : a.R;
  const int W = WC > 0 ? WC : a.W;
  const int K = a.K, T = a.T;
  const int NS = GP_STEP_MODE == 0 ? 1 : a.n_sub;
  constexpr int S = GP_RING;
  const Layout L(T, W, R, K, NS, CL);
  const int TW = L.TW;
  const long long G = a.G;
  const long long GW = G * W;
  const int kbits = __ffs(W) - 1;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int gi_raw = tid >> kbits;
  const int j = tid & (W - 1);
  const int segbase = (tid & 31) & ~(W - 1);
  const unsigned wmask = W == 32 ? FULL : ((1u << W) - 1u);
  const unsigned segmask = wmask << segbase;
  // out-vector rows a substep: R on the stacked faces, 1 on the packed
  const int RS = a.stacked ? R : 1;

  extern __shared__ __align__(16) int32_t smem[];
  int32_t* sO2 = smem + S * L.stage;
  int32_t* sV = sO2 + 2 * GP_NOUT * T;
  int32_t* sX = sV + TW;  // cluster mode: the 2 exchange buffers
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + L.xwords);

  // work items fit an int (the launcher checks): a tile (packed, cluster)
  // or a (tile, replica) pair (stacked grid)
  const int n_tiles = (int)((G + T - 1) / T);
  const int n_items = (a.stacked && !CL) ? n_tiles * R : n_tiles;
  // this CTA's walk over the items; the R CTAs of a cluster walk their
  // cluster's tiles together, CTA rank r as replica r
  int first = blockIdx.x, stride = gridDim.x, crank = 0;
  if constexpr (CL) {
    first = blockIdx.x / R;
    stride = gridDim.x / R;
    crank = (int)cg::this_cluster().block_rank();
  }
  const bool bulk = a.aligned != 0;
  const int nb = a.blob != nullptr ? 4 : 0;
  const int n_out = 18 + nb + (a.heat_out != nullptr ? 1 : 0);

  if (bulk && tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the tile and replica of a work item (replica fastest on the grid)
  auto item_at = [&](int item, int& rep, long long& t0, int& n) {
    const int tile = (a.stacked && !CL) ? item / R : item;
    rep = CL ? crank : (a.stacked ? item - tile * R : 0);
    t0 = (long long)tile * T;
    n = (int)(G - t0 < T ? G - t0 : T);
  };
  if (bulk) {
    for (int s = 0; s < S; ++s) {
      const long long item = first + (long long)s * stride;
      if (item >= n_items) break;
      int rep, n;
      long long t0;
      item_at((int)item, rep, t0, n);
      issue_item<CL>(a, L, NS, rep, t0, n, smem + s * L.stage, &bars[s], tid, nthr);
    }
  }

  // item k of this CTA uses stage s = k mod S in phase (k / S) mod 2, and
  // output stage k mod 2; cluster mode: exchange c of the CTA (counted
  // over its items: one at an item's start, one after each substep but the
  // last) goes through buffer c mod 2
  int s = 0, k = 0;
  uint32_t phase_bit = 0, xc = 0;
  for (int item = first; item < n_items; item += stride, ++k) {
    int32_t* st = smem + s * L.stage;
    int32_t* sO = sO2 + (k & 1) * GP_NOUT * T;
    int rep, n;
    long long t0;
    item_at(item, rep, t0, n);
    const bool valid = gi_raw < n;
    // lanes past the last group compute on the tile's last group (every
    // lane must take part in the warp collectives) and write nothing
    const int gi = valid ? gi_raw : n - 1;
    const long long g = t0 + gi;
    const int my_id = a.stacked ? rep : a.my_id;
    // the heard row and want byte come from global memory: their loads go
    // out before the wait for the stage, so the two latencies overlap
    const uint8_t* hrow = a.heard + (a.stacked ? (long long)rep * R : 0);
    unsigned heard_bits = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) heard_bits |= (hrow[r] != 0 ? 1u : 0u) << r;
    const bool want0 = a.want[(long long)rep * G + g] != 0;
    if (bulk) {
      mbar_wait(&bars[s], phase_bit);
    } else {
      // plain loads: a segment has at most T * W words (K <= W), so each
      // thread copies at most one word of it; eight segments' loads are in
      // flight before the first store
      const int ns = n_segs<CL>(a, R, NS);
      for (int i0 = 0; i0 < ns; i0 += 8) {
        int32_t v[8];
        int off[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          off[q] = -1;
          if (i0 + q < ns) {
            const Seg sg = input_seg<CL>(a, L, NS, i0 + q, rep, t0, n);
            if (tid < sg.words) {
              v[q] = __ldg(sg.src + tid);
              off[q] = sg.off + tid;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (off[q] >= 0) st[off[q]] = v[q];
      }
      __syncthreads();
    }
    if constexpr (CL) {
      // this replica's blob of its state as loaded, pushed to the cluster:
      // what every replica folds at substep 0 (the arrive publishes it)
      if (valid) {
        const int32_t* s1 = st + gi;
        const int32_t* sw = st + L.o_sw + gi * W + j;
        push_row(sX + (xc & 1) * L.xbuf, L, R, crank, gi, j, W,
                 lane_words(kbits, s1[5 * T], s1[6 * T], s1[9 * T], sw[0], sw[TW], sw[2 * TW],
                            sw[3 * TW], sw[4 * TW], sw[5 * TW], sw[6 * TW]),
                 j == 0, group_words(s1[4 * T], s1[5 * T], s1[6 * T], s1[9 * T], s1[10 * T]));
      }
      cluster_arrive();
    }

    // the substeps (their body keeps the item's indentation)
    for (int sub = 0; sub < NS; ++sub) {
    const bool last = sub == NS - 1;
    if constexpr (CL) {
      // every replica has pushed its rows of this exchange, and this CTA's
      // writes of the last substep (stage, staged out words) are visible:
      // the cluster barrier holds the CTA's own threads too.  The last
      // substep's staged out words go to its out-ring row now.
      cluster_wait();
      if (sub > 0)
        store_staged(a, sO, T, n, t0, rep, (sub - 1) * RS + rep, bulk, 12, 6, nb, tid, nthr);
    }
    // want_coord fires at substep 0 only (an election pulse is a host
    // decision; replaying it would re-bump ballots N times)
    const bool want = sub == 0 && want0;

    // ================= one (group, lane) of the tile =================
    const int32_t* s1 = st + gi;                       // [12][T]
    const int32_t* sw = st + L.o_sw + gi * W + j;      // [7][TW]
    // the gathered rows: the stage's, or (cluster) this exchange's buffer
    const int32_t* xcur = sX + (xc & 1) * L.xbuf;
    const int32_t* b1 = (CL ? xcur : st + L.o_b1) + gi;                // [R * 4][T]
    const int32_t* bw = (CL ? xcur + 4 * R * T : st + L.o_bw) + gi * W + j;  // [R * 4][TW]
    const int32_t* rq = st + L.o_req + (sub * T + gi) * K;  // [K] of this substep
#define S1(i) s1[(i) * T]
#define SW(i) sw[(i) * TW]
#define B1(r, l) b1[((r) * 4 + (l)) * T]
#define BW(r, l) bw[((r) * 4 + (l)) * TW]
    const int32_t member_mask = S1(0), majority = S1(1), version = S1(2);
    const int32_t stopped0 = S1(3), tag = S1(4), bal0 = S1(5), exec0 = S1(6);
    const int32_t app_hash0 = S1(7), n_execd0 = S1(8), c_phase0 = S1(9);
    const int32_t c_bal0 = S1(10), c_next0 = S1(11);
    const int32_t acc_bal0 = SW(0), acc_vid0 = SW(1), acc_slot0 = SW(2);
    const int32_t dec_vid0 = SW(3), dec_slot0 = SW(4);
    const int32_t c_prop_vid0 = SW(5), c_prop_slot0 = SW(6);

    // ---- live senders + 1. promise ----
    unsigned live_bits = 0;
    int32_t max_prep = INT32_MIN_V, max_prop = INT32_MIN_V;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t pcoord = B1(r, 3);
      const bool lv = ((heard_bits >> r) & 1) && ((member_mask >> r) & 1) && B1(r, 0) == tag;
      live_bits |= (lv ? 1u : 0u) << r;
      const int32_t prep = pcoord >= 0 ? pcoord : NULLV;
      const int32_t prop = (pcoord < 0 && pcoord != NULLV) ? (pcoord & 0x7FFFFFFF) : NULLV;
      max_prep = imax(max_prep, lv ? prep : NULLV);
      max_prop = imax(max_prop, lv ? prop : NULLV);
    }
    int32_t new_bal = imax(bal0, imax(max_prep, max_prop));
    unsigned win_bits = 0;
    if (max_prop != NULLV) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int32_t pcoord = B1(r, 3);
        const bool lv = (live_bits >> r) & 1;
        const int32_t prop = (pcoord < 0 && pcoord != NULLV) ? (pcoord & 0x7FFFFFFF) : NULLV;
        win_bits |= ((lv ? prop : NULLV) == max_prop ? 1u : 0u) << r;
      }
    }

    // ---- 2+3. the peer fold: accept winner, learn, decision-ring merge ----
    int32_t p_slot = NULLV, p_vid = NULLV;
    int32_t s_c = NULLV, b_c = NULLV, det_vid = NULLV, n_match = 0;
    int32_t c1_s = BIG, c1_v = NULLV;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t a_vid = BW(r, 0), d_vid = BW(r, 1), pr_vid = BW(r, 2);
      int32_t a_bal, a_slot, d_slot, pr_slot;
      decode_lane(BW(r, 3), B1(r, 1), B1(r, 2), j, kbits, a_bal, a_slot, d_slot, pr_slot);
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
    bool stop_seen = false, my_run = false;
    int32_t my_vid_at = NULLV;
    {
      // the offset of my decided slot from the frontier, if inside the ring
      const int32_t d_off = sub32(dec_slot, exec0);
      const bool match = (uint32_t)d_off < (uint32_t)W;
      const unsigned hits =
          (__reduce_or_sync(FULL, match ? 1u << (segbase + d_off) : 0u) >> segbase) & wmask;
      const int n_lanes = __popc(__ballot_sync(FULL, match) & segmask);
      // two lanes of my segment on one offset: only off the ring convention
      const bool collide = n_lanes != __popc(hits);
      int32_t* vrow = sV + gi_raw * W;
      // the value the exact loop takes at my offset: the max over the
      // segment, where every other lane gives NULL
      if (match && !collide) vrow[d_off] = W > 1 ? imax(dec_vid, NULLV) : dec_vid;
      __syncwarp();
      if (!collide) {
        n_adv = ones_tail(hits);
        for (int o = 0; o < n_adv; ++o) {
          const int32_t v = vrow[o];
          if (v > 0) { h = mix32(h, v); n_execd = add32(n_execd, 1); }
          stop_seen = stop_seen || (v & STOP_BIT) != 0;
        }
        my_run = j < n_adv;
        if (my_run) my_vid_at = vrow[j];
      }
      if (__any_sync(FULL, collide)) {
        // the exact loop, for the segments with a collision
        bool run_prev = collide;
        for (int o = 0; o < W; ++o) {
          if (!__any_sync(FULL, run_prev)) break;
          const int32_t slot_o = add32(exec0, o);
          const bool eq = dec_slot == slot_o;
          const bool hit = (__ballot_sync(FULL, eq) & segmask) != 0;
          const int32_t v = __reduce_max_sync(segmask, eq ? dec_vid : NULLV);
          const bool take = run_prev && hit;
          if (take && v > 0) { h = mix32(h, v); n_execd = add32(n_execd, 1); }
          stop_seen = stop_seen || (take && (v & STOP_BIT) != 0);
          n_adv += take ? 1 : 0;
          if (collide && j == o) { my_run = take; my_vid_at = v; }
          run_prev = take;
        }
      }
    }
    const int32_t exec_new = add32(exec0, n_adv);
    const int32_t stopped = imax(stopped0, stop_seen ? 1 : 0);

    // ---- majority-rank execute frontier (O(R^2) rank count) ----
    int32_t maj_exec = INT32_MIN_V;
#pragma unroll
    for (int x = 0; x < R; ++x) {
      const int32_t ge_x = ((live_bits >> x) & 1) ? B1(x, 2) : NULLV;
      int rank = 0;
#pragma unroll
      for (int y = 0; y < R; ++y) {
        const int32_t ge_y = ((live_bits >> y) & 1) ? B1(y, 2) : NULLV;
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
    const bool start = (want || orphaned) && phase == IDLE && !inert && stopped == 0;
    const int32_t start_bal = shl32(add32(new_bal >> 5, 1), 5) | my_id;
    const int32_t c_bal = start ? start_bal : c_bal0;
    if (start) phase = PREPARING;
    if (phase == PREPARING) new_bal = imax(new_bal, c_bal);

    unsigned prom_bits = 0;
    int32_t n_promise = 1, prom_exec = INT32_MIN_V;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool pr = B1(r, 1) == c_bal && ((live_bits >> r) & 1) && r != my_id;
      prom_bits |= (pr ? 1u : 0u) << r;
      n_promise += pr ? 1 : 0;
      prom_exec = imax(prom_exec, pr ? B1(r, 2) : NULLV);
    }
    const bool won = phase == PREPARING && n_promise >= majority;

    // carryover: only read where it is used (segments that won a quorum)
    int32_t co_slot = NULLV, co_bal = NULLV, co_vid = NULLV;
    if (won) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!((prom_bits >> r) & 1)) continue;
        int32_t a_bal, a_slot, d_slot, pr_slot;
        decode_lane(BW(r, 3), B1(r, 1), B1(r, 2), j, kbits, a_bal, a_slot, d_slot, pr_slot);
        const bool ok = a_slot != NULLV && a_slot >= exec0;
        if (ok && (a_slot > co_slot || (a_slot == co_slot && a_bal > co_bal))) {
          co_slot = a_slot; co_bal = a_bal; co_vid = BW(r, 0);
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
    const int32_t max_co_slot = __reduce_max_sync(segmask, co_slot);
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
    const bool retire =
        c_prop_slot != NULLV && (dec_slot == c_prop_slot || c_prop_slot < exec0);
    const int32_t preempted =
        (retire && dec_vid != c_prop_vid && c_prop_vid > 0) ? c_prop_vid : NULLV;
    if (retire) { c_prop_vid = NULLV; c_prop_slot = NULLV; }

    // stop-request ordering
    const bool stopping =
        (__ballot_sync(FULL, c_prop_vid != NULLV && (c_prop_vid & STOP_BIT) != 0) & segmask) != 0;
    const bool dec_stop = (__ballot_sync(FULL, dec_slot != NULLV && dec_slot >= exec0 &&
                                                   (dec_vid & STOP_BIT) != 0) &
                           segmask) != 0;
    const bool may_admit = is_active && stopped == 0 && !stopping && !dec_stop;

    // ---- admission: consecutive slots from c_next, contiguous prefix.
    // Request k can only land on lane (c_next + k) mod W, so lane j tests
    // its own k = (j - c_next) mod W; two ballots give the prefix. ----
    if (is_active) c_next = imax(c_next, exec_new);
    const int32_t bound = add32(maj_exec, W);
    int n_admit;
    {
      const int kj = (int)((uint32_t)sub32(j, c_next) & (uint32_t)(W - 1));
      const bool has_k = kj < K;
      const int32_t rk = has_k ? rq[kj] : NULLV;
      const int32_t cand = add32(c_next, kj);
      const int32_t dec_at = W > 1 ? imax(dec_slot, NULLV) : dec_slot;  // masked max
      const bool can = has_k && may_admit && rk != NULLV && cand < bound &&
                       c_prop_slot == NULLV && dec_at != cand;
      const bool stp = has_k && rk != NULLV && (rk & STOP_BIT) != 0;
      const int c0 = c_next & (W - 1);
      const unsigned can_k = seg_rot(__ballot_sync(FULL, can), segbase, wmask, c0, W);
      const unsigned stop_k = seg_rot(__ballot_sync(FULL, stp), segbase, wmask, c0, W);
      // request k needs every request before it admitted and no stop before it
      n_admit = imin(ones_tail(can_k), zeros_tail(stop_k) + 1);
      if (has_k && kj < n_admit) { c_prop_vid = rk; c_prop_slot = cand; }
    }
    c_next = add32(c_next, n_admit);

    // ---- non-member rows stay frozen; write state', outputs, blob ----
    const bool m = ((member_mask >> my_id) & 1) == 1;
    // every lane has read this substep's stage before any lane writes the
    // next one into it (and the last substep's staged out words are stored)
    if (NS > 1) __syncthreads();
    // the out-vector row of this substep and replica
    const int orow = sub * RS + rep;
    if (valid) {
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

      const long long lo = g * W + j;
      if (last) {
        const long long igw = (long long)rep * GW + lo;
        a.st_out[L_ACC_BAL][igw] = o_acc_bal;
        a.st_out[L_ACC_VID][igw] = o_acc_vid;
        a.st_out[L_ACC_SLOT][igw] = o_acc_slot;
        a.st_out[L_DEC_VID][igw] = o_dec_vid;
        a.st_out[L_DEC_SLOT][igw] = o_dec_slot;
        a.st_out[L_C_PROP_VID][igw] = o_cpv;
        a.st_out[L_C_PROP_SLOT][igw] = o_cps;
      } else {
        // the next substep's state planes, in the stage
        int32_t* swm = st + L.o_sw + gi * W + j;
        swm[0] = o_acc_bal;     swm[TW] = o_acc_vid;     swm[2 * TW] = o_acc_slot;
        swm[3 * TW] = o_dec_vid; swm[4 * TW] = o_dec_slot; swm[5 * TW] = o_cpv;
        swm[6 * TW] = o_cps;
      }

      int32_t* out = a.out_vec + (long long)orow * (6 * G + 3 * GW);
      out[2 * G + lo] = (m && my_run) ? my_vid_at : NULLV;   // exec_vid
      out[5 * G + GW + lo] = (m && acc_changed) ? 1 : 0;      // acc_new
      out[6 * G + 2 * GW + lo] = m ? preempted : NULLV;       // preempted_vid
      // the next substep's blob row of this replica: packed, MY gathered
      // row in the stage (peers' rows stay as loaded); cluster, pushed into
      // the next exchange's buffer of every CTA of the cluster
      if (!last) {
        const Words4 lw = lane_words(kbits, o_bal, o_exec, o_phase, o_acc_bal, o_acc_vid,
                                     o_acc_slot, o_dec_vid, o_dec_slot, o_cpv, o_cps);
        if constexpr (CL)
          push_row(sX + ((xc + 1) & 1) * L.xbuf, L, R, crank, gi, j, W, lw, j == 0,
                   group_words(tag, o_bal, o_exec, o_phase, o_c_bal));
        else
          put4(st + L.o_bw + my_id * 4 * TW + gi * W + j, TW, lw);
      } else if (nb) {
        encode_lanes(a.blob + (long long)rep * (4 * G + 4 * GW) + 4 * G + lo, GW, kbits, o_bal,
                     o_exec, o_phase, o_acc_bal, o_acc_vid, o_acc_slot, o_dec_vid, o_dec_slot,
                     o_cpv, o_cps);
      }

      if (j == 0) {
        int32_t* o = sO + gi;
        const int32_t n_comm = m ? n_adv : 0;
        const int32_t n_adm = m ? n_admit : 0;
        o[12 * T] = n_comm;                 // n_committed
        o[13 * T] = exec0;                  // exec_base
        o[14 * T] = n_adm;                  // n_admitted
        o[15 * T] = m ? maj_exec : 0;       // maj_exec
        o[16 * T] = o_hash;                 // app_hash
        o[17 * T] = o_bal != bal0 ? 1 : 0;  // bal_new
        // the heat word of the group is read and written by this lane only
        const int32_t* heat = st + L.o_heat + gi;
        if (last) {
          o[0 * T] = member_mask;  o[1 * T] = majority;  o[2 * T] = version;
          o[3 * T] = o_stopped;    o[4 * T] = tag;       o[5 * T] = o_bal;
          o[6 * T] = o_exec;       o[7 * T] = o_hash;    o[8 * T] = o_n_execd;
          o[9 * T] = o_phase;      o[10 * T] = o_c_bal;  o[11 * T] = o_c_next;
          blob_words(o + 18 * T, T, tag, o_bal, o_exec, o_phase, o_c_bal);
          if (a.heat_out != nullptr) o[22 * T] = add32(add32(*heat, n_comm), n_adm);
        } else {
          // the next substep's [G] state words and heat, in the stage
          int32_t* s1m = st + gi;
          s1m[0 * T] = member_mask;  s1m[1 * T] = majority;  s1m[2 * T] = version;
          s1m[3 * T] = o_stopped;    s1m[4 * T] = tag;       s1m[5 * T] = o_bal;
          s1m[6 * T] = o_exec;       s1m[7 * T] = o_hash;    s1m[8 * T] = o_n_execd;
          s1m[9 * T] = o_phase;      s1m[10 * T] = o_c_bal;  s1m[11 * T] = o_c_next;
          if constexpr (!CL)
            blob_words(st + L.o_b1 + my_id * 4 * T + gi, T, tag, o_bal, o_exec, o_phase, o_c_bal);
          if (a.heat_in != nullptr) st[L.o_heat + gi] = add32(add32(*heat, n_comm), n_adm);
        }
      }
    }
#undef S1
#undef SW
#undef B1
#undef BW
    // =================================================================
    if (!last) {
      if constexpr (CL) {
        // publishes the next exchange's rows, the stage's state and the
        // staged out words (stored after the wait)
        cluster_arrive();
        ++xc;
      } else {
        // the stage holds the next substep's state and rows; this
        // substep's out words are staged: store them to its out-ring row
        __syncthreads();
        store_staged(a, sO, T, n, t0, rep, orow, bulk, 12, 6, nb, tid, nthr);
      }
    }
    }  // substeps

    // the stage was written by this CTA's threads (substeps): order those
    // writes before the bulk copies that refill it
    if (NS > 1 || CL) fence_proxy_async();
    __syncthreads();  // the stage is read, the [G] outputs are staged
    if (bulk) {
      const long long next = item + (long long)S * stride;
      if (next < n_items) {
        int rep2, n2;
        long long t2;
        item_at((int)next, rep2, t2, n2);
        issue_item<CL>(a, L, NS, rep2, t2, n2, st, &bars[s], tid, nthr);
      }
    }
    // the staged [G] outputs, one coalesced run per word
    store_staged(a, sO, T, n, t0, rep, (NS - 1) * RS + rep, bulk, 0, n_out, nb, tid, nthr);
    if (CL) ++xc;
    if (++s == S) {
      s = 0;
      phase_bit ^= 1u;
    }
  }
  // no CTA of a cluster leaves while a peer may still copy its exchange rows
  if constexpr (CL) {
    cluster_arrive();
    cluster_wait();
  }
}

#if GP_STEP_MODE == 0
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
  int32_t* blob = a.blob + (long long)rep * (4 * G + 4 * GW);
  // every lane loads the [G] words with its own (one round trip, not two)
  const int32_t tag = s[L_TAG][ig], bal = s[L_BAL][ig], exec_slot = s[L_EXEC_SLOT][ig];
  const int32_t c_phase = s[L_C_PHASE][ig], c_bal = s[L_C_BAL][ig];
  encode_lanes(blob + 4 * G + e, GW, kbits, bal, exec_slot, c_phase, s[L_ACC_BAL][igw],
               s[L_ACC_VID][igw], s[L_ACC_SLOT][igw], s[L_DEC_VID][igw], s[L_DEC_SLOT][igw],
               s[L_C_PROP_VID][igw], s[L_C_PROP_SLOT][igw]);
  if (j == 0) {
    blob[g] = tag;
    blob[G + g] = bal;
    blob[2 * G + g] = exec_slot;
    blob[3 * G + g] = coord_word(c_phase, c_bal);
  }
}
#endif

// ---- the launch plan's host side ----
typedef void (*StepKernel)(const GpStepArgs);

// the instantiation for (R, W) and its id (R * 100 + W; 0 = generic)
StepKernel pick_kernel(int R, int W, int* id) {
#define GP_CASE(r, w)                    \
  if (R == r && W == w) {                \
    *id = r * 100 + w;                   \
    return gp_step_kernel<r, w>;         \
  }
#define GP_CASES(r) GP_CASE(r, 8) GP_CASE(r, 16) GP_CASE(r, 32)
  GP_CASES(1) GP_CASES(2) GP_CASES(3) GP_CASES(4) GP_CASES(5)
#undef GP_CASES
#undef GP_CASE
  *id = 0;
  return gp_step_kernel<0, 0>;
}

// the launcher's cache slot of an instantiation id (0 = generic)
int slot_of(int id) {
  return id == 0 ? 0 : 1 + (id / 100 - 1) * 3 + (id % 100 == 8 ? 0 : id % 100 == 16 ? 1 : 2);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The tile: T starts at 256 / W groups (256 threads; 128 in cluster mode,
// where six CTAs an SM ran the stacked N=8 dispatch faster than its N
// launches on an H100, and three, 124 clusters of them, slower) and halves
// while the launch would have fewer work items than the card has SMs
// (small G: more, smaller CTAs; down to 8 groups, which ran G=64 faster
// than 4 on an H100), and further, down to 4 groups and at least one warp,
// while the ring does not fit a block's shared memory.
int choose_tile(const GpStepArgs& a, int sms) {
  const int W = a.W, t_min = 32 / W > 4 ? 32 / W : 4;
  const int t_small = t_min > 8 ? t_min : 8;
  const int threads = a.cluster ? GP_MAX_THREADS / 2 : GP_MAX_THREADS;
  int T = threads / W > t_min ? threads / W : t_min;
  const long long per_tile = a.stacked ? a.R : 1;
  while (T > t_small && ((long long)a.G + T - 1) / T * per_tile < sms) T /= 2;
  while (T > t_min &&
         Layout(T, W, a.R, a.K, a.n_sub, a.cluster != 0).smem_bytes() > GP_MAX_SMEM)
    T /= 2;
  return T;
}

struct Plan {
  StepKernel fn;
  int id, threads, occ, cluster;
  long long smem, grid, n_items;
};

// a cluster launch's configuration: R CTAs a cluster along x
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(const Plan& p, long long grid, cudaStream_t stream) : cfg{} {
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3((unsigned)p.threads);
    cfg.dynamicSmemBytes = (size_t)p.smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// What the launcher learns once per device and keeps: the SM count, which
// instantiations have their shared-memory cap raised, the CTAs per SM of
// each (instantiation, threads, shared memory), and, for the cluster mode,
// the clusters the card holds at once.  Every PaxosServer of a process
// steps on a thread of its own and ctypes drops the GIL, so one mutex
// guards all of it.
std::mutex plan_mu;
int plan_sms[GP_MAX_DEV];
bool plan_cap_set[GP_MAX_DEV][GP_NINST];
std::map<std::tuple<int, int, int, long long>, int> plan_occ;  // (dev, slot, threads, smem)
std::map<std::tuple<int, int, int, long long>, int> plan_clusters;

// check the arguments (and that they are this build's mode); choose the
// kernel, the tile, the shared memory, the CTAs (or clusters) the card
// holds at once and the grid
int make_plan(GpStepArgs* a, Plan* p) {
  const int W = a->W;
  const bool cl = GP_STEP_MODE == 2;
  if (W < 1 || W > 32 || (W & (W - 1)) || a->K < 0 || a->K > W || a->R < 1 || a->R > 32 ||
      a->G < 1 || a->n_sub < 1 || (a->cluster != 0) != cl)
    return (int)cudaErrorInvalidValue;
  // mode 0 runs one substep; mode 1 is the packed face; a cluster (mode 2)
  // holds the R replicas of the stacked face
  if (GP_STEP_MODE == 0 && a->n_sub != 1) return (int)cudaErrorInvalidValue;
  if (GP_STEP_MODE == 1 && a->stacked) return (int)cudaErrorInvalidValue;
  if (cl && (!a->stacked || a->R > GP_MAX_CLUSTER)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= GP_MAX_DEV) return (int)cudaErrorInvalidDevice;
  p->fn = pick_kernel(a->R, W, &p->id);
  p->cluster = cl ? a->R : 0;
  const int slot = slot_of(p->id);
  std::lock_guard<std::mutex> lock(plan_mu);
  if (plan_sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&plan_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  a->T = choose_tile(*a, plan_sms[dev]);
  const Layout L(a->T, W, a->R, a->K, a->n_sub, cl);
  p->smem = L.smem_bytes();
  if (p->smem > GP_MAX_SMEM) return (int)cudaErrorInvalidValue;
  bool al = (a->G % 4) == 0 && aligned16(a->gathered) && aligned16(a->req) &&
            aligned16(a->out_vec) && aligned16(a->blob) && aligned16(a->heat_in) &&
            aligned16(a->heat_out);
  for (int l = 0; l < GP_NLEAF; ++l) al = al && aligned16(a->st_in[l]) && aligned16(a->st_out[l]);
  a->aligned = al ? 1 : 0;
  p->threads = a->T * W;
  const long long n_tiles = ((long long)a->G + a->T - 1) / a->T;
  p->n_items = (a->stacked && !cl) ? n_tiles * a->R : n_tiles;
  if (p->n_items * (cl ? a->R : 1) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the cap is raised once to the most a block may use: a launch asks for
  // what its tile needs, and the cap does not change the CTAs an SM holds
  if (!plan_cap_set[dev][slot]) {
    e = cudaFuncSetAttribute((const void*)p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GP_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    plan_cap_set[dev][slot] = true;
  }
  const auto key = std::make_tuple(dev, slot, p->threads, p->smem);
  auto it = plan_occ.find(key);
  if (it == plan_occ.end()) {
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, (const void*)p->fn, p->threads,
                                                      (size_t)p->smem);
    if (e != cudaSuccess) return (int)e;
    it = plan_occ.emplace(key, occ).first;
  }
  p->occ = it->second;
  if (p->occ < 1) return (int)cudaErrorInvalidConfiguration;
  if (cl) {
    // a persistent grid of at most the clusters the card holds at once
    auto ic = plan_clusters.find(key);
    if (ic == plan_clusters.end()) {
      ClusterLaunch c(*p, p->n_items * a->R, 0);
      int n_cl = 0;
      e = cudaOccupancyMaxActiveClusters(&n_cl, (const void*)p->fn, &c.cfg);
      if (e != cudaSuccess) return (int)e;
      ic = plan_clusters.emplace(key, n_cl).first;
    }
    if (ic->second < 1) return (int)cudaErrorInvalidConfiguration;
    p->grid = (p->n_items < ic->second ? p->n_items : ic->second) * a->R;
    return 0;
  }
  const long long cap = (long long)p->occ * plan_sms[dev];
  p->grid = p->n_items < cap ? p->n_items : cap;
  return 0;
}

}  // namespace

extern "C" {

int gp_step_args_size() { return (int)sizeof(GpStepArgs); }
#if GP_STEP_MODE == 0
int gp_blob_args_size() { return (int)sizeof(GpBlobArgs); }
#endif

// Launch gp_step_kernel on `stream` (a cluster launch in cluster mode);
// returns cudaGetLastError() (0 = ok).
int gp_step_launch(const GpStepArgs* a, void* stream) {
  GpStepArgs k = *a;
  Plan p;
  const int rc = make_plan(&k, &p);
  if (rc != 0) return rc;
  void* params[] = {&k};
  cudaError_t e;
  if (p.cluster) {
    ClusterLaunch c(p, p.grid, (cudaStream_t)stream);
    e = cudaLaunchKernelExC(&c.cfg, (const void*)p.fn, params);
  } else {
    e = cudaLaunchKernel((const void*)p.fn, dim3((unsigned)p.grid), dim3(p.threads), params,
                         (size_t)p.smem, (cudaStream_t)stream);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan gp_step_launch would launch with: info = {instantiation id
// (R * 100 + W, 0 = generic), groups per tile, threads, shared-memory
// bytes, CTAs per SM, grid (CTAs), aligned (bulk copies), work items (in
// cluster mode: tiles, each taken by a cluster of R CTAs)}.  Returns 0 or
// a cudaError.
int gp_step_launch_info(const GpStepArgs* a, long long* info) {
  GpStepArgs k = *a;
  Plan p;
  const int rc = make_plan(&k, &p);
  if (rc != 0) return rc;
  const long long v[8] = {p.id, k.T, p.threads, p.smem, p.occ, p.grid, k.aligned, p.n_items};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}

#if GP_STEP_MODE == 0
// Launch gp_make_blob_kernel on `stream`; returns cudaGetLastError().
int gp_make_blob_launch(const GpBlobArgs* a, void* stream) {
  if (a->W < 1 || (a->W & (a->W - 1)) || a->G < 1 || a->n_rep < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)a->G * a->W;
  dim3 grid((unsigned)((n + 255) / 256), (unsigned)a->n_rep);
  gp_make_blob_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
