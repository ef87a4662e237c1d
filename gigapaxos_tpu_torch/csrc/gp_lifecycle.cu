// gp_lifecycle.cu — the group-lifecycle row ops as hand-written CUDA kernels (sm_90a).
//
// Replaces the JAX package's lifecycle device programs (each a row scatter or
// gather over the EngineState leaves, `.at[idx].set` under XLA):
//   * gigapaxos_tpu/ops/lifecycle.py:46  create_groups        (OP_CREATE)
//   * gigapaxos_tpu/ops/lifecycle.py:95  kill_groups          (OP_KILL)
//   * gigapaxos_tpu/ops/lifecycle.py:112 jump_rows            (OP_JUMP)
//   * gigapaxos_tpu/ops/lifecycle.py:163 restore_paused_rows  (OP_RESTORE_PAUSED)
//   * gigapaxos_tpu/ops/lifecycle.py:207 restore_rows         (OP_RESTORE_ROWS)
//   * gigapaxos_tpu/ops/lifecycle.py:201 extract_rows         (OP_EXTRACT)
//
// Every op but the gather is OUT OF PLACE, as the reference's functional
// update is: each touched leaf becomes a fresh output buffer (allocated by the
// caller), the input state is never written, untouched leaves are not passed.
//
// Bound.  No arithmetic to speak of: the least work is to read each touched
// leaf once and write its copy once (the op's output is a whole new leaf),
// plus the N batch rows' inputs.  Device-memory bandwidth bounds every op;
// at small G the launches' fixed cost does.
//
// Design.  Create, jump, restore_paused and restore_rows: ONE launch of
// gp_life_rows_kernel over a flat map of (touched leaf, 16-byte unit), the
// touched [G] leaves' units first, then the [G, W] leaves', each leaf's
// units padded to whole blocks (so a block serves one leaf and no block is
// empty), sized by the touched leaves alone.  A unit is 4 rows of a [G]
// leaf (int4, where G % 4 == 0 and the leaf's pointers are 16-byte
// aligned) or 4 lanes of one row of a [G, W] leaf (int4, where W % 4 == 0
// and its pointers, the window batch inputs' too, are aligned); one word
// otherwise.  A thread takes one unit, or four (256 apart) where the batch
// is sparse and the state large (the launcher says which, unless the
// caller fixes it), every load issued before any lookup.  The batch is
// found as kill finds it: a thread reads the word of the batch bitmap that
// holds its unit's rows.  A row outside the batch copies its unit of the
// input leaf; only a batch row looks up its position n in the caller's
// batch, by a binary search of the batch's rows sorted on the host
// (`idx`), bounded by the count of batch rows below each 256-row chunk
// (`cnt`), then `pos[i]`, the caller's position of sorted row i.  A batch
// row's words:
//   create:         its batch inputs and constants alone;
//   restore_paused: in[L][n] or in[L][n * W + j] (c_next_slot: exec_slot);
//   restore_rows:   the same, over all 19 leaves;
//   jump:           bal = max(old bal, in[L_BAL][n]); exec_slot and
//                   c_next_slot in[L_EXEC_SLOT][n]; app_hash, n_execd,
//                   stopped their inputs; c_phase IDLE, c_bal and the two
//                   c_prop planes NULL; acc_bal/acc_vid/acc_slot keep a
//                   lane whose old acc_slot is not NULL and >= the new
//                   exec_slot (signed), dec_vid/dec_slot the same on the
//                   old dec_slot, any other lane NULL.  So a batch unit of
//                   a kept plane reads its own old unit and, outside the
//                   slot plane itself, the old slot unit at its place.
// Every output word is written once, and an input leaf's unit is read only
// where its value is needed (a row outside the batch; bal and the kept
// planes of a jump).  The wrapper stages the sorted rows, the positions,
// the counts, the bitmap and the host inputs in one upload.  (This launch
// replaced, for jump and restore_rows, a copy pass over every touched leaf
// and then a row pass over the batch, which wrote each batch row twice.)
// Kill writes constants into 7 [G] leaves: one launch, gp_kill_kernel, a
// thread for 4 consecutive rows (one int4 of each leaf).  The wrapper
// passes, in in[0], the batch as a bitmap of G bits (staged in the same
// upload as idx), so a thread finds its 4 rows' fate in one load of one
// word, with no search, no shared memory and no barrier, and writes its 4
// words of every leaf once: the input's word, or the constant where the row
// is killed.  No word is written twice, so nothing needs ordering.  (On an
// H100 at G=65,536, N=4,096, two earlier designs of this launch took 4.2 us,
// a binary search of the sorted batch per block, and 2.55 us, a per-block
// slice table and a byte map in shared memory; this one 2.09 us.)
// Extract is one launch of gp_extract_kernel over a flat (leaf, batch row
// [, window unit]) map: the 12 [G] leaves' [N] outputs first, then the 7
// [G, W] leaves' [N, W] outputs in 16-byte units where W % 4 == 0 and the
// pointers are aligned (words otherwise); neighbouring threads write
// neighbouring words of one output.
// The kernels allocate nothing.
//
// Integer semantics follow the plain version's int32: comparisons stay
// signed (NULL = -1 must compare below every slot), popcount is over the
// 32-bit pattern.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#define GP_NLEAF 19
#define GP_LIFE_BLOCK 256

// op codes (gp_kernels.py mirrors them)
enum { OP_CREATE = 0, OP_KILL = 1, OP_JUMP = 2, OP_RESTORE_PAUSED = 3,
       OP_RESTORE_ROWS = 4, OP_EXTRACT = 5 };

struct GpLifeArgs {
  const int32_t* st_in[GP_NLEAF];  // input state, EngineState._fields order
  int32_t* st_out[GP_NLEAF];       // fresh touched leaves; null = untouched
  // Per-leaf batch inputs, [N] for a [G] leaf and [N, W] for a [G, W] leaf:
  //   create:         member_mask, version, tag; in[L_BAL] = coord0
  //   jump:           exec_slot, app_hash, n_execd, stopped; in[L_BAL] = donor bal
  //   restore_paused: exec_slot, bal, app_hash, n_execd and the 5 acc/dec planes
  //   restore_rows:   every leaf
  //   kill:           in[0] = [(G + 31) / 32] bitmap of the batch (bit
  //                   g % 32 of word g / 32 set: row g is killed)
  const int32_t* in[GP_NLEAF];
  int32_t* rows_out[GP_NLEAF];     // extract: [N] / [N, W] gathered rows
  // [N] unique rows in [0, G): the caller's order (extract), or sorted
  // ascending (the others)
  const int32_t* idx;
  // create, jump, restore_paused, restore_rows: [N] the caller's position
  // of sorted row i;
  // [ceil(G / 256) + 1] batch rows below each 256-row chunk; the batch as
  // a bitmap of G bits ((G + 31) / 32 words, bit g % 32 of word g / 32)
  const int32_t* pos;
  const int32_t* cnt;
  const uint32_t* bits;
  int32_t G, W, N, op, my_id;
  // gp_life_rows_kernel: 16-byte units a thread, 1 or 4; 0 (the
  // wrappers' value): the launcher's rule below
  int32_t units;
  int32_t kernels;                 // set by the launcher: kernels launched
};

namespace {

enum {
  L_MEMBER_MASK, L_MAJORITY, L_VERSION, L_STOPPED, L_TAG, L_BAL, L_EXEC_SLOT,
  L_ACC_BAL, L_ACC_VID, L_ACC_SLOT, L_DEC_VID, L_DEC_SLOT, L_APP_HASH,
  L_N_EXECD, L_C_PHASE, L_C_BAL, L_C_NEXT_SLOT, L_C_PROP_VID, L_C_PROP_SLOT
};

constexpr int32_t NULLV = -1;
constexpr int32_t BIG = 1 << 30;
constexpr int32_t IDLE = 0, ACTIVE = 2;

// the [G, W] leaves (window planes)
__host__ __device__ __forceinline__ bool is_gw(int L) {
  return (L >= L_ACC_BAL && L <= L_DEC_SLOT) || L == L_C_PROP_VID || L == L_C_PROP_SLOT;
}

constexpr int N_KILL = 7;

// the leaves kill writes, and the value a killed row takes in each
__device__ __forceinline__ int kill_leaf(int k) {
  switch (k) {
    case 0: return L_MEMBER_MASK;
    case 1: return L_MAJORITY;
    case 2: return L_STOPPED;
    case 3: return L_TAG;
    case 4: return L_BAL;
    case 5: return L_C_PHASE;
    default: return L_C_BAL;
  }
}
__device__ __forceinline__ int32_t kill_value(int k) {
  switch (k) {
    case 1: return BIG;
    case 4: return NULLV;
    case 5: return IDLE;
    case 6: return NULLV;
    default: return 0;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(GP_LIFE_BLOCK) gp_kill_kernel(const GpLifeArgs a) {
  const long long r0 = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (r0 >= a.G) return;
  // the loads go out first; the bitmap word beside them
  int32_t v[N_KILL][4];
#pragma unroll
  for (int k = 0; k < N_KILL; ++k) {
    const int32_t* src = a.st_in[kill_leaf(k)];
    if (VEC) {
      const int4 x = reinterpret_cast<const int4*>(src)[r0 >> 2];
      v[k][0] = x.x; v[k][1] = x.y; v[k][2] = x.z; v[k][3] = x.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (r0 + c < a.G) v[k][c] = src[r0 + c];
    }
  }
  // r0 % 4 == 0: the 4 rows' bits lie in one word
  const unsigned f = ((unsigned)a.in[0][r0 >> 5] >> (r0 & 31)) & 0xfu;
#pragma unroll
  for (int k = 0; k < N_KILL; ++k) {
    int32_t* dst = a.st_out[kill_leaf(k)];
    const int32_t kv = kill_value(k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if ((f >> c) & 1u) v[k][c] = kv;
    if (VEC) {
      reinterpret_cast<int4*>(dst)[r0 >> 2] = make_int4(v[k][0], v[k][1], v[k][2], v[k][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (r0 + c < a.G) dst[r0 + c] = v[k][c];
    }
  }
}

// EngineState index of the k-th [G] leaf (12) and of the k-th [G, W] leaf (7)
__device__ __forceinline__ int g_leaf(int k) { return k < 7 ? k : k + 5; }
__device__ __forceinline__ int gw_leaf(int k) { return k < 5 ? L_ACC_BAL + k : k + 12; }

template <bool VEC>
__global__ void __launch_bounds__(GP_LIFE_BLOCK) gp_extract_kernel(const GpLifeArgs a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = a.N;
  if (e < 12 * N) {
    const int k = e / N;
    const int i = e - k * N;
    const int L = g_leaf(k);
    a.rows_out[L][i] = a.st_in[L][a.idx[i]];
    return;
  }
  const int U = VEC ? a.W >> 2 : a.W;  // units of a window row
  const int per = N * U;
  const int r = e - 12 * N;
  const int k = r / per;
  if (k >= 7) return;
  const int u = r - k * per;
  const int n = u / U;
  const int j = u - n * U;
  const int L = gw_leaf(k);
  const long long from = (long long)a.idx[n] * U + j;
  if (VEC)
    reinterpret_cast<int4*>(a.rows_out[L])[u] = reinterpret_cast<const int4*>(a.st_in[L])[from];
  else
    a.rows_out[L][u] = a.st_in[L][from];
}

// The flat map of gp_life_rows_kernel: the touched leaves in map order
// (n_g [G] leaves, then n_gw [G, W] leaves) and the blocks each leaf's
// units take (whole blocks: a block never serves two leaves).
struct LifeMap {
  int32_t leaf[GP_NLEAF];
  int32_t n_g, n_gw, blocks_g, blocks_gw;
};

constexpr int CHUNK_SHIFT = 8;  // rows per count of `cnt`: 256

// The caller's position n of batch row g (its bit is set): a binary search
// of the sorted rows of g's 256-row chunk, then pos[].
__device__ __forceinline__ int batch_pos(const GpLifeArgs& a, int g) {
  const int c = g >> CHUNK_SHIFT;
  int lo = __ldg(a.cnt + c), hi = __ldg(a.cnt + c + 1);  // g in idx[lo, hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a.idx + mid) <= g) lo = mid; else hi = mid;
  }
  return __ldg(a.pos + lo);
}

__device__ __forceinline__ bool in_batch(const GpLifeArgs& a, int g) {
  return (__ldg(a.bits + (g >> 5)) >> (g & 31)) & 1u;
}

// A batch row's new word of [G] leaf L of op OP, from the caller's batch
// row n (jump's bal: the donor's, which the caller maxes with the old).
template <int OP>
__device__ __forceinline__ int32_t row_word(const GpLifeArgs& a, int L, int n) {
  const int32_t* const* in = a.in;
  if (OP == OP_CREATE) {
    // encode_ballot(0, coord0) = (0 << COORD_BITS) | coord0 = coord0
    switch (L) {
      case L_MEMBER_MASK: return __ldg(in[L_MEMBER_MASK] + n);
      case L_MAJORITY: return (int32_t)(__popc((unsigned)__ldg(in[L_MEMBER_MASK] + n)) / 2 + 1);
      case L_VERSION: return __ldg(in[L_VERSION] + n);
      case L_TAG: return __ldg(in[L_TAG] + n);
      case L_BAL: return __ldg(in[L_BAL] + n);
      case L_C_PHASE: return __ldg(in[L_BAL] + n) == a.my_id ? ACTIVE : IDLE;
      case L_C_BAL: {
        const int32_t coord0 = __ldg(in[L_BAL] + n);
        return coord0 == a.my_id ? coord0 : NULLV;
      }
      default: return 0;  // stopped, exec_slot, app_hash, n_execd, c_next_slot
    }
  }
  if (OP == OP_RESTORE_ROWS) return __ldg(in[L] + n);
  if (OP == OP_JUMP) {
    if (L == L_C_PHASE) return IDLE;
    if (L == L_C_BAL) return NULLV;
  }
  // restore_paused (bal, exec_slot, app_hash, n_execd) and jump (stopped,
  // bal, exec_slot, app_hash, n_execd): c_next_slot takes the new exec_slot
  return __ldg(in[L == L_C_NEXT_SLOT ? L_EXEC_SLOT : L] + n);
}

// Jump's window planes: the slot plane whose old lane decides whether a
// lane of plane L keeps (acc_* on acc_slot, dec_* on dec_slot), or -1 for a
// plane a batch row clears (the c_prop planes).
__device__ __forceinline__ int keep_on(int L) {
  if (L >= L_ACC_BAL && L <= L_ACC_SLOT) return L_ACC_SLOT;
  if (L == L_DEC_VID || L == L_DEC_SLOT) return L_DEC_SLOT;
  return -1;
}

// A lane keeps where its old slot is not NULL and at or above the new
// frontier (signed); any other lane takes NULL.
__device__ __forceinline__ int32_t keep_lane(int32_t v, int32_t s, int32_t ne) {
  return s != NULLV && s >= ne ? v : NULLV;
}
__device__ __forceinline__ void keep_lanes(int4& v, const int4& s, int32_t ne) {
  v = make_int4(keep_lane(v.x, s.x, ne), keep_lane(v.y, s.y, ne),
                keep_lane(v.z, s.z, ne), keep_lane(v.w, s.w, ne));
}
__device__ __forceinline__ void keep_lanes(int32_t& v, const int32_t& s, int32_t ne) {
  v = keep_lane(v, s, ne);
}

__device__ __forceinline__ void set_null(int4& v) { v = make_int4(NULLV, NULLV, NULLV, NULLV); }
__device__ __forceinline__ void set_null(int32_t& v) { v = NULLV; }

// Create, jump, restore_paused and restore_rows in one launch (the design
// above), one instantiation an op, so that no op's kernel carries another's
// branches or registers.  VG: [G] leaves in int4 units of 4 rows; VW:
// [G, W] leaves in int4 units of 4 lanes.  A block serves UNITS x 256 units
// of one leaf, a thread UNITS of them 256 apart (neighbouring threads on
// neighbouring units), all their loads issued before any batch row's
// lookup.
template <int OP, bool VG, bool VW, int UNITS>
__global__ void __launch_bounds__(GP_LIFE_BLOCK) gp_life_rows_kernel(const GpLifeArgs a,
                                                                      const LifeMap m) {
  constexpr int SPAN = GP_LIFE_BLOCK * UNITS;
  int b = blockIdx.x;
  if (b < m.n_g * m.blocks_g) {
    const int k = b / m.blocks_g;
    const int L = m.leaf[k];
    const int units = VG ? a.G >> 2 : a.G;
    const int u0 = (b - k * m.blocks_g) * SPAN + threadIdx.x;
    typedef typename std::conditional<VG, int4, int32_t>::type unit_t;
    constexpr unsigned ALL = VG ? 0xfu : 1u;
    // jump's bal is the one [G] leaf whose batch words read the old word
    const bool old_too = OP == OP_JUMP && L == L_BAL;
    unit_t v[UNITS];
    unsigned f[UNITS];  // the unit's rows in the batch
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = u0 + i * GP_LIFE_BLOCK;
      const int r0 = VG ? u << 2 : u;  // VG: r0 % 4 == 0, the 4 rows' bits in one word
      f[i] = u < units ? (__ldg(a.bits + (r0 >> 5)) >> (r0 & 31)) & ALL : ALL;
      if (f[i] != ALL || (old_too && u < units))
        v[i] = __ldg(reinterpret_cast<const unit_t*>(a.st_in[L]) + u);
    }
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = u0 + i * GP_LIFE_BLOCK;
      if (u >= units || !f[i]) continue;
      const int r0 = VG ? u << 2 : u;
      int32_t* w = reinterpret_cast<int32_t*>(&v[i]);
#pragma unroll
      for (int c = 0; c < (VG ? 4 : 1); ++c)
        if ((f[i] >> c) & 1u) {
          const int32_t x = row_word<OP>(a, L, batch_pos(a, r0 + c));
          w[c] = old_too && w[c] > x ? w[c] : x;  // jump: max(old bal, donor's)
        }
    }
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = u0 + i * GP_LIFE_BLOCK;
      if (u < units) reinterpret_cast<unit_t*>(a.st_out[L])[u] = v[i];
    }
    return;
  }
  b -= m.n_g * m.blocks_g;
  const int k = b / m.blocks_gw;
  const int L = m.leaf[m.n_g + k];
  const int U = VW ? a.W >> 2 : a.W;  // units of a window row
  const int units = a.G * U;
  const int u0 = (b - k * m.blocks_gw) * SPAN + threadIdx.x;
  typedef typename std::conditional<VW, int4, int32_t>::type unit_t;
  // jump: a kept plane's batch unit masks its old unit by the old slot
  // unit of plane S (its own where L is the slot plane); a c_prop plane's
  // is NULL, as every create plane's
  const int S = OP == OP_JUMP ? keep_on(L) : -1;
  const bool to_null = OP == OP_CREATE || (OP == OP_JUMP && S < 0);
  unit_t v[UNITS], sl[UNITS];
  int g[UNITS];
  bool hit[UNITS];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = u0 + i * GP_LIFE_BLOCK;
    g[i] = u < units ? u / U : -1;
    hit[i] = g[i] >= 0 && in_batch(a, g[i]);
    // a row outside the batch, and (jump's kept planes) every row: the old
    // unit; a kept plane's batch row: the old slot unit too
    if (g[i] >= 0 && (!hit[i] || S >= 0))
      v[i] = __ldg(reinterpret_cast<const unit_t*>(a.st_in[L]) + u);
    if (hit[i] && S >= 0)
      sl[i] = S == L ? v[i] : __ldg(reinterpret_cast<const unit_t*>(a.st_in[S]) + u);
  }
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    if (!hit[i]) continue;
    const int u = u0 + i * GP_LIFE_BLOCK;
    if (to_null) {
      set_null(v[i]);
    } else {
      const int n = batch_pos(a, g[i]);
      if (S >= 0)
        keep_lanes(v[i], sl[i], __ldg(a.in[L_EXEC_SLOT] + n));
      else
        v[i] = __ldg(reinterpret_cast<const unit_t*>(a.in[L]) + (n * U + (u - g[i] * U)));
    }
  }
#pragma unroll
  for (int i = 0; i < UNITS; ++i)
    if (g[i] >= 0) reinterpret_cast<unit_t*>(a.st_out[L])[u0 + i * GP_LIFE_BLOCK] = v[i];
}

// gp_life_rows_kernel's instantiation for op OP and `pick` (VG, VW, four
// units a thread: bits 2, 1, 0).
template <int OP>
void rows_kernel(int pick, dim3 grid, cudaStream_t st, const GpLifeArgs& a, const LifeMap& m) {
  switch (pick) {
    case 7: gp_life_rows_kernel<OP, true, true, 4><<<grid, GP_LIFE_BLOCK, 0, st>>>(a, m); break;
    case 6: gp_life_rows_kernel<OP, true, true, 1><<<grid, GP_LIFE_BLOCK, 0, st>>>(a, m); break;
    case 5: gp_life_rows_kernel<OP, true, false, 4><<<grid, GP_LIFE_BLOCK, 0, st>>>(a, m); break;
    case 4: gp_life_rows_kernel<OP, true, false, 1><<<grid, GP_LIFE_BLOCK, 0, st>>>(a, m); break;
    case 3: gp_life_rows_kernel<OP, false, true, 4><<<grid, GP_LIFE_BLOCK, 0, st>>>(a, m); break;
    case 2: gp_life_rows_kernel<OP, false, true, 1><<<grid, GP_LIFE_BLOCK, 0, st>>>(a, m); break;
    case 1: gp_life_rows_kernel<OP, false, false, 4><<<grid, GP_LIFE_BLOCK, 0, st>>>(a, m); break;
    default: gp_life_rows_kernel<OP, false, false, 1><<<grid, GP_LIFE_BLOCK, 0, st>>>(a, m); break;
  }
}

}  // namespace

extern "C" {

int gp_life_args_size() { return (int)sizeof(GpLifeArgs); }

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Create, jump, restore_paused and restore_rows: one launch of
// gp_life_rows_kernel over the touched leaves' units.
static int life_rows_launch(GpLifeArgs* a, cudaStream_t st) {
  if (a->idx == nullptr && a->N > 0) return (int)cudaErrorInvalidValue;
  if (a->pos == nullptr || a->cnt == nullptr || a->bits == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a->units != 0 && a->units != 1 && a->units != 4) return (int)cudaErrorInvalidValue;
  // the flat map's indices are 32-bit, a block's span past the last unit too
  if ((long long)a->G * a->W >= (1LL << 31) - 4LL * GP_LIFE_BLOCK)
    return (int)cudaErrorInvalidValue;
  // restore_paused and restore_rows: a batch row's words are its inputs
  const bool restore = a->op == OP_RESTORE_PAUSED || a->op == OP_RESTORE_ROWS;
  LifeMap m = {};
  bool vg = a->G % 4 == 0, vw = a->W % 4 == 0;
  for (int gw = 0; gw < 2; ++gw)
    for (int L = 0; L < GP_NLEAF; ++L) {
      if (a->st_out[L] == nullptr || is_gw(L) != (gw == 1)) continue;
      m.leaf[m.n_g + m.n_gw] = L;
      const bool al = aligned16(a->st_in[L]) && aligned16(a->st_out[L]);
      if (gw) {
        ++m.n_gw;
        // the restores read their window rows in units too
        vw = vw && al && (!restore || aligned16(a->in[L]));
      } else {
        ++m.n_g;
        vg = vg && al;
      }
    }
  // units a thread: 4 where the batch is sparse (under one row in 16; in
  // 8 for the restores, whose batch units read their inputs) and a window
  // leaf holds 2^19 words or more, where 4 keep more bytes in flight a
  // thread; else 1: a dense batch puts more rows' lookups, each a chain of
  // dependent loads, one after another in a thread, and a small state
  // needs every thread it can get (chip_smoke.py times both counts at the
  // lifecycle shapes through a->units)
  const bool sparse =
      (long long)a->G * a->W >= (1LL << 19) && (restore ? 8LL : 16LL) * a->N < a->G;
  const int units = a->units ? a->units : sparse ? 4 : 1;
  const long long span = (long long)GP_LIFE_BLOCK * units;
  const long long ug = vg ? a->G / 4 : a->G;
  const long long ugw = (long long)a->G * (vw ? a->W / 4 : a->W);
  m.blocks_g = (int)((ug + span - 1) / span);
  m.blocks_gw = (int)((ugw + span - 1) / span);
  const long long blocks = (long long)m.n_g * m.blocks_g + (long long)m.n_gw * m.blocks_gw;
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const int pick = (vg ? 4 : 0) | (vw ? 2 : 0) | (units == 4 ? 1 : 0);
  switch (a->op) {
    case OP_CREATE: rows_kernel<OP_CREATE>(pick, grid, st, *a, m); break;
    case OP_JUMP: rows_kernel<OP_JUMP>(pick, grid, st, *a, m); break;
    case OP_RESTORE_PAUSED: rows_kernel<OP_RESTORE_PAUSED>(pick, grid, st, *a, m); break;
    case OP_RESTORE_ROWS: rows_kernel<OP_RESTORE_ROWS>(pick, grid, st, *a, m); break;
    default: return (int)cudaErrorInvalidValue;
  }
  a->kernels = 1;
  return (int)cudaGetLastError();
}

// Launch one lifecycle op on `stream` (one launch; none for an empty
// extract); sets a->kernels to the launches made and returns
// cudaGetLastError() (0 = ok).
int gp_lifecycle_launch(GpLifeArgs* a, void* stream) {
  a->kernels = 0;
  if (a->G < 1 || a->W < 1 || a->N < 0 || a->op < OP_CREATE || a->op > OP_EXTRACT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a->op == OP_KILL) {
    if (a->in[0] == nullptr) return (int)cudaErrorInvalidValue;  // no bitmap
    bool vec = a->G % 4 == 0;
    for (int L = 0; L < GP_NLEAF; ++L) {
      if (a->st_out[L] == nullptr) continue;
      vec = vec && aligned16(a->st_in[L]) && aligned16(a->st_out[L]);
    }
    const long long blocks = ((long long)a->G + 4 * GP_LIFE_BLOCK - 1) / (4 * GP_LIFE_BLOCK);
    if (vec)
      gp_kill_kernel<true><<<(unsigned)blocks, GP_LIFE_BLOCK, 0, st>>>(*a);
    else
      gp_kill_kernel<false><<<(unsigned)blocks, GP_LIFE_BLOCK, 0, st>>>(*a);
    a->kernels = 1;
    return (int)cudaGetLastError();
  }
  if (a->op == OP_EXTRACT) {
    if (a->N == 0) return (int)cudaGetLastError();
    // the flat map's indices are 32-bit
    if ((long long)a->N * (12 + 7LL * a->W) >= (1LL << 31) || (long long)a->G * a->W >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    bool vec = a->W % 4 == 0;
    for (int L = 0; L < GP_NLEAF; ++L)
      if (is_gw(L)) vec = vec && aligned16(a->st_in[L]) && aligned16(a->rows_out[L]);
    const long long total = 12LL * a->N + 7LL * a->N * (vec ? a->W / 4 : a->W);
    const long long blocks = (total + GP_LIFE_BLOCK - 1) / GP_LIFE_BLOCK;
    if (vec)
      gp_extract_kernel<true><<<(unsigned)blocks, GP_LIFE_BLOCK, 0, st>>>(*a);
    else
      gp_extract_kernel<false><<<(unsigned)blocks, GP_LIFE_BLOCK, 0, st>>>(*a);
    a->kernels = 1;
    return (int)cudaGetLastError();
  }
  return life_rows_launch(a, st);
}

}  // extern "C"
