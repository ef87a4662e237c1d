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
// at small G the two launches' fixed cost does.
//
// Design: two launches per op on the caller's stream.
//   (a) gp_copy_leaves_kernel copies every touched leaf st_in -> st_out:
//       grid.y = leaf, a grid-stride loop over 16-byte vectors (int4) where
//       both pointers are 16-byte aligned, words otherwise.
//   (b) gp_rows_kernel then overwrites the N batch rows: one thread per
//       (batch row, window lane), the [G] leaves written by lane 0 (kill
//       touches no [G, W] leaf and runs one thread per row).  It reads the
//       INPUT state, which jump's keep mask and max(bal) need, so it never
//       reads what (a) wrote.  Stream order puts (b) after (a); the rows are
//       unique (the wrapper checks), so no two threads write one word.
//   extract_rows is one launch of gp_gather_rows_kernel (same thread map).
// The kernels allocate nothing.
//
// Integer semantics follow the plain version's int32: comparisons stay
// signed (NULL = -1 must compare below every slot), popcount is over the
// 32-bit pattern.

#include <cstdint>
#include <cuda_runtime.h>

#define GP_NLEAF 19
#define GP_LIFE_BLOCK 256
#define GP_COPY_MAX_BLOCKS 1056  // 8 blocks of 256 threads on each of 132 SMs

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
  const int32_t* in[GP_NLEAF];
  int32_t* rows_out[GP_NLEAF];     // extract: [N] / [N, W] gathered rows
  const int32_t* idx;              // [N] unique rows in [0, G)
  int32_t G, W, N, op, my_id;
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

__global__ void __launch_bounds__(GP_LIFE_BLOCK) gp_copy_leaves_kernel(const GpLifeArgs a) {
  const int L = blockIdx.y;
  int32_t* dst = a.st_out[L];
  if (dst == nullptr) return;
  const int32_t* src = a.st_in[L];
  const long long n = is_gw(L) ? (long long)a.G * a.W : (long long)a.G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const long long n4 = n >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (long long i = t; i < n4; i += stride) d4[i] = s4[i];
    for (long long i = (n4 << 2) + t; i < n; i += stride) dst[i] = src[i];
  } else {
    for (long long i = t; i < n; i += stride) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(GP_LIFE_BLOCK) gp_rows_kernel(const GpLifeArgs a) {
  const int lanes = a.op == OP_KILL ? 1 : a.W;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)a.N * lanes) return;
  const long long n = e / lanes;
  const int j = (int)(e % lanes);
  const long long g = a.idx[n];
  const long long gw = g * a.W + j;
  const long long nw = n * a.W + j;
  int32_t* const* o = a.st_out;
  const int32_t* const* s = a.st_in;
  const int32_t* const* in = a.in;

  switch (a.op) {
    case OP_CREATE: {
      o[L_ACC_BAL][gw] = NULLV;
      o[L_ACC_VID][gw] = NULLV;
      o[L_ACC_SLOT][gw] = NULLV;
      o[L_DEC_VID][gw] = NULLV;
      o[L_DEC_SLOT][gw] = NULLV;
      o[L_C_PROP_VID][gw] = NULLV;
      o[L_C_PROP_SLOT][gw] = NULLV;
      if (j == 0) {
        const int32_t mask = in[L_MEMBER_MASK][n];
        const int32_t coord0 = in[L_BAL][n];
        const bool me = coord0 == a.my_id;
        // encode_ballot(0, coord0) = (0 << COORD_BITS) | coord0 = coord0
        o[L_MEMBER_MASK][g] = mask;
        o[L_MAJORITY][g] = (int32_t)(__popc((unsigned)mask) / 2 + 1);
        o[L_VERSION][g] = in[L_VERSION][n];
        o[L_STOPPED][g] = 0;
        o[L_TAG][g] = in[L_TAG][n];
        o[L_BAL][g] = coord0;
        o[L_EXEC_SLOT][g] = 0;
        o[L_APP_HASH][g] = 0;
        o[L_N_EXECD][g] = 0;
        o[L_C_PHASE][g] = me ? ACTIVE : IDLE;
        o[L_C_BAL][g] = me ? coord0 : NULLV;
        o[L_C_NEXT_SLOT][g] = 0;
      }
      break;
    }
    case OP_KILL: {
      o[L_MEMBER_MASK][g] = 0;
      o[L_MAJORITY][g] = BIG;
      o[L_STOPPED][g] = 0;
      o[L_TAG][g] = 0;
      o[L_BAL][g] = NULLV;
      o[L_C_PHASE][g] = IDLE;
      o[L_C_BAL][g] = NULLV;
      break;
    }
    case OP_JUMP: {
      // lanes at/above the adopted frontier keep (live votes), the rest clear
      const int32_t ne = in[L_EXEC_SLOT][n];
      const int32_t as = s[L_ACC_SLOT][gw];
      const bool ak = as != NULLV && as >= ne;
      o[L_ACC_BAL][gw] = ak ? s[L_ACC_BAL][gw] : NULLV;
      o[L_ACC_VID][gw] = ak ? s[L_ACC_VID][gw] : NULLV;
      o[L_ACC_SLOT][gw] = ak ? as : NULLV;
      const int32_t ds = s[L_DEC_SLOT][gw];
      const bool dk = ds != NULLV && ds >= ne;
      o[L_DEC_VID][gw] = dk ? s[L_DEC_VID][gw] : NULLV;
      o[L_DEC_SLOT][gw] = dk ? ds : NULLV;
      o[L_C_PROP_VID][gw] = NULLV;
      o[L_C_PROP_SLOT][gw] = NULLV;
      if (j == 0) {
        const int32_t b0 = s[L_BAL][g];
        const int32_t b1 = in[L_BAL][n];
        o[L_BAL][g] = b0 > b1 ? b0 : b1;
        o[L_EXEC_SLOT][g] = ne;
        o[L_APP_HASH][g] = in[L_APP_HASH][n];
        o[L_N_EXECD][g] = in[L_N_EXECD][n];
        o[L_STOPPED][g] = in[L_STOPPED][n];
        o[L_C_PHASE][g] = IDLE;
        o[L_C_BAL][g] = NULLV;
        o[L_C_NEXT_SLOT][g] = ne;
      }
      break;
    }
    case OP_RESTORE_PAUSED: {
      o[L_ACC_BAL][gw] = in[L_ACC_BAL][nw];
      o[L_ACC_VID][gw] = in[L_ACC_VID][nw];
      o[L_ACC_SLOT][gw] = in[L_ACC_SLOT][nw];
      o[L_DEC_VID][gw] = in[L_DEC_VID][nw];
      o[L_DEC_SLOT][gw] = in[L_DEC_SLOT][nw];
      if (j == 0) {
        const int32_t ex = in[L_EXEC_SLOT][n];
        o[L_EXEC_SLOT][g] = ex;
        o[L_BAL][g] = in[L_BAL][n];
        o[L_APP_HASH][g] = in[L_APP_HASH][n];
        o[L_N_EXECD][g] = in[L_N_EXECD][n];
        o[L_C_NEXT_SLOT][g] = ex;
      }
      break;
    }
    case OP_RESTORE_ROWS: {
#pragma unroll
      for (int L = 0; L < GP_NLEAF; ++L) {
        if (is_gw(L))
          o[L][gw] = in[L][nw];
        else if (j == 0)
          o[L][g] = in[L][n];
      }
      break;
    }
    default:
      break;
  }
}

__global__ void __launch_bounds__(GP_LIFE_BLOCK) gp_gather_rows_kernel(const GpLifeArgs a) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)a.N * a.W) return;
  const long long n = e / a.W;
  const int j = (int)(e % a.W);
  const long long g = a.idx[n];
  const long long gw = g * a.W + j;
  const long long nw = n * a.W + j;
#pragma unroll
  for (int L = 0; L < GP_NLEAF; ++L) {
    if (is_gw(L))
      a.rows_out[L][nw] = a.st_in[L][gw];
    else if (j == 0)
      a.rows_out[L][n] = a.st_in[L][g];
  }
}

}  // namespace

extern "C" {

int gp_life_args_size() { return (int)sizeof(GpLifeArgs); }

// Launch one lifecycle op on `stream` (copy pass, then row pass; extract:
// the gather alone); returns cudaGetLastError() (0 = ok).
int gp_lifecycle_launch(const GpLifeArgs* a, void* stream) {
  if (a->G < 1 || a->W < 1 || a->N < 0 || a->op < OP_CREATE || a->op > OP_EXTRACT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a->op != OP_EXTRACT) {
    long long most = 0;
    for (int L = 0; L < GP_NLEAF; ++L) {
      if (a->st_out[L] == nullptr) continue;
      const long long n = is_gw(L) ? (long long)a->G * a->W : (long long)a->G;
      if (n > most) most = n;
    }
    if (most > 0) {
      long long blocks = ((most + 3) / 4 + GP_LIFE_BLOCK - 1) / GP_LIFE_BLOCK;
      if (blocks > GP_COPY_MAX_BLOCKS) blocks = GP_COPY_MAX_BLOCKS;
      gp_copy_leaves_kernel<<<dim3((unsigned)blocks, GP_NLEAF), GP_LIFE_BLOCK, 0, st>>>(*a);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (a->N > 0) {
    const long long lanes = a->op == OP_KILL ? 1 : a->W;
    const long long blocks = ((long long)a->N * lanes + GP_LIFE_BLOCK - 1) / GP_LIFE_BLOCK;
    if (a->op == OP_EXTRACT)
      gp_gather_rows_kernel<<<(unsigned)blocks, GP_LIFE_BLOCK, 0, st>>>(*a);
    else
      gp_rows_kernel<<<(unsigned)blocks, GP_LIFE_BLOCK, 0, st>>>(*a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
