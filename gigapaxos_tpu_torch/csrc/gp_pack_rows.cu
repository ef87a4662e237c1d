// gp_pack_rows.cu — the gathered-blob row pack as a hand-written CUDA kernel (sm_90a).
//
// Replaces the JAX package's `_pack_rows_jit` (gigapaxos_tpu/manager.py:88,
// called from the Blob-exchange tick at manager.py:3132): a Blob of [R, ...]
// int32 leaves becomes the [R, NB] matrix the consensus step gathers from,
// NB = G * (4 + 4W), each row the C-order ravel of that replica's leaves in
// Blob._fields order (tag, bal, exec_slot, coord [R, G]; acc_vid, dec_vid,
// prop_vid, lane_meta [R, G, W]) — so each row equals pack_blob of that
// replica's blob, byte for byte.
//
// Bound.  A pure copy: the least work is to read every input word once and
// write it once, 2 * R * NB * 4 bytes over the card's memory rate (107 MB,
// about 32 us on 3.35 TB/s at G=65,536, W=16, R=3).  At the reconfigurator's
// G=64 the launch's fixed cost bounds it.
//
// Design: one launch.  The wrapper hands a small table (one entry per leaf:
// its base pointer, its words per row and its column offset in a packed row);
// grid.y enumerates the (row, leaf) segments, and each segment's blocks copy
// it with a grid-stride loop over 16-byte vectors (int4) where source and
// destination are both 16-byte aligned, words otherwise.  Segments never
// overlap, so no two threads write one word.  The kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

#define GP_PACK_NLEAF 8
#define GP_PACK_BLOCK 256
#define GP_PACK_MAX_BLOCKS_X 256  // per segment; grid.y holds R * 8 segments

struct GpPackArgs {
  const int32_t* leaf[GP_PACK_NLEAF];  // [R, len] contiguous, Blob._fields order
  int64_t len[GP_PACK_NLEAF];          // words per row of each leaf (G or G * W)
  int64_t col[GP_PACK_NLEAF];          // the leaf's first column in a packed row
  int32_t* out;                        // [R, NB]
  int64_t NB;
  int32_t R;
  int32_t n_leaf;
};

namespace {

__global__ void __launch_bounds__(GP_PACK_BLOCK) gp_pack_rows_kernel(const GpPackArgs a) {
  const int seg = blockIdx.y;
  const int r = seg / a.n_leaf;
  const int l = seg % a.n_leaf;
  const long long n = a.len[l];
  const int32_t* src = a.leaf[l] + (long long)r * n;
  int32_t* dst = a.out + (long long)r * a.NB + a.col[l];
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

}  // namespace

extern "C" {

int gp_pack_args_size() { return (int)sizeof(GpPackArgs); }

// Launch the pack on `stream`; returns cudaGetLastError() (0 = ok).
int gp_pack_rows_launch(const GpPackArgs* a, void* stream) {
  if (a->R < 1 || a->n_leaf < 1 || a->n_leaf > GP_PACK_NLEAF || a->NB < 1 ||
      (long long)a->R * a->n_leaf > 65535)
    return (int)cudaErrorInvalidValue;
  long long most = 0;
  for (int l = 0; l < a->n_leaf; ++l) {
    if (a->leaf[l] == nullptr || a->len[l] < 0 || a->col[l] < 0 ||
        a->col[l] + a->len[l] > a->NB)
      return (int)cudaErrorInvalidValue;
    if (a->len[l] > most) most = a->len[l];
  }
  long long blocks = ((most + 3) / 4 + GP_PACK_BLOCK - 1) / GP_PACK_BLOCK;
  if (blocks < 1) blocks = 1;
  if (blocks > GP_PACK_MAX_BLOCKS_X) blocks = GP_PACK_MAX_BLOCKS_X;
  gp_pack_rows_kernel<<<dim3((unsigned)blocks, (unsigned)(a->R * a->n_leaf)), GP_PACK_BLOCK, 0,
                        (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
