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
// its base pointer, its words per row and its column offset in a packed row;
// the leaves lie end to end).  grid.y is the output row, and each thread of
// grid.x copies one 16-byte unit of it (a word where a leaf, its offset or
// the output is not 16-byte aligned), finding the unit's leaf in the table.
// One unit a thread keeps each thread's chain to one load and one store:
// the first design (one block per (row, leaf) segment, a grid-stride loop)
// ran 24 blocks for 52 KB at the reconfigurators' G=64 and lost to
// torch.cat there.  Units never overlap, so no two threads write one word.
// The kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

#define GP_PACK_NLEAF 8
#define GP_PACK_BLOCK 256

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

// one unit (V: int4 or one word) of row blockIdx.y a thread
template <typename V>
__global__ void __launch_bounds__(GP_PACK_BLOCK) gp_pack_rows_kernel(
    const __grid_constant__ GpPackArgs a) {
  constexpr int vw = sizeof(V) / 4;
  const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * vw;
  if (c >= a.NB) return;
  const int r = blockIdx.y;
  int l = 0;
#pragma unroll
  for (int q = 1; q < GP_PACK_NLEAF; ++q)
    if (q < a.n_leaf && c >= a.col[q]) l = q;
  *reinterpret_cast<V*>(a.out + r * a.NB + c) =
      *reinterpret_cast<const V*>(a.leaf[l] + r * a.len[l] + (c - a.col[l]));
}

}  // namespace

extern "C" {

int gp_pack_args_size() { return (int)sizeof(GpPackArgs); }

// Launch the pack on `stream`; returns cudaGetLastError() (0 = ok).
int gp_pack_rows_launch(const GpPackArgs* a, void* stream) {
  if (a->R < 1 || a->R > 65535 || a->n_leaf < 1 || a->n_leaf > GP_PACK_NLEAF || a->NB < 1)
    return (int)cudaErrorInvalidValue;
  // the leaves lie end to end and fill the row
  bool vec = (a->NB & 3) == 0 && (reinterpret_cast<uintptr_t>(a->out) & 15) == 0;
  for (int l = 0; l < a->n_leaf; ++l) {
    if (a->leaf[l] == nullptr || a->len[l] < 1 ||
        a->col[l] != (l == 0 ? 0 : a->col[l - 1] + a->len[l - 1]))
      return (int)cudaErrorInvalidValue;
    vec = vec && (a->len[l] & 3) == 0 && (reinterpret_cast<uintptr_t>(a->leaf[l]) & 15) == 0;
  }
  if (a->col[a->n_leaf - 1] + a->len[a->n_leaf - 1] != a->NB) return (int)cudaErrorInvalidValue;
  const long long units = vec ? a->NB / 4 : a->NB;
  const dim3 grid((unsigned)((units + GP_PACK_BLOCK - 1) / GP_PACK_BLOCK), (unsigned)a->R);
  if (vec)
    gp_pack_rows_kernel<int4><<<grid, GP_PACK_BLOCK, 0, (cudaStream_t)stream>>>(*a);
  else
    gp_pack_rows_kernel<int32_t><<<grid, GP_PACK_BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
