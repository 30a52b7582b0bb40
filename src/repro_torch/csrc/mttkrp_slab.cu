// Slab-packed segmented spMTTKRP for one output mode, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mttkrp_pallas.py::_kernel
// (body at :51, launched by mttkrp_pallas() at its pl.pallas_call, :166)
// and computes the same function on the same packed arrays
// (repro_torch/kernels/ops.py::pack_slabs):
//
//   out[rb_of[g] * BR + lrow] += val * prod_w F_w[idx_w]
//
// over every slot of every slab g, accumulated in float32 for float32 or
// bfloat16 factors.  The Python wrapper is
// repro_torch/kernels/mttkrp_slab.py::mttkrp_slab; its plain PyTorch
// version mttkrp_slab_plain is the reference the kernel is held against.
//
// What bounds it.  Bytes: each rank block reads the slab data once,
// G*T*(W+2)*4 bytes (W index rows, the values, the local rows), plus the
// factor rows it gathers and the (rows, R) output.  For the chicago
// tensor at rank 16 that is about 107 MB per mode, 0.032 ms at 3.35 TB/s;
// the arithmetic (W+1 flops per slot and column) is two orders of
// magnitude below the card's float32 rate.
//
// Design.  On the TPU the grid runs in order, so consecutive slabs of one
// row block revisit one output tile held in VMEM.  Here blocks run in no
// order, and a whole mode can sit in one row block (chicago's modes 1-3
// have 24, 77 and 32 rows, so one row block holds all 5.3M nonzeros).
// So the work runs in two passes, with no atomics and in a fixed order,
// which keeps the result deterministic and the appended zero slabs of a
// slab cap an exact +0.0:
//
//   pass 1 (chunk_tiles_kernel): one block per (chunk, rank block).  A
//     chunk is a run of at most C slabs of one row block (the wrapper's
//     chunk table).  The block splits the chunk's slots into contiguous
//     runs, one per "walker" of rank_block threads (one thread per rank
//     column).  Rows are sorted inside a row block, so a walker sums each
//     row's run in a register and stores it once into a shared-memory
//     (BR, RB) tile; only a walker's first run may share its row with an
//     earlier walker, so it goes to a carry slot that is added after a
//     barrier, in walker order.  The tile is written to partials[chunk].
//   pass 2 (reduce_chunks_kernel): out[row block] = the sum of its chunks'
//     partials, in chunk order.
//
// Lanes (blockIdx.z).  The batched service stacks B packings that share
// one slab cap, tiling and rank (the TPU path's jax.vmap over the kernel):
// lane b reads its own slice of idx (B, W, G*T), vals and lrows (B, 1, G*T),
// factors (B, I_w, R) and chunk tables (B, NC+1) and (B, NB+1), and writes
// its own partials and output.  Lanes' chunk tables are padded to the
// batch's largest chunk count with empty chunks, whose blocks return at
// once; their partials are never read.  The walker split depends on the
// chunk size only, so lane b of a batched launch sums in exactly the order
// of a single launch on lane b's packing.  Pass one is compiled twice: with
// the lane offsets for B > 1, and without them for one packing, where the
// base pointers then stay kernel parameters instead of taking registers
// (the offsets cost the single launch about 40% of its time on the H100).
// Every float operation is an explicitly rounded __fmul_rn / __fadd_rn,
// which the compiler never fuses into an FMA, so both versions perform the
// same roundings in the same order.
//
// Values supplied at run time (the masked method's residuals) are
// scattered into the slab slots by the Python wrapper before the launch;
// the kernel reads them like baked values.
//
// Slots whose value is exactly 0 (slab padding and cap slabs, whose local
// row 0 breaks the row order) are skipped: they would add +-0.0, which
// changes no sum.  Factor rows are gathered directly from global memory
// (the tensors of this regime keep their factors in the 50 MB L2); the
// one-hot MXU gather of the TPU kernel has no use here.  Partial traffic
// is NC*BR*R*4 bytes each way, small beside the slab data.  The walk of
// each walker is sequential, four slots at a time, so the kernel is bound
// by gather latency well above the byte bound; PERF.md carries its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxInputs = 7;
constexpr int kUnroll = 4;
constexpr int kReduceThreads = 256;

struct FactorPtrs {
  const void* p[kMaxInputs];
  long long lane_stride[kMaxInputs];  // elements from one lane's factor to the next
};

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T, int W, bool kLanes>
__global__ void __launch_bounds__(1024) chunk_tiles_kernel(
    const int* __restrict__ chunk_slab, const int* __restrict__ idx,
    const float* __restrict__ vals, const int* __restrict__ lrows,
    FactorPtrs factors, int rank, long long slots, int tile, int chunk_slabs,
    int block_rows, int rank_block, int r_pad, int num_chunks,
    float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int lane = kLanes ? blockIdx.z : 0;
  const int chunk = blockIdx.x;
  if (kLanes) {
    chunk_slab += static_cast<long long>(lane) * (num_chunks + 1);
    idx += static_cast<long long>(lane) * W * slots;
    vals += static_cast<long long>(lane) * slots;
    lrows += static_cast<long long>(lane) * slots;
    partials += static_cast<long long>(lane) * num_chunks * block_rows * r_pad;
  }
  const long long e0 = static_cast<long long>(chunk_slab[chunk]) * tile;
  const long long n = static_cast<long long>(chunk_slab[chunk + 1]) * tile - e0;
  if (n == 0) return;  // a lane's padding chunk: its partial is never read

  const int walkers = blockDim.x / rank_block;
  float* tile_s = smem;                                   // (BR, RB)
  float* carry_s = smem + block_rows * rank_block;        // (walkers, RB)
  int* carry_row = reinterpret_cast<int*>(carry_s + walkers * rank_block);

  const int c = threadIdx.x % rank_block;
  const int k = threadIdx.x / rank_block;
  const int col = blockIdx.y * rank_block + c;
  const bool live = col < rank;  // padded rank columns compute zeros

  for (int i = threadIdx.x; i < block_rows * rank_block; i += blockDim.x) {
    tile_s[i] = 0.0f;
  }
  if (c == 0) carry_row[k] = -1;
  __syncthreads();

  // Walker k takes slots [k*per, (k+1)*per) of the chunk, with `per` a
  // function of the full chunk size only: appended cap slabs never move a
  // real slot to another walker, so capped and uncapped packings sum in
  // the same order.
  const long long per = (static_cast<long long>(chunk_slabs) * tile + walkers - 1) / walkers;
  const long long beg = e0 + min(static_cast<long long>(k) * per, n);
  const long long end = e0 + min(static_cast<long long>(k + 1) * per, n);

  const T* fac[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    fac[w] = static_cast<const T*>(factors.p[w]);
    if (kLanes) fac[w] += lane * factors.lane_stride[w];
  }

  float run = 0.0f;
  int row = -1;
  bool first_run = true;
  for (long long j0 = beg; j0 < end; j0 += kUnroll) {
    float p[kUnroll];
    int r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u;
      r[u] = -1;
      p[u] = 0.0f;
      if (j < end) {
        const float v = vals[j];
        if (v != 0.0f) {
          r[u] = lrows[j];
          float q = v;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const long long i = idx[w * slots + j];
            q = __fmul_rn(q, live ? load_f32(fac[w], i * rank + col) : 0.0f);
          }
          p[u] = q;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] < 0) continue;
      if (r[u] != row) {
        if (row >= 0) {
          if (first_run) {
            carry_s[k * rank_block + c] = run;
            if (c == 0) carry_row[k] = row;
            first_run = false;
          } else {
            tile_s[row * rank_block + c] = run;
          }
        }
        row = r[u];
        run = 0.0f;
      }
      run = __fadd_rn(run, p[u]);
    }
  }
  if (row >= 0) {
    if (first_run) {
      carry_s[k * rank_block + c] = run;
      if (c == 0) carry_row[k] = row;
    } else {
      tile_s[row * rank_block + c] = run;
    }
  }
  __syncthreads();

  if (threadIdx.x < rank_block) {
    for (int q = 0; q < walkers; ++q) {
      const int rr = carry_row[q];
      if (rr >= 0) {
        tile_s[rr * rank_block + threadIdx.x] =
            __fadd_rn(tile_s[rr * rank_block + threadIdx.x], carry_s[q * rank_block + threadIdx.x]);
      }
    }
  }
  __syncthreads();

  float* dst = partials + static_cast<long long>(chunk) * block_rows * r_pad +
               blockIdx.y * rank_block;
  for (int i = threadIdx.x; i < block_rows * rank_block; i += blockDim.x) {
    dst[static_cast<long long>(i / rank_block) * r_pad + i % rank_block] = tile_s[i];
  }
}

__global__ void reduce_chunks_kernel(const int* __restrict__ rb_chunk_ptr,
                                     const float* __restrict__ partials,
                                     int tile_elems, int num_chunks, int num_row_blocks,
                                     float* __restrict__ out) {
  const int rb = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= tile_elems) return;
  const long long lane = blockIdx.z;
  rb_chunk_ptr += lane * (num_row_blocks + 1);
  partials += lane * num_chunks * tile_elems;
  out += lane * num_row_blocks * tile_elems;
  const int c0 = rb_chunk_ptr[rb];
  const int c1 = rb_chunk_ptr[rb + 1];
  float s = 0.0f;
  for (int ch = c0; ch < c1; ++ch) {
    s = __fadd_rn(s, partials[static_cast<long long>(ch) * tile_elems + i]);
  }
  out[static_cast<long long>(rb) * tile_elems + i] = s;
}

template <typename T, int W, bool kLanes>
cudaError_t launch_tiles(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                         const int* chunk_slab, const int* idx, const float* vals,
                         const int* lrows, const FactorPtrs& factors, int rank,
                         long long slots, int tile, int chunk_slabs, int block_rows,
                         int rank_block, int r_pad, int num_chunks, float* partials) {
  auto kernel = chunk_tiles_kernel<T, W, kLanes>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(chunk_slab, idx, vals, lrows, factors, rank,
                                          slots, tile, chunk_slabs, block_rows, rank_block,
                                          r_pad, num_chunks, partials);
  return cudaGetLastError();
}

template <typename T, bool kLanes>
cudaError_t dispatch_inputs(int num_inputs, dim3 grid, int threads, size_t smem,
                            cudaStream_t stream, const int* chunk_slab, const int* idx,
                            const float* vals, const int* lrows,
                            const FactorPtrs& factors, int rank, long long slots,
                            int tile, int chunk_slabs, int block_rows, int rank_block,
                            int r_pad, int num_chunks, float* partials) {
#define MTTKRP_SLAB_CASE(NW)                                                          \
  case NW:                                                                            \
    return launch_tiles<T, NW, kLanes>(grid, threads, smem, stream, chunk_slab, idx,   \
                                       vals, lrows, factors, rank, slots, tile,       \
                                       chunk_slabs, block_rows, rank_block, r_pad,    \
                                       num_chunks, partials);
  switch (num_inputs) {
    MTTKRP_SLAB_CASE(1)
    MTTKRP_SLAB_CASE(2)
    MTTKRP_SLAB_CASE(3)
    MTTKRP_SLAB_CASE(4)
    MTTKRP_SLAB_CASE(5)
    MTTKRP_SLAB_CASE(6)
    MTTKRP_SLAB_CASE(7)
    default:
      return cudaErrorInvalidValue;
  }
#undef MTTKRP_SLAB_CASE
}

}  // namespace

// Launches both passes on `stream` for `batch` lanes; returns the first
// cudaError_t (0 on success).  `factor_ptrs` is a host array of
// `num_inputs` device pointers (lane 0's factors) and `factor_lane_strides`
// a host array of `num_inputs` element strides from one lane's factor to
// the next.  `num_chunks` is the (padded) chunk count of every lane.
// `walkers` * `rank_block` threads run each pass-one block.
extern "C" int mttkrp_slab_launch(int device, int batch, const void* chunk_slab,
                                  const void* rb_chunk_ptr, int num_chunks,
                                  int num_row_blocks, int chunk_slabs, const void* idx,
                                  const void* vals, const void* lrows,
                                  const void* factor_ptrs, const void* factor_lane_strides,
                                  int num_inputs, int factors_bf16, int rank,
                                  long long slots, int tile, int block_rows,
                                  int rank_block, int r_pad, int walkers,
                                  void* partials, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || batch > 65535 || num_inputs < 1 || num_inputs > kMaxInputs ||
      rank_block < 1 || walkers < 1 || walkers * rank_block > 1024 ||
      r_pad % rank_block != 0 || num_chunks < 1 || chunk_slabs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FactorPtrs factors = {};
  const void* const* host_ptrs = static_cast<const void* const*>(factor_ptrs);
  const long long* host_strides = static_cast<const long long*>(factor_lane_strides);
  for (int w = 0; w < num_inputs; ++w) {
    factors.p[w] = host_ptrs[w];
    factors.lane_stride[w] = host_strides[w];
  }

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = walkers * rank_block;
  const size_t smem =
      (static_cast<size_t>(block_rows) * rank_block + static_cast<size_t>(walkers) * rank_block) *
          sizeof(float) +
      static_cast<size_t>(walkers) * sizeof(int);
  const dim3 grid1(num_chunks, r_pad / rank_block, batch);
  const int* cs = static_cast<const int*>(chunk_slab);
  const int* ix = static_cast<const int*>(idx);
  const float* vs = static_cast<const float*>(vals);
  const int* lr = static_cast<const int*>(lrows);
  float* part = static_cast<float*>(partials);
#define MTTKRP_SLAB_DISPATCH(T, LANES)                                                  \
  dispatch_inputs<T, LANES>(num_inputs, grid1, threads, smem, s, cs, ix, vs, lr, factors, \
                            rank, slots, tile, chunk_slabs, block_rows, rank_block, r_pad, \
                            num_chunks, part)
  if (factors_bf16) {
    err = batch > 1 ? MTTKRP_SLAB_DISPATCH(__nv_bfloat16, true)
                    : MTTKRP_SLAB_DISPATCH(__nv_bfloat16, false);
  } else {
    err = batch > 1 ? MTTKRP_SLAB_DISPATCH(float, true) : MTTKRP_SLAB_DISPATCH(float, false);
  }
#undef MTTKRP_SLAB_DISPATCH
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tile_elems = block_rows * r_pad;
  const dim3 grid2(num_row_blocks, (tile_elems + kReduceThreads - 1) / kReduceThreads, batch);
  reduce_chunks_kernel<<<grid2, kReduceThreads, 0, s>>>(
      static_cast<const int*>(rb_chunk_ptr), part, tile_elems, num_chunks, num_row_blocks,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mttkrp_slab_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
