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
// bfloat16 factors.  The Python wrappers are in
// repro_torch/kernels/mttkrp_slab.py; its plain PyTorch version
// mttkrp_slab_plain is the reference the kernel is held against, and its
// launch_config() chooses every shape parameter the launch below takes.
//
// What bounds it.  Bytes: each rank block reads the slot stream once,
// G*T*(W+2)*4 bytes (W index rows, the values, the local rows), plus the
// factor rows it gathers and the (rows, R) output.  For the chicago
// stand-in at rank 16 that is about 107 MB per mode, 0.032 ms at
// 3.35 TB/s; the arithmetic (W+1 flops per slot and column) is two orders
// of magnitude below the card's float32 rate.  What held the first
// version 11-14 times above that bound was latency: each slot was a chain
// of dependent loads (value, then index, then factor row), repeated by
// every thread of a walker.  What holds this one (3.6-4.5 times the
// bound) is the shared-memory pipe and the SM's occupancy: every slot
// reads W factor rows of rank_block floats from shared memory or L2, and
// pass one runs 4 blocks of 256 threads per SM at its 64 registers.
//
// Times on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py; PERF.md
// has the runs): chicago at rank 16, pass one plus pass two on the card,
// 0.115 / 0.138 / 0.145 / 0.141 ms for modes 0-3 (the first version:
// 0.33-0.46 ms per call); a call, host included, 0.17-0.28 ms, under
// torch.sparse.mm's 0.31-0.84 ms on every mode; the batched entry at
// B = 8 on the uber bucket 0.20-0.25 ms on the card (first version:
// 0.85-0.97 ms per call).
//
// Two passes, no atomics, a fixed summation order.  On the TPU the grid
// runs in order, so consecutive slabs of one row block revisit one output
// tile held in VMEM.  Here blocks run in no order, and a whole mode can
// sit in one row block (chicago's modes 1-3 have 24, 77 and 32 rows, so
// one row block holds all 5.3M nonzeros).  So:
//
//   pass 1 (chunk_tiles_kernel): one block per (chunk, rank block, lane).
//     A chunk is a run of at most C slabs of one row block (the wrapper's
//     chunk table).  The block splits the chunk's slots into contiguous
//     runs, one per "walker" of rank_block/V threads, each thread owning
//     V consecutive rank columns.  The split depends on the full chunk
//     size and the walker count only, so appended cap slabs never move a
//     real slot to another walker.  Rows are sorted inside a row block, so
//     a walker sums each row's run in registers and stores it once into a
//     shared-memory (BR, RB) tile; only a walker's first run may share its
//     row with an earlier walker, so it goes to a carry slot that is added
//     after a barrier, in walker order.  The tile is written to
//     partials[chunk].
//   pass 2 (sum_ranges_kernel, launched twice): the partials of each row
//     block are summed in fixed groups of consecutive chunks (the group
//     table, group_chunk), then each row block's group sums are added in
//     group order (rb_group_ptr).  Groups start at each row block's first
//     chunk, so trailing cap-slab chunks add only +0.0.
//
// What each part of the design does on this card:
//
//   * Wide columns (V = 4): a thread owns four consecutive columns and
//     gathers them with one 16-byte load (8 bytes for bfloat16), so a
//     walker is rank_block/4 threads and the per-slot index, value and
//     row work is done by a quarter of the threads.  V = 1 serves ranks
//     or rank blocks that are not a multiple of 4 (the rank-33 case).
//   * Slot stream read ahead: each stage of a ring of kRingStages buffers
//     in shared memory holds the next stage_slots slots of every walker's
//     run, all W + 2 streams, copied with cp.async (16 bytes a copy when
//     the stream is 16-byte aligned).  Stage s + 1 is in flight while the
//     walkers read stage s from shared memory as int4/float4, four slots
//     at a time, so the only load left in a slot's chain that leaves the
//     SM is the gather of a large factor row.  No load waits on a branch.
//   * Small factors on chip: input factors whose rank-block columns fit a
//     fixed budget (smallest first; staged_mask) are copied into shared
//     memory once per block, the counterpart of the TPU kernel's one-hot
//     gather for small factors.  Larger ones are gathered from L2 with
//     __ldg.
//   * Pass two over the whole card: groups of GROUP_CHUNKS chunks are
//     summed in parallel, so a mode with one row block and hundreds of
//     chunks spreads over tens of blocks instead of eight.
//
// Each part alone, by kernels/slab_ablation.py on chicago: one column per
// thread doubles the time; no staged factors add 17-42%; direct loads of
// the slot stream in place of the ring 8-19%; one group per row block
// 0.046 ms on each one-row-block mode.  Chunks of 16 slabs beat 8, 32 and
// 64 (fewer idle SMs in the last wave); a ring of 2 stages of 8 slots per
// walker beats 3 or 4 stages and stages of 4, 16 or 32 slots.
//
// Lanes (blockIdx.z).  The batched service stacks B packings that share
// one slab cap, tiling and rank (the TPU path's jax.vmap over the kernel):
// lane b reads its own slice of idx (B, W, G*T), vals and lrows (B, 1, G*T),
// factors (B, I_w, R) and chunk and group tables, and writes its own
// partials and output.  Lanes' tables are padded to the batch's largest
// counts with empty chunks and groups, whose blocks return at once or sum
// nothing that is read.  The lane offsets are folded into base pointers
// once per block, and every float operation is an explicitly rounded
// __fmul_rn / __fadd_rn that the compiler never fuses into an FMA, so lane
// b of a batched launch sums bitwise as a single launch on lane b's
// packing.
//
// Slots whose value is exactly 0 (slab padding and cap slabs, whose local
// row 0 breaks the row order, and exact-zero run-time values) are
// skipped: they would add +-0.0, which changes no sum.  PERF.md carries
// the kernel's times on the card beside its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxInputs = 7;
constexpr int kMaxDevices = 16;     // devices whose kernel attributes are remembered
constexpr int kUnroll = 4;          // slots a walker takes per step: one 16-byte read per stream
constexpr int kRingStages = 2;      // ring buffers: one stage in flight while one is read
constexpr int kReduceThreads = 256;

struct SlabArgs {
  const int* chunk_slab;            // lane 0's (NC+1) chunk table
  const int* idx;                   // lane 0's (W, slots)
  const float* vals;                // lane 0's (slots,)
  const int* lrows;                 // lane 0's (slots,)
  const void* fac[kMaxInputs];      // lane 0's factors (I_w, rank)
  long long fac_lane_stride[kMaxInputs];  // elements from one lane's factor to the next
  int fac_rows[kMaxInputs];
  float* partials;                  // (B, NC, BR, r_pad)
  long long slots;
  int rank, tile, chunk_slabs, block_rows, rank_block, r_pad, num_chunks;
  int walkers, stage_slots, staged_mask, stream_vec;
};

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool sixteen) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (sixteen) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// V consecutive columns of a factor row in device memory (read-only path).
template <int V>
__device__ __forceinline__ void gather_global(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    out[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void gather_global(const __nv_bfloat16* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}

// V consecutive columns of a staged factor row in shared memory.
template <int V>
__device__ __forceinline__ void gather_shared(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    out[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

__device__ __forceinline__ int lane_of(const int4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// Dynamic shared memory of one pass-one block, in 4-byte words, before the
// staged factors; kernels/mttkrp_slab.py::smem_bytes is the same formula.
__host__ __device__ __forceinline__ long long base_smem_words(int num_inputs, int walkers,
                                                              int stage_slots, int block_rows,
                                                              int rank_block) {
  return static_cast<long long>(kRingStages) * (num_inputs + 2) * walkers * stage_slots  // ring
         + static_cast<long long>(block_rows) * rank_block   // partial tile
         + static_cast<long long>(walkers) * rank_block      // carry rows
         + ((walkers + 3) / 4) * 4;                          // carry row ids (16-byte padded)
}

template <typename T, int W, int V>
__global__ void __launch_bounds__(1024) chunk_tiles_kernel(const SlabArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int lane = blockIdx.z;
  const int chunk = blockIdx.x;
  const int* chunk_slab = a.chunk_slab + static_cast<long long>(lane) * (a.num_chunks + 1);
  const long long e0 = static_cast<long long>(chunk_slab[chunk]) * a.tile;
  const int n = (chunk_slab[chunk + 1] - chunk_slab[chunk]) * a.tile;  // slots of this chunk
  if (n == 0) return;  // a lane's padding chunk: its partial is never read

  // Lane offsets, folded into the base pointers once.
  const long long lane_slots = static_cast<long long>(lane) * a.slots;
  const int* idx = a.idx + lane_slots * W + e0;
  const float* vals = a.vals + lane_slots + e0;
  const int* lrows = a.lrows + lane_slots + e0;
  const T* fac[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    fac[w] = static_cast<const T*>(a.fac[w]) + lane * a.fac_lane_stride[w];
  }

  const int RB = a.rank_block;
  const int walkers = a.walkers;
  const int S = a.stage_slots;
  const int tpw = RB / V;
  const int c = threadIdx.x % tpw;
  const int k = threadIdx.x / tpw;
  const int col0 = blockIdx.y * RB;
  const int col = col0 + c * V;
  const bool live = col < a.rank;  // padded rank columns compute zeros

  const int ring_stream = walkers * S;           // words of one stream in one stage
  const int ring_stage = (W + 2) * ring_stream;  // words of one stage
  int* ring = smem;                              // [kRingStages][W + 2][walkers][S]
  float* tile_s = reinterpret_cast<float*>(smem + kRingStages * ring_stage);  // (BR, RB)
  float* carry_s = tile_s + a.block_rows * RB;                      // (walkers, RB)
  int* carry_row = reinterpret_cast<int*>(carry_s + walkers * RB);  // (walkers,)
  float* staged_s = reinterpret_cast<float*>(carry_row + ((walkers + 3) / 4) * 4);

  for (int i = threadIdx.x; i < a.block_rows * RB; i += blockDim.x) tile_s[i] = 0.0f;
  if (c == 0) carry_row[k] = -1;

  // Small factors: this rank block's columns of every staged input, as
  // float32, once per block.
  const float* sfac[W];
  {
    int off = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      sfac[w] = staged_s + off;
      if ((a.staged_mask >> w) & 1) {
        const int elems = a.fac_rows[w] * RB;
        for (int e = threadIdx.x; e < elems; e += blockDim.x) {
          const int i = e / RB;
          const int gc = col0 + (e - i * RB);
          staged_s[off + e] =
              gc < a.rank ? to_f32(fac[w][static_cast<long long>(i) * a.rank + gc]) : 0.0f;
        }
        off += elems;
      }
    }
  }

  // Walker k takes slots [k*per, (k+1)*per) of the chunk, with `per` a
  // function of the full chunk size and the walker count only (rounded
  // to whole 4-slot steps).
  const int full = a.chunk_slabs * a.tile;
  const int per = (((full + walkers - 1) / walkers) + 3) / 4 * 4;
  const int beg = k * per;
  const int end = min(beg + per, n);
  const int nstages = (per + S - 1) / S;

  // Copies of one stage: each walker's next S slots of each stream, in
  // granules of 4 slots (16 bytes) or, for an unaligned stream, of 1.
  const int gran = a.stream_vec ? 4 : 1;
  const int gran_per_walker = S / gran;
  const int granules = walkers * gran_per_walker;
  auto prefetch = [&](int s) {  // copies stage s (if there is one) as one commit group
    int* buf = ring + (s % kRingStages) * ring_stage;
    for (int r = threadIdx.x; r < granules && s < nstages; r += blockDim.x) {
      const int kk = r / gran_per_walker;
      const int p = (r - kk * gran_per_walker) * gran;
      const int j = kk * per + s * S + p;
      if (j < n && j < (kk + 1) * per) {
        int* dst = buf + kk * S + p;
#pragma unroll
        for (int q = 0; q < W; ++q) cp_async(dst + q * ring_stream, idx + q * a.slots + j, gran == 4);
        cp_async(dst + W * ring_stream, vals + j, gran == 4);
        cp_async(dst + (W + 1) * ring_stream, lrows + j, gran == 4);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) prefetch(s);
  float run[V];
#pragma unroll
  for (int v = 0; v < V; ++v) run[v] = 0.0f;
  int row = -1;
  bool first_run = true;

  auto flush = [&]() {
    if (first_run) {
      store_cols<V>(carry_s + k * RB + c * V, run);
      if (c == 0) carry_row[k] = row;
      first_run = false;
    } else {
      store_cols<V>(tile_s + row * RB + c * V, run);
    }
  };

  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kRingStages - 2>();
    __syncthreads();  // stage s has landed everywhere; stage s - 1's buffer is free
    prefetch(s + kRingStages - 1);
    const int* buf = ring + (s % kRingStages) * ring_stage + k * S;
    const int js = beg + s * S;
    for (int u0 = 0; u0 < S && js + u0 < end; u0 += kUnroll) {
      int4 ix[W];
#pragma unroll
      for (int w = 0; w < W; ++w) ix[w] = *reinterpret_cast<const int4*>(buf + w * ring_stream + u0);
      const float4 v4 = *reinterpret_cast<const float4*>(buf + W * ring_stream + u0);
      const int4 r4 = *reinterpret_cast<const int4*>(buf + (W + 1) * ring_stream + u0);
      float p[kUnroll][V];
      int rr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float v = lane_of(v4, u);
        const bool take = js + u0 + u < end && v != 0.0f;
        rr[u] = take ? lane_of(r4, u) : -1;
#pragma unroll
        for (int x = 0; x < V; ++x) p[u][x] = v;
        if (take) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const long long i = lane_of(ix[w], u);  // factor row
            float f[V];
            if ((a.staged_mask >> w) & 1) {
              gather_shared<V>(sfac[w] + i * RB + c * V, f);
            } else if (live) {
              gather_global<V>(fac[w] + i * a.rank + col, f);
            } else {
#pragma unroll
              for (int x = 0; x < V; ++x) f[x] = 0.0f;
            }
#pragma unroll
            for (int x = 0; x < V; ++x) p[u][x] = __fmul_rn(p[u][x], f[x]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (rr[u] < 0) continue;
        if (rr[u] != row) {
          if (row >= 0) flush();
          row = rr[u];
#pragma unroll
          for (int x = 0; x < V; ++x) run[x] = 0.0f;
        }
#pragma unroll
        for (int x = 0; x < V; ++x) run[x] = __fadd_rn(run[x], p[u][x]);
      }
    }
  }
  if (row >= 0) flush();
  __syncthreads();

  for (int cc = threadIdx.x; cc < RB; cc += blockDim.x) {
    for (int q = 0; q < walkers; ++q) {
      const int rr = carry_row[q];
      if (rr >= 0) tile_s[rr * RB + cc] = __fadd_rn(tile_s[rr * RB + cc], carry_s[q * RB + cc]);
    }
  }
  __syncthreads();

  float* dst = a.partials +
               (static_cast<long long>(lane) * a.num_chunks + chunk) * a.block_rows * a.r_pad +
               col0;
  for (int i = threadIdx.x; i < a.block_rows * RB; i += blockDim.x) {
    const int r = i / RB;
    dst[static_cast<long long>(r) * a.r_pad + (i - r * RB)] = tile_s[i];
  }
}

// dst[seg] = the sum of src[t] over t in [ptr[seg], ptr[seg+1]), in order,
// elementwise over (BR, r_pad) tiles; lane z has its own ptr, src and dst.
__global__ void sum_ranges_kernel(const int* __restrict__ ptr, int num_segs,
                                  const float* __restrict__ src, int src_tiles,
                                  float* __restrict__ dst, int tile_elems) {
  const int seg = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= tile_elems) return;
  const long long lane = blockIdx.z;
  ptr += lane * (num_segs + 1);
  src += lane * src_tiles * tile_elems;
  dst += lane * num_segs * tile_elems;
  const int t0 = ptr[seg];
  const int t1 = ptr[seg + 1];
  float s = 0.0f;
  for (int t = t0; t < t1; ++t) {
    s = __fadd_rn(s, src[static_cast<long long>(t) * tile_elems + i]);
  }
  dst[static_cast<long long>(seg) * tile_elems + i] = s;
}

using PassOne = void (*)(SlabArgs);

template <typename T, int V>
PassOne pass_one_for(int num_inputs) {
  switch (num_inputs) {
    case 1: return chunk_tiles_kernel<T, 1, V>;
    case 2: return chunk_tiles_kernel<T, 2, V>;
    case 3: return chunk_tiles_kernel<T, 3, V>;
    case 4: return chunk_tiles_kernel<T, 4, V>;
    case 5: return chunk_tiles_kernel<T, 5, V>;
    case 6: return chunk_tiles_kernel<T, 6, V>;
    case 7: return chunk_tiles_kernel<T, 7, V>;
    default: return nullptr;
  }
}

// The pass-one instance for the factors' type, the input count and the
// columns per thread, with its shared memory allowed up to `smem` bytes.
// The SM's L1/shared split is left at CUDA's default: what L1 it keeps holds
// rows of the large factors (a split forced to the most shared memory ran
// 3-6% slower on chicago's modes 1-3).  nullptr if there is no such instance.
PassOne pass_one(int num_inputs, int factors_bf16, int cols, size_t smem, cudaError_t* err) {
  PassOne k = nullptr;
  if (factors_bf16) {
    k = cols == 4 ? pass_one_for<__nv_bfloat16, 4>(num_inputs)
                  : pass_one_for<__nv_bfloat16, 1>(num_inputs);
  } else {
    k = cols == 4 ? pass_one_for<float, 4>(num_inputs) : pass_one_for<float, 1>(num_inputs);
  }
  *err = k ? cudaSuccess : cudaErrorInvalidValue;
  if (!k || smem <= 48 * 1024) return k;
  // Above 48 KB a block's shared memory must be allowed first: once per
  // instance and device, and again when a launch needs more than before.
  static size_t allowed[kMaxDevices][2][2][kMaxInputs + 1];
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return nullptr;
  size_t* have = device < kMaxDevices
                     ? &allowed[device][factors_bf16 != 0][cols == 4][num_inputs]
                     : nullptr;
  if (have && *have >= smem) return k;
  *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  if (*err != cudaSuccess) return nullptr;
  if (have) *have = smem;
  return k;
}

}  // namespace

// Launches pass one and both steps of pass two on `stream` for `batch`
// lanes; returns the first cudaError_t (0 on success).  `factor_ptrs` is a
// host array of `num_inputs` device pointers (lane 0's factors),
// `factor_lane_strides` a host array of element strides from one lane's
// factor to the next and `factor_rows` one of row counts.  `num_chunks`
// and `num_groups` are every lane's (padded) chunk and group counts.
// `cols` (1 or 4) columns per thread, `walkers`, `stage_slots`,
// `staged_mask` and `stream_vec` come from the wrapper's launch_config().
extern "C" int mttkrp_slab_launch(
    int device, int batch, const void* chunk_slab, int num_chunks, int chunk_slabs,
    const void* group_chunk, int num_groups, const void* rb_group_ptr, int num_row_blocks,
    const void* idx, const void* vals, const void* lrows, long long slots, int tile,
    int stream_vec, const void* factor_ptrs, const void* factor_lane_strides,
    const void* factor_rows, int num_inputs, int factors_bf16, int rank, int block_rows,
    int rank_block, int r_pad, int cols, int walkers, int stage_slots, int staged_mask,
    void* partials, void* group_sums, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || batch > 65535 || num_inputs < 1 || num_inputs > kMaxInputs ||
      rank_block < 1 || walkers < 1 || (cols != 1 && cols != 4) || rank_block % cols != 0 ||
      walkers * (rank_block / cols) > 1024 || r_pad % rank_block != 0 || num_chunks < 1 ||
      num_groups < 1 || chunk_slabs < 1 || stage_slots < 4 || stage_slots % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlabArgs args = {};
  args.chunk_slab = static_cast<const int*>(chunk_slab);
  args.idx = static_cast<const int*>(idx);
  args.vals = static_cast<const float*>(vals);
  args.lrows = static_cast<const int*>(lrows);
  const void* const* host_ptrs = static_cast<const void* const*>(factor_ptrs);
  const long long* host_strides = static_cast<const long long*>(factor_lane_strides);
  const int* host_rows = static_cast<const int*>(factor_rows);
  long long staged_words = 0;
  for (int w = 0; w < num_inputs; ++w) {
    args.fac[w] = host_ptrs[w];
    args.fac_lane_stride[w] = host_strides[w];
    args.fac_rows[w] = host_rows[w];
    if ((staged_mask >> w) & 1) staged_words += static_cast<long long>(host_rows[w]) * rank_block;
  }
  args.partials = static_cast<float*>(partials);
  args.slots = slots;
  args.rank = rank;
  args.tile = tile;
  args.chunk_slabs = chunk_slabs;
  args.block_rows = block_rows;
  args.rank_block = rank_block;
  args.r_pad = r_pad;
  args.num_chunks = num_chunks;
  args.walkers = walkers;
  args.stage_slots = stage_slots;
  args.staged_mask = staged_mask;
  args.stream_vec = stream_vec;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = walkers * (rank_block / cols);
  const size_t smem =
      (base_smem_words(num_inputs, walkers, stage_slots, block_rows, rank_block) + staged_words) *
      sizeof(float);
  const PassOne kernel = pass_one(num_inputs, factors_bf16, cols, smem, &err);
  if (!kernel) return static_cast<int>(err);
  kernel<<<dim3(num_chunks, r_pad / rank_block, batch), threads, smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tile_elems = block_rows * r_pad;
  const int ys = (tile_elems + kReduceThreads - 1) / kReduceThreads;
  sum_ranges_kernel<<<dim3(num_groups, ys, batch), kReduceThreads, 0, s>>>(
      static_cast<const int*>(group_chunk), num_groups, static_cast<const float*>(partials),
      num_chunks, static_cast<float*>(group_sums), tile_elems);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_ranges_kernel<<<dim3(num_row_blocks, ys, batch), kReduceThreads, 0, s>>>(
      static_cast<const int*>(rb_group_ptr), num_row_blocks,
      static_cast<const float*>(group_sums), num_groups, static_cast<float*>(out), tile_elems);
  return static_cast<int>(cudaGetLastError());
}

// Pass-one blocks resident on one SM for a launch shape (the CUDA
// occupancy calculator, after the attributes a launch sets); a negative
// cudaError_t on failure.
extern "C" int mttkrp_slab_blocks_per_sm(int device, int num_inputs, int factors_bf16,
                                         int cols, int threads, long long smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const PassOne kernel = pass_one(num_inputs, factors_bf16, cols, static_cast<size_t>(smem), &err);
  if (!kernel) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      static_cast<size_t>(smem));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

extern "C" const char* mttkrp_slab_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
