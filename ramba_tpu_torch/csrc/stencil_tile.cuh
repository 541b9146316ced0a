// 2-D stencil kernel for Hopper (sm_90a): persistent CTAs fed by a ring of
// row slabs in shared memory.
//
// Replaces ramba_tpu/ops/stencil_pallas.py::_run_fast (pallas_call at :261)
// and ::_run_padded (pallas_call at :370): one kernel for every shape both
// of those accepted.  The TPU needed two because of its (8, 128) tiling
// rule; here the edges are zero-filled loads.
//
// What it computes: out[i, j] = body(taps around (i, j)) for every cell
// whose whole neighbourhood [i-TOP, i+BOTTOM] x [j-LEFT, j+RIGHT] lies in
// the array, and 0 for the border cells that lack one (sstencil's
// semantics).  The body is generated per stencil from the traced tap
// expression (ops/stencil_kernel.py) as a struct with
//     template <class S> __device__ static C eval(const S& s)
// that reads taps through s.template tap<SLOT, DI, DJ>().  Arithmetic runs
// in float for float32 and in double for float64.  bfloat16 is loaded and
// stored with the bf16 intrinsics and computed in float, with every
// operation's result rounded to bfloat16 by the generated body, as torch
// and the JAX package compute bf16 (one float op, then one rounding).
//
// Bound on the H100: HBM bandwidth.  The least traffic is every slot read
// once and the output written once, (slots + 1) * H * W * itemsize bytes,
// at 3.35 TB/s; the arithmetic (nine operations per cell for star2) is far
// below the card's rate, except in bf16, where every operation's rounding
// costs two more.
//
// Design.  The output is cut into column strips TW wide and row blocks BH
// high; a tile is one (strip, row block), numbered strip-major (down a
// strip, then the next strip).  A persistent grid of as many CTAs as fit
// on the card at once (occupancy x SMs) takes the tiles in runs down the
// strips: every strip is cut into the same number R of runs of row blocks,
// CTA b walks run b / S of strip b % S (S strips), and so the CTAs on the
// card at once read the same rows of neighbouring strips together, as
// whole rows of the array.  (Where there are more strips than CTAs, CTA b
// of G takes tiles [b*T/G, (b+1)*T/G) of the strip-major order instead.)
// ops/stencil_kernel.py mirrors this schedule and picks (TW, BH, STAGES)
// per dtype, slots and halo.  Which rows the CTAs read together, and how
// wide a strip is, are what reach the bandwidth; the ring's depth and the
// CTAs per SM matter far less (scripts/stencil_sweep.py times the
// alternatives; PERF.md has them).
//
// Each CTA keeps a ring of STAGES shared-memory stages; a stage holds, for
// every slot, the tile plus its halo: SH = BH+TOP+BOTTOM rows of
// TW+LEFT+RIGHT columns, widened so that its rows start and end on 16-byte
// boundaries: one TMA box.
// While the CTA computes tile i from one stage, the loads of tiles
// i+1 .. i+STAGES-1 are in flight into the others (the TPU kernel's
// double-buffered slab DMA, deeper).  The halo rows a tile shares with the
// one above are fetched again, not kept from the previous stage: they
// were read a moment earlier by the same CTA, so they come from L2, and
// independent stages keep every tile's load one rectangular copy.
//
// Three load paths fill the same ring; Python picks one per launch
// (stencil_kernel.load_path), before the launch:
//   PATH_TMA      one cp.async.bulk.tensor.2d per slot per stage, issued by
//                 one thread, completing on the stage's mbarrier; boxes
//                 that run past the array's far edges are zero-filled by
//                 the hardware, and a box never starts before the array
//                 (tma_shift says why and how).  Needs a row stride that
//                 is a multiple of 16 bytes and 16-byte aligned base
//                 pointers.  The tensor maps are encoded on the host
//                 through cudaGetDriverEntryPoint (no -lcuda) and cached
//                 per (pointer, shape).
//   PATH_CPASYNC  every thread issues cp.async copies of 4 or 8 bytes (f32,
//                 f64 cells; bf16 cell pairs), with src-size 0 for cells
//                 outside the array, which zero-fills them; one commit group
//                 per stage.
//   PATH_LDST     bf16 only, where a row's cells are not 4-byte aligned
//                 (odd width, or a base pointer at an odd element): cp.async
//                 has no 2-byte copy, so the stage is filled with plain
//                 loads and shared-memory stores (no overlap).
// A cell outside the array feeds only border outputs, which are zeroed.
//
// Compute: thread t evaluates the body for column t % TW of every
// (NT/TW)-th row of the tile, so a warp's tap reads are consecutive words
// of shared memory (no bank conflicts) and its stores are one contiguous
// run of the output row (whole 32-byte sectors; 16-byte vector stores
// would need each thread to own adjacent columns, and its tap reads would
// then conflict four ways).  Each output cell is the same expression over
// the same taps as in the plain version, so its bytes do not depend on the
// load path.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "mbarrier.cuh"
#include "ufunc.cuh"  // the NumPy helpers the generated bodies call

namespace ramba {
// Every generated source builds its own library from this header, and two
// bodies with the same dtype, slots, halo and geometry instantiate the
// same template names.  Internal linkage keeps each library's kernels,
// caches and statics its own (exported alike, a library loaded later
// could bind to an earlier one's).
namespace {

constexpr int NT = 256;  // threads per CTA

// load paths (ops/stencil_kernel.py::PATHS)
constexpr int PATH_TMA = 0;
constexpr int PATH_CPASYNC = 1;
constexpr int PATH_LDST = 2;

// error codes besides cudaError_t (ops/stencil_kernel.py reads them)
constexpr int ERR_NO_ENCODE = 900;    // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 1000;      // + the CUresult of a failed encode
constexpr int ERR_NO_FIT = 901;       // occupancy 0: the CTA does not fit

// Storage type T -> compute type C, with the conversions at the edges.
template <typename T> struct Elem;

template <> struct Elem<float> {
  typedef float C;
  __device__ __forceinline__ static C load(float v) { return v; }
  __device__ __forceinline__ static float store(C v) { return v; }
};

template <> struct Elem<double> {
  typedef double C;
  __device__ __forceinline__ static C load(double v) { return v; }
  __device__ __forceinline__ static double store(C v) { return v; }
};

template <> struct Elem<__nv_bfloat16> {
  typedef float C;
  __device__ __forceinline__ static C load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 store(C v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T, int NSLOT> struct Ptrs {
  const T* p[NSLOT];
};

template <int NSLOT> struct Maps {
  CUtensorMap m[NSLOT];
};

// Geometry of one ring stage; ops/stencil_kernel.py::geometry mirrors it.
template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT,
          int TW, int BH, int STAGES>
struct Ring {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int ALIGN = 16 / ES;  // cells in 16 bytes
  // a stage starts LPAD >= LEFT columns left of its strip, on a 16-byte
  // boundary: the TMA faults on a box whose rows start anywhere else
  static constexpr int LPAD = (LEFT + ALIGN - 1) / ALIGN * ALIGN;
  static constexpr int CW = TW + LPAD + RIGHT;  // columns staged
  static constexpr int SW = (CW + ALIGN - 1) / ALIGN * ALIGN;  // = TMA box width
  static constexpr int SH = BH + TOP + BOTTOM;               // = TMA box height
  static constexpr int SLOT_BYTES = (SH * SW * ES + 127) / 128 * 128;
  static constexpr int SLOT_ELEMS = SLOT_BYTES / ES;
  static constexpr int STAGE_BYTES = NSLOT * SLOT_BYTES;
  static constexpr int TX_BYTES = NSLOT * SH * SW * ES;  // one stage's TMA bytes
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + STAGES * 8;
  static_assert(SW <= 256 && SH <= 256, "a TMA box side is at most 256");
  static_assert(NT % TW == 0, "TW divides the CTA's threads");
  static_assert(STAGES >= 2, "a ring needs two stages");
};

// The view of one staged tile one output cell's body reads.
template <typename T, class R, int TOP>
struct Tap {
  const T* smem;  // the stage: NSLOT slot buffers, R::SLOT_ELEMS apart
  int r;          // the output cell's row inside the tile
  int c;          // its staged column

  template <int SLOT, int DI, int DJ>
  __device__ __forceinline__ typename Elem<T>::C tap() const {
    return Elem<T>::load(
        smem[SLOT * R::SLOT_ELEMS + (r + TOP + DI) * R::SW + (c + DJ)]);
  }
};

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// cp.async of BYTES bytes; ok == false copies nothing and zero-fills.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES),
                  "r"(ok ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The card refuses (an illegal-instruction fault) a TMA box whose rows do
// not start on a 16-byte boundary of the array, and one that starts at a
// negative coordinate; one that runs past the far edges is zero-filled.  So a tile of the first row block or the first strip loads
// its box from row or column 0 instead, and its cells land that many rows
// and columns earlier in the stage than the tap view expects: tma_shift
// is that many.  Only border outputs, which are not evaluated, would read
// before the box.
__device__ __forceinline__ int tma_shift(int64_t start) {
  return start < 0 ? (int)-start : 0;
}

// Start filling one stage with tile `tile` (its halo included).  TMA: one
// thread arms the stage's barrier and issues one box per slot.  cp.async
// and plain loads: every thread copies its share of the cells.
template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT,
          int TW, int BH, int STAGES, int PATH>
__device__ __forceinline__ void fill_stage(const Maps<NSLOT>& maps,
                                           const Ptrs<T, NSLOT>& in,
                                           unsigned char* stage, uint64_t* bar,
                                           int64_t tile, int64_t H, int64_t W,
                                           int64_t n_rb) {
  typedef Ring<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES> R;
  const int64_t row0 = (tile % n_rb) * BH - TOP;  // first staged row
  const int64_t col0 = (tile / n_rb) * TW - R::LPAD;  // first column
  if constexpr (PATH == PATH_TMA) {
    // the box starts inside the array (see tma_shift)
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, (uint32_t)R::TX_BYTES);
      const int c0 = (int)(col0 + tma_shift(col0));
      const int r0 = (int)(row0 + tma_shift(row0));
      for (int s = 0; s < NSLOT; ++s)
        tma_load_2d(stage + s * R::SLOT_BYTES, &maps.m[s], bar, c0, r0);
    }
  } else if constexpr (PATH == PATH_CPASYNC && R::ES == 2) {
    // bf16 cell pairs: W is even and the bases 4-byte aligned, and col0 is
    // a multiple of 8, so a pair lies wholly inside or wholly outside the
    // array
    constexpr int PW = (R::CW + 1) / 2;
    for (int s = 0; s < NSLOT; ++s) {
      const T* src = in.p[s];
      T* d = reinterpret_cast<T*>(stage + s * R::SLOT_BYTES);
      for (int k = threadIdx.x; k < R::SH * PW; k += NT) {
        const int i = k / PW, j = k % PW;
        const int64_t gr = row0 + i, gc = col0 + 2 * j;
        const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W;
        cp_async<4>(d + i * R::SW + 2 * j, ok ? src + gr * W + gc : src, ok);
      }
    }
  } else {
    for (int s = 0; s < NSLOT; ++s) {
      const T* src = in.p[s];
      T* d = reinterpret_cast<T*>(stage + s * R::SLOT_BYTES);
      for (int k = threadIdx.x; k < R::SH * R::CW; k += NT) {
        const int i = k / R::CW, j = k % R::CW;
        const int64_t gr = row0 + i, gc = col0 + j;
        const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W;
        if constexpr (PATH == PATH_CPASYNC) {
          cp_async<R::ES>(d + i * R::SW + j, ok ? src + gr * W + gc : src, ok);
        } else {
          d[i * R::SW + j] = ok ? src[gr * W + gc]
                                : Elem<T>::store(typename Elem<T>::C(0));
        }
      }
    }
  }
}

template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT,
          int TW, int BH, int STAGES, int PATH, int MIN_CTAS, class Body>
__global__ void __launch_bounds__(NT, MIN_CTAS)
stencil_ring_kernel(const __grid_constant__ Maps<NSLOT> maps,
                    Ptrs<T, NSLOT> in, T* __restrict__ out, int64_t H,
                    int64_t W, int64_t n_rb, int64_t n_strips, int64_t runs) {
  typedef Ring<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES> R;
  typedef Tap<T, R, TOP> TapT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + STAGES * R::STAGE_BYTES);
  const T zero = Elem<T>::store(typename Elem<T>::C(0));
  // this CTA's run of tiles [t0, t0 + n) (stencil_kernel.tile_range)
  int64_t t0;
  int n;
  if (runs > 0) {  // run blockIdx / n_strips of strip blockIdx % n_strips
    const int64_t strip = blockIdx.x % n_strips, run = blockIdx.x / n_strips;
    const int64_t rb0 = run * n_rb / runs;
    t0 = strip * n_rb + rb0;
    n = (int)((run + 1) * n_rb / runs - rb0);
  } else {  // more strips than CTAs: equal runs of the strip-major order
    const int64_t tiles = n_rb * n_strips;
    t0 = (int64_t)blockIdx.x * tiles / gridDim.x;
    n = (int)(((int64_t)blockIdx.x + 1) * tiles / gridDim.x - t0);
  }

  if constexpr (PATH == PATH_TMA) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // prologue: tiles 0 .. STAGES-2 of the run in flight
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n)
      fill_stage<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES, PATH>(
          maps, in, smem_raw + p * R::STAGE_BYTES, &full[p], t0 + p, H, W,
          n_rb);
    if constexpr (PATH == PATH_CPASYNC) cp_async_commit();
  }

  TapT t;
  const int col = threadIdx.x % TW;  // this thread's output column in a tile
  for (int i = 0; i < n; ++i) {
    // the stage tile i+STAGES-1 goes into was released by the barrier
    // that ended iteration i-1
    const int nx = i + STAGES - 1;
    if (nx < n)
      fill_stage<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES, PATH>(
          maps, in, smem_raw + (nx % STAGES) * R::STAGE_BYTES,
          &full[nx % STAGES], t0 + nx, H, W, n_rb);
    const int s = i % STAGES;
    if constexpr (PATH == PATH_TMA) {
      mbar_wait(&full[s], (uint32_t)((i / STAGES) & 1));
    } else {
      if constexpr (PATH == PATH_CPASYNC) {
        cp_async_commit();
        cp_async_wait<STAGES - 1>();  // tile i's group has landed
      }
      __syncthreads();
    }

    const int64_t tile = t0 + i;
    const int64_t row0 = (tile % n_rb) * BH;
    const int64_t gc = (tile / n_rb) * TW + col;
    t.smem = reinterpret_cast<const T*>(smem_raw + s * R::STAGE_BYTES);
    t.c = col + R::LPAD;
    if constexpr (PATH == PATH_TMA) {
      t.smem -= tma_shift(row0 - TOP) * R::SW;
      t.c -= tma_shift(gc - col - R::LPAD);
    }
    if (gc < W) {
      const bool col_in = gc >= LEFT && gc < W - RIGHT;
      for (int r = threadIdx.x / TW; r < BH; r += NT / TW) {
        const int64_t gr = row0 + r;
        if (gr >= H) break;
        t.r = r;
        const bool valid = col_in && gr >= TOP && gr < H - BOTTOM;
        out[gr * W + gc] = valid ? Elem<T>::store(Body::eval(t)) : zero;
      }
    }
    __syncthreads();  // every thread is done with stage s
  }
}

// ---------------------------------------------------------------------------
// host side

template <typename T> struct TmaType;
template <> struct TmaType<float> {
  static constexpr CUtensorMapDataType v = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct TmaType<double> {
  static constexpr CUtensorMapDataType v = CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
};
template <> struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType v = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The CUDA driver's cuTensorMapEncodeTiled, found once through the runtime.
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  });
  return fn;
}

// The tensor map of an H x W row-major array at `ptr` read in SH x SW
// boxes, cached per (pointer, shape): sstencil_iterate's ping-pong buffers
// are encoded once, not every sweep.  Returns 0 or an error code.
template <typename T, int SW, int SH>
int tensor_map(CUtensorMap* out, const void* ptr, long long H, long long W) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    long long H, W;
  };
  constexpr int N = 32;
  static Entry cache[N];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> g(mu);
  for (int k = 0; k < used; ++k) {
    if (cache[k].ptr == ptr && cache[k].H == H && cache[k].W == W) {
      *out = cache[k].map;
      return 0;
    }
  }
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)H};
  cuuint64_t strides[1] = {(cuuint64_t)W * sizeof(T)};
  cuuint32_t box[2] = {(cuuint32_t)SW, (cuuint32_t)SH};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(out, TmaType<T>::v, 2, const_cast<void*>(ptr), dims, strides,
                  box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads 0
  if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  Entry& e = cache[next];
  e.map = *out;
  e.ptr = ptr;
  e.H = H;
  e.W = W;
  next = (next + 1) % N;
  if (used < N) ++used;
  return 0;
}

// CTAs of this kernel one SM holds at once (its shared memory, registers
// and threads), cached per device.  0 on error.
template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT,
          int TW, int BH, int STAGES, int PATH, int MIN_CTAS, class Body>
int ctas_per_sm(int dev) {
  typedef Ring<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES> R;
  static int cached[64] = {0};
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] > 0) return cached[dev];
  auto kern = stencil_ring_kernel<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH,
                                  STAGES, PATH, MIN_CTAS, Body>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           R::SMEM_BYTES) != cudaSuccess)
    return 0;
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT,
                                                    R::SMEM_BYTES) != cudaSuccess)
    return 0;
  cached[dev] = occ;
  return occ;
}

template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT,
          int TW, int BH, int STAGES, int PATH, int MIN_CTAS, class Body>
int launch_path(const void* const* ins, void* out, long long H, long long W,
                void* stream) {
  typedef Ring<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES> R;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int occ = ctas_per_sm<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH,
                              STAGES, PATH, MIN_CTAS, Body>(dev);
  if (occ <= 0) return ERR_NO_FIT;
  Maps<NSLOT> maps;
  memset(&maps, 0, sizeof(maps));
  Ptrs<T, NSLOT> p;
  for (int s = 0; s < NSLOT; ++s) {
    p.p[s] = static_cast<const T*>(ins[s]);
    if (PATH == PATH_TMA) {
      int rc = tensor_map<T, R::SW, R::SH>(&maps.m[s], ins[s], H, W);
      if (rc != 0) return rc;
    }
  }
  // the schedule (stencil_kernel.schedule): every strip cut into the same
  // number of runs, so the CTAs on the card at once walk the same rows of
  // neighbouring strips together; with more strips than CTAs, equal runs
  // of the strip-major order
  const long long n_rb = (H + BH - 1) / BH;
  const long long n_strips = (W + TW - 1) / TW;
  const long long resident = (long long)occ * n_sm;
  long long runs = 0, grid = resident;
  if (n_strips <= resident) {
    runs = resident / n_strips < n_rb ? resident / n_strips : n_rb;
    grid = n_strips * runs;
  } else if (n_rb * n_strips < grid) {
    grid = n_rb * n_strips;
  }
  stencil_ring_kernel<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES, PATH,
                      MIN_CTAS, Body>
      <<<(unsigned)grid, NT, R::SMEM_BYTES,
         static_cast<cudaStream_t>(stream)>>>(
          maps, p, static_cast<T*>(out), (int64_t)H, (int64_t)W,
          (int64_t)n_rb, (int64_t)n_strips, (int64_t)runs);
  return (int)cudaGetLastError();
}

// Host entry: launch on the caller's stream along `path`.  Returns 0, a
// CUDA error, or one of the ERR_* codes above.
template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT,
          int TW, int BH, int STAGES, int MIN_CTAS, class Body>
int launch_stencil(int path, const void* const* ins, void* out, long long H,
                   long long W, void* stream) {
  switch (path) {
    case PATH_TMA:
      return launch_path<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES,
                         PATH_TMA, MIN_CTAS, Body>(ins, out, H, W, stream);
    case PATH_CPASYNC:
      return launch_path<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES,
                         PATH_CPASYNC, MIN_CTAS, Body>(ins, out, H, W, stream);
    case PATH_LDST:
      if constexpr (sizeof(T) == 2)
        return launch_path<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES,
                           PATH_LDST, MIN_CTAS, Body>(ins, out, H, W, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// CTAs per SM of one path's kernel on the current device (0 on error).
template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT,
          int TW, int BH, int STAGES, int MIN_CTAS, class Body>
int stencil_ctas_per_sm(int path) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  switch (path) {
    case PATH_TMA:
      return ctas_per_sm<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES,
                         PATH_TMA, MIN_CTAS, Body>(dev);
    case PATH_CPASYNC:
      return ctas_per_sm<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES,
                         PATH_CPASYNC, MIN_CTAS, Body>(dev);
    case PATH_LDST:
      if constexpr (sizeof(T) == 2)
        return ctas_per_sm<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, TW, BH, STAGES,
                           PATH_LDST, MIN_CTAS, Body>(dev);
      break;
  }
  return 0;
}

}  // namespace
}  // namespace ramba
