// Merge-path CsrMV for Hopper (sm_90a): a tile kernel and a carry fix-up.
//
// Replaces merge_spmv_tpu/ops/csrmv_pallas.py::_spmv_kernel.  That kernel
// walks the merge tiles in order on one TensorCore and carries the partial
// sum of a row that spans tiles in SMEM (csrmv_pallas.py:919-929).  Here the
// work goes back to the reference's pipeline (CUB's DeviceSpmvKernel +
// DeviceSegmentFixupKernel), run by persistent blocks:
//
//   merge_tile_kernel   each block owns a contiguous run of merge tiles
//                       [r * run_tiles, (r + 1) * run_tiles), each of
//                       blockDim.x * kItems merge items (rows + nonzeros,
//                       equal work by construction), and walks it in order as
//                       the TPU kernel walks its grid: the partial of the row
//                       open at a tile's end carries into the next tile in
//                       registers, and only the run's last tile leaves a
//                       carry pair (row, partial), whose partial is exactly 0
//                       when the run ends on a row end.  A tile passes through
//                       four steps, pipelined so that each overlaps the
//                       tile before:
//                       1. stage: three warps copy the tile's values, column
//                          indices and row ends into a shared-memory stage
//                          with cp.async.bulk (whole 16-byte units) and
//                          cp.async (the elements at the edges), completing on
//                          an mbarrier, two tiles ahead of its reduce;
//                       2. gather: x[cols[j]] for thread i's nonzeros
//                          j = i, i + B, ... (coalesced, every gather
//                          independent), issued before the previous tile's
//                          reduce, so that their latency passes during it;
//                       3. prepare: the products values[j] * x[cols[j]] into
//                          shared memory (as CUB's AgentSpmv::ConsumeTile
//                          stages them), and each row that ends in the tile
//                          marks its last nonzero; the stage is then free for
//                          the copy of the tile two ahead;
//                       4. reduce: thread i sums the products of the kItems
//                          nonzeros [kItems * i, kItems * (i + 1)), closing a
//                          row at each mark, and a block-wide segmented scan
//                          joins the threads' open sums.  Every row that ends
//                          in the tile is written once,
//                          y[r] = alpha * sum + beta * y_in[r], with coalesced
//                          stores.
//                       A tile's rows and nonzeros together are at most
//                       tile_items, so no thread takes more than kItems
//                       nonzeros and kItems rows, however skewed the rows.
//   the fix-up          adds alpha * (sum of the carries of one row) into y,
//                       by one block: the G pairs loaded coalesced in chunks
//                       of blockDim.x and summed by a block-wide segmented
//                       scan in an order fixed by the pair indices
//                       (fix_up_pairs): no floating-point atomics, so two
//                       calls on the same input give the same bits, and a
//                       row with carries from many runs (a hub row) costs a
//                       few L2 round trips, not one per run.  The fused
//                       instantiation of
//                       merge_tile_kernel (kFused) runs it as its tail: each
//                       block, once its run's rows and carry pair are
//                       written, takes a ticket from a counter with an
//                       acquire-release increment that wraps it to 0 at the
//                       last ticket; the block that takes the last ticket runs
//                       the fix-up over all G pairs.  No block waits on
//                       another, so G may exceed one resident wave.  This
//                       is op(x)'s one launch.
//                       carry_fixup_kernel runs the same fix-up as a launch
//                       of its own, after the unfused instantiation.
//
// What bounds it.  Per nonzero a value and a column index stream once and
// x[col] is gathered through the read-only cache; per row one row end is
// read and one y written (plan.bytes_accessed()).  The arithmetic is 2 flops
// per nonzero, far below the card's rate.
//   Local columns (a stencil: a warp's 32 gathers touch 8 of x's 32-byte
//   sectors on grid3d100): HBM bytes.  The copies read the streams once,
//   whole, marked to leave L2 first so that x stays there; no byte outside
//   the arrays is copied whatever their alignment.  The host launches at
//   most one resident wave of blocks (ops/plan.py::tile_geometry), so no
//   partial last wave idles the card.  A block walks its run one tile after
//   another, so the kernel reaches HBM's rate only while a tile's steps take
//   less time than its bytes: hence the pipeline, a reduce with no search
//   and no branch per item, and no global load waited on inside a tile.
//   Scattered columns (the circuit5M and kron classes: 31 and 26 sectors per
//   warp request): the gather.  Each gather that misses L1 moves a 32-byte
//   L2 sector for its 4 bytes, and scattered sectors come from L2 at about
//   4.4-4.8 TB/s (tools/gather_rate.py), so the gather bound (those
//   sectors at that rate, plus the streams at HBM's) is 3.2-3.5x the bytes
//   bound, and only L1 hits go below it.  Four blocks per SM leave 28 KB of
//   L1: the kernel took 1.2-1.3x its gather bound, 1.5-1.7x cuSPARSE's
//   time.  The kL1 policy (below) gives each SM 192 KB of L1 and puts the
//   blocks of one SM on neighbouring runs, so that they gather from one
//   window of x (circuit) and keep the hot columns (kron) in L1.
//   With only 8 warps per SM the one-tile gather lead then matters (issued
//   right before use it was 10-16% slower; PERF.md).
//
// Plain C interface (loaded with ctypes): every pointer and the stream are
// void*, every entry returns a CUDA error code (a launch returns
// cudaGetLastError() right after it).  Kernels allocate nothing and launch on
// the caller's stream.  The fused kernel takes its ticket counter from the
// caller (an operator allocates one at build, zeroed), or, given none, uses
// this module's one per device; each launch leaves it at 0.  Launches that
// share a counter must be stream-ordered: two running at once would share
// its tickets.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kItems = 8;           // nonzeros per thread (ops/plan.py)
constexpr int kStages = 2;          // shared-memory stages (ops/plan.py)
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSharedBytes = 232448;   // a block's most on sm_90 (227 KB)
constexpr int kSmSharedBytes = 233472;    // an SM's most (228 KB)
constexpr int kBlockReserved = 1024;      // kept per resident block
constexpr int kDefaultTileItems = 2048;   // ops/plan.py::DEFAULT_TILE_ITEMS
constexpr int kFixupThreads = 256;        // carry_fixup_kernel's one block

// Gather policies (ops/plan.py::POLICIES), one instantiation each, so that
// each keeps its own shared-memory carveout:
//   kStream  as many blocks per SM as shared memory holds: the CUDA driver's
//            carveout gives all 228 KB to shared memory at the default
//            tile (four blocks), leaving about 28 KB of L1 for x;
//   kL1      merge_csrmv_init() sets the carveout to the smallest that
//            holds one block of the default tile (64 KB in float32), and
//            the rest of the SM's 256 KB, 192 KB, is L1 for x; the host
//            launches the blocks that fit it (two of the 1024-item tile
//            the "l1" plan takes), on neighbouring runs, so that an SM
//            gathers from one window of x (the circuit class) and keeps
//            the card's hot columns (the kron class) in L1.
enum Policy { kStream = 0, kL1 = 1 };

// The tile kernel's dynamic shared memory, in this order, every part a
// multiple of 16 bytes (ops/plan.py::tile_shared_bytes repeats the total):
//   kStages mbarriers                          16
//   kStages stage headers                      kStages * 32
//   per-warp scan totals, values then flags    kMaxWarps * (sizeof(V) + 4)
//   one partial per tile row                   tile_items * sizeof(V)
//   the products, a pad after every kItems     tile_items * 9 / 8 * sizeof(V)
//   a row mark per nonzero                     tile_items * 2
//   kStages stages                             kStages * stage_bytes
// A stage holds a tile's values and column indices (per nonzero) and its row
// ends (per row), each in a region that starts on a 16-byte boundary.
// Rows + nonzeros <= tile_items, and each region adds at most 28 bytes of
// rounding, hence the 96.
template <typename V>
__host__ __device__ constexpr size_t stage_bytes(int tile_items) {
  return static_cast<size_t>(tile_items) * (sizeof(V) + 4) + 96;
}

template <typename V>
__host__ __device__ constexpr size_t tile_shared_bytes(int tile_items) {
  return 16 + kStages * 32 + kMaxWarps * (sizeof(V) + 4) +
         static_cast<size_t>(tile_items) * sizeof(V) +
         static_cast<size_t>(tile_items) / kItems * (kItems + 1) * sizeof(V) +
         static_cast<size_t>(tile_items) * 2 +
         kStages * stage_bytes<V>(tile_items);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The region of a stage that holds one array's part of a tile: it starts at
// the 16-byte boundary at or below the part's first element, so element j
// lies at byte head + j * size.  Elements [lo, hi) arrive by one bulk copy
// of whole 16-byte units; the others, at most 7 at the two edges, by one
// element-sized cp.async each.
struct Window {
  int head;
  int lo, hi;
  int bytes;   // the region's size, a multiple of 16
};

__device__ __forceinline__ Window make_window(const void* first, int count,
                                              int size) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(first);
  const uintptr_t b = a + static_cast<uintptr_t>(count) * size;
  const uintptr_t a0 = a & ~uintptr_t(15);
  const uintptr_t m0 = (a + 15) & ~uintptr_t(15);
  const uintptr_t m1 = b & ~uintptr_t(15);
  Window w;
  w.head = static_cast<int>(a - a0);
  w.lo = w.hi = count;
  if (m0 < m1) {
    w.lo = static_cast<int>((m0 - a) / size);
    w.hi = static_cast<int>((m1 - a) / size);
  }
  w.bytes = static_cast<int>((b - a0 + 15) & ~uintptr_t(15));
  return w;
}

// What the compute needs of a staged tile, written beside the stage.  The
// last three are the byte offsets of element 0 of each region.
struct alignas(16) Header {
  int row0, nnz0, rows, nnz;
  int val, col, row_end;
};

// Three warps fill a stage with the tile of rows [r0, r1) and nonzeros
// [n0, n1); warp a % nwarps takes region a (values, column indices, row
// ends).  Its lane 0 arms the mbarrier with the bytes of the region's bulk
// copy and issues it, marked to leave L2 first (the streams are read once;
// x, gathered again and again, should stay); its lane e < 8 copies the
// region's e-th edge element and then arrives on the mbarrier once that copy
// has landed (cp.async.mbarrier.arrive.noinc).  So the barrier expects
// kArrivals arrivals per phase and completes when all bytes are in.  Warp
// 0's lane 0 also writes the header.
constexpr int kRegions = 3;
constexpr int kArrivals = kRegions * 9;

template <typename V>
__device__ void stage_tile(const V* values, const int* cols,
                           const int* row_end, int r0, int r1, int n0,
                           int n1, int tile_len, unsigned char* stage,
                           Header* hdr, uint64_t* bar, uint64_t policy,
                           int warp, int nwarps, int lane) {
  // Coordinates searched at this tile size give rows + nnz <= tile_len; the
  // clamp keeps the stage in bounds whatever the caller passed.
  const int nnz = min(max(n1 - n0, 0), tile_len);
  const int rows = min(max(r1 - r0, 0), tile_len - nnz);
  const char* src[kRegions] = {reinterpret_cast<const char*>(values + n0),
                               reinterpret_cast<const char*>(cols + n0),
                               reinterpret_cast<const char*>(row_end + r0)};
  const int size[kRegions] = {static_cast<int>(sizeof(V)), 4, 4};
  const int count[kRegions] = {nnz, nnz, rows};
  const uint32_t b = smem_u32(bar);
  int at[kRegions];   // byte offset of each region's element 0 in the stage
  int off = 0;
#pragma unroll
  for (int a = 0; a < kRegions; ++a) {
    const Window w = make_window(src[a], count[a], size[a]);
    at[a] = off + w.head;
    if (a % nwarps == warp) {
      if (lane == 0) {
        const int bytes = (w.hi - w.lo) * size[a];
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(b), "r"(bytes) : "memory");
        if (bytes > 0)   // a tile may hold no unit of an array
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
              "::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"
              :: "r"(smem_u32(stage + at[a] + w.lo * size[a])),
                 "l"(src[a] + w.lo * size[a]), "r"(bytes), "r"(b),
                 "l"(policy)
              : "memory");
      }
      if (lane < 8) {
        if (lane < w.lo + (count[a] - w.hi)) {
          const int j = lane < w.lo ? lane : w.hi + (lane - w.lo);
          const uint32_t dst = smem_u32(stage + at[a] + j * size[a]);
          if (size[a] == 8)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                         :: "r"(dst), "l"(src[a] + j * 8) : "memory");
          else
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                         :: "r"(dst), "l"(src[a] + j * 4) : "memory");
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];"
                     :: "r"(b) : "memory");
      }
    }
    off += w.bytes;
  }
  if (warp == 0 && lane == 0)
    *hdr = {r0, n0, rows, nnz, at[0], at[1], at[2]};
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

// The segmented-scan operator on (flag, value) pairs, a before b: the sum
// restarts after a row end (flag).  Associative; every sum is taken in the
// order of the nonzeros.
template <typename V>
__device__ __forceinline__ void combine(int af, V av, int& bf, V& bv) {
  bv = bf ? bv : av + bv;
  bf |= af;
}

// Thread i's gathers of the staged tile: x[cols[j]] for nonzeros
// j = i + u * B, 0 past the tile's.  Nothing here waits for them: they are
// first used in prepare(), a tile's reduce later.
template <typename V>
__device__ __forceinline__ void gather(const unsigned char* stage,
                                       const Header& h, const V* x,
                                       V (&xv)[kItems]) {
  const int* s_col = reinterpret_cast<const int*>(stage + h.col);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int j = threadIdx.x + u * blockDim.x;
    xv[u] = j < h.nnz ? __ldg(x + s_col[j]) : V(0);
  }
}

// Prepare a staged tile for its reduce: the products values[j] * x[cols[j]]
// (0 past the tile's nonzeros) go to s_prod, a pad after every kItems, so
// that the reduce reads them without bank conflicts; each row that ends in
// the tile marks its last nonzero; a row with none here sums to 0 in this
// tile, except row 0, whose sum so far is the carry.  Returns the header;
// after this the stage is no longer read.
template <typename V>
__device__ __forceinline__ Header prepare(const unsigned char* stage,
                                          const Header* hdr,
                                          const V (&xv)[kItems], V carry,
                                          V* s_prod, V* s_partial,
                                          short* s_mark, bool& carry_to_run) {
  const Header h = *hdr;
  const V* s_val = reinterpret_cast<const V*>(stage + h.val);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int j = threadIdx.x + u * blockDim.x;
    s_prod[j + j / kItems] = j < h.nnz ? s_val[j] * xv[u] : V(0);
  }
  const int* s_row_end = reinterpret_cast<const int*>(stage + h.row_end);
  for (int i = threadIdx.x; i < h.rows; i += blockDim.x) {
    const int e = min(s_row_end[i] - h.nnz0, h.nnz);
    const int b = i ? max(s_row_end[i - 1] - h.nnz0, 0) : 0;
    if (e > b)
      s_mark[e - 1] = static_cast<short>(i);
    else
      s_partial[i] = i ? V(0) : carry;
  }
  // the carry enters the first nonzero's row when that is row 0 (row 0 has
  // a nonzero here) or no row ends here
  carry_to_run = h.rows == 0 || s_row_end[0] > h.nnz0;
  return h;
}

// One carry pair as the fix-up holds it: its row, its neighbours' rows and
// its value (past the last pair: row -1, value 0).
template <typename V>
struct Pair {
  int row, before, after;
  V val;
};

// Pair t.  In the fused kernel the pairs were written by other blocks of
// the same launch, so every load goes through L2 (__ldcg); the read-only
// path (__ldg) is not coherent within a launch.  The four loads do not
// depend on each other and are issued together.
template <typename V>
__device__ __forceinline__ Pair<V> load_pair(const int* carry_row,
                                             const V* carry_val, int t,
                                             int num_pairs) {
  Pair<V> p = {-1, -1, -1, V(0)};
  if (t < num_pairs) {
    p.row = __ldcg(carry_row + t);
    p.before = t > 0 ? __ldcg(carry_row + t - 1) : -1;
    p.after = t + 1 < num_pairs ? __ldcg(carry_row + t + 1) : -1;
    p.val = __ldcg(carry_val + t);
  }
  return p;
}

// The fix-up, run by one whole block: y[r] += alpha * (the carries of row
// r), for every row r < num_rows that has carries (rows at or past
// num_rows are the last run's sentinel).  The pairs are taken in chunks of
// blockDim.x, one a thread, loaded coalesced, the next chunk's loads issued
// before this chunk is summed.  The sums are a segmented scan with the
// tile's operator (combine), a change of row starting a segment, in an
// order fixed by the pair indices alone: within each group of 32 pairs (a
// warp), the warp's shuffle scan; across groups, a fold from the first
// group to the last, carried from chunk to chunk.  So every block size (a
// multiple of 32) gives the same bits, and two calls give the same bits;
// no floating-point atomics.  The thread that holds a row's last pair
// writes y[r] = y[r] + alpha * sum, with y[r] loaded (through L2: other
// blocks wrote it) before the scan.  s_val / s_flag: 2 * kMaxWarps slots
// each, the groups' totals, double-buffered by chunk.
template <typename V>
__device__ void fix_up_pairs(const int* carry_row, const V* carry_val,
                             int num_pairs, int num_rows, V alpha, V* y,
                             V* s_val, int* s_flag) {
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  int open_f = 0;   // the fold of every group before this chunk
  V open = V(0);
  Pair<V> p = load_pair(carry_row, carry_val, tid, num_pairs);
  for (int base = 0, c = 0; base < num_pairs; base += blockDim.x, ++c) {
    const bool ends = p.row >= 0 && p.row < num_rows && p.after != p.row;
    const V y_old = ends ? __ldcg(y + p.row) : V(0);
    const Pair<V> next = load_pair(carry_row, carry_val,
                                   base + blockDim.x + tid, num_pairs);
    int f = p.before != p.row;
    V v = p.val;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int f2 = __shfl_up_sync(full, f, d);
      const V v2 = __shfl_up_sync(full, v, d);
      if (lane >= d) combine(f2, v2, f, v);
    }
    int* flags = s_flag + (c & 1) * kMaxWarps;
    V* vals = s_val + (c & 1) * kMaxWarps;
    if (lane == 31) {
      flags[warp] = f;
      vals[warp] = v;
    }
    __syncthreads();
    // the groups folded in order; at its own, a thread takes the fold of
    // the groups before it (unrolled: the totals' loads issue together)
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {
      if (w < nwarps) {
        if (w == warp) combine(open_f, open, f, v);
        int gf = flags[w];
        V gv = vals[w];
        combine(open_f, open, gf, gv);
        open_f = gf;
        open = gv;
      }
    }
    if (ends) y[p.row] = y_old + alpha * v;
    p = next;
  }
}

// The fused kernel's ticket counter for launches given none.
__device__ unsigned int g_tickets = 0;

template <typename V, bool kFused, int kPolicy>
__global__ void __launch_bounds__(kMaxThreads) merge_tile_kernel(
    const V* __restrict__ values, const int* __restrict__ cols,
    const int* __restrict__ row_end, const V* __restrict__ x,
    const V* __restrict__ y_in, const int* __restrict__ tile_rows,
    const int* __restrict__ tile_nnz, V alpha, V beta,
    V* __restrict__ y, int* __restrict__ carry_row,
    V* __restrict__ carry_val, int num_rows, int num_tiles,
    int run_tiles, int sm_blocks, unsigned int* tickets) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_len = blockDim.x * kItems;
  const int nwarps = blockDim.x >> 5;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  Header* hdr = reinterpret_cast<Header*>(smem + 16);
  V* s_warp_val = reinterpret_cast<V*>(hdr + kStages);
  int* s_warp_flag = reinterpret_cast<int*>(s_warp_val + kMaxWarps);
  V* s_partial = reinterpret_cast<V*>(s_warp_flag + kMaxWarps);
  V* s_prod = s_partial + tile_len;
  short* s_mark = reinterpret_cast<short*>(s_prod + tile_len / kItems *
                                                        (kItems + 1));
  unsigned char* stages = reinterpret_cast<unsigned char*>(s_mark + tile_len);
  const size_t stage_len = stage_bytes<V>(tile_len);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool stager = warp < kRegions;
  // Block b walks run b, or, with sm_blocks = k > 1 (G a multiple of k),
  // run (b mod G/k) * k + b / (G/k): the card hands out one block per SM
  // in turn, so the k blocks that share an SM walk k neighbouring runs and
  // gather from one window of x.  Runs and pairs are the same either way.
  const int groups = static_cast<int>(gridDim.x) / sm_blocks;
  const int my_run = sm_blocks > 1
                         ? static_cast<int>(blockIdx.x) % groups * sm_blocks +
                               static_cast<int>(blockIdx.x) / groups
                         : static_cast<int>(blockIdx.x);
  const int first = my_run * run_tiles;
  const int end = min(num_tiles - first, run_tiles) + first;
  int4* my_marks = reinterpret_cast<int4*>(s_mark + tid * kItems);
  uint64_t policy = 0;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(bar + s)), "r"(kArrivals) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  *my_marks = make_int4(-1, -1, -1, -1);   // -1: no row ends at the nonzero
  __syncthreads();

  // Tile first + k lives in stage k & 1.  The first two are copied now;
  // every later one when the tile two before it has been prepared, which
  // frees its stage.  (rB, nB) and (rC, nC) are the coordinates that start
  // and end the next tile to copy, loaded a tile ahead of their use.
  const int r0 = __ldg(tile_rows + first), n0 = __ldg(tile_nnz + first);
  const int r1 = __ldg(tile_rows + first + 1);
  const int n1 = __ldg(tile_nnz + first + 1);
  int rB = 0, nB = 0, rC = 0, nC = 0;
  if (first + 1 < end) {
    rB = __ldg(tile_rows + first + 2);
    nB = __ldg(tile_nnz + first + 2);
  }
  if (first + 2 < end) {
    rC = __ldg(tile_rows + first + 3);
    nC = __ldg(tile_nnz + first + 3);
  }
  if (stager) {
    stage_tile(values, cols, row_end, r0, r1, n0, n1, tile_len, stages, hdr,
               bar, policy, warp, nwarps, lane);
    if (first + 1 < end)
      stage_tile(values, cols, row_end, r1, rB, n1, nB, tile_len,
                 stages + stage_len, hdr + 1, bar + 1, policy, warp, nwarps,
                 lane);
  }
  __syncthreads();   // the headers

  V carry = V(0);   // partial of tile-local row 0, opened by the tile before
  V xv[kItems];     // a tile's x gathers, issued a tile ahead of its reduce
  bool carry_to_run = true;
  wait_parity(bar, 0);
  gather(stages, hdr[0], x, xv);
  Header h = prepare(stages, hdr, xv, carry, s_prod, s_partial, s_mark,
                     carry_to_run);
  __syncthreads();
  if (stager && first + 2 < end)
    stage_tile(values, cols, row_end, rB, rC, nB, nC, tile_len, stages, hdr,
               bar, policy, warp, nwarps, lane);
  rB = rC;
  nB = nC;
  if (first + 3 < end) {
    rC = __ldg(tile_rows + first + 4);
    nC = __ldg(tile_nnz + first + 4);
  }

  for (int t = first, k = 0; t < end; ++t, ++k) {
    const bool more = t + 1 < end;
    // Issue the next tile's x gathers; their latency passes while this
    // tile is reduced.
    if (more) {
      wait_parity(bar + ((k + 1) & 1), ((k + 1) >> 1) & 1);
      gather(stages + ((k + 1) & 1) * stage_len, hdr[(k + 1) & 1], x, xv);
    }

    // Reduce the thread's nonzeros (past the tile's: product 0, no mark):
    // `run` is the sum since the last row end; the first row that ends here
    // may have begun in earlier threads or tiles, and is finished after the
    // scan.  Selects, not branches: every lane takes the same path.
    const int4 mk = *my_marks;
    const int mw[4] = {mk.x, mk.y, mk.z, mk.w};
    V run = V(0);
    int first_row = -1;
    V first_sum = V(0);
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      run += s_prod[tid * (kItems + 1) + u];
      const int m = (u & 1) ? (mw[u >> 1] >> 16) : ((mw[u >> 1] << 16) >> 16);
      const bool first_end = m >= 0 && first_row < 0;
      if (m >= 0 && !first_end) s_partial[m] = run;
      first_sum = first_end ? run : first_sum;
      first_row = first_end ? m : first_row;
      run = m >= 0 ? V(0) : run;
    }

    // Block-wide exclusive segmented scan of the threads' (row ended, open
    // sum) pairs, entered by the carry when it belongs to the first
    // nonzero's row.
    const V init = carry_to_run ? carry : V(0);
    const unsigned full = 0xffffffffu;
    int f = first_row >= 0;
    V val = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int f2 = __shfl_up_sync(full, f, d);
      const V v2 = __shfl_up_sync(full, val, d);
      if (lane >= d) combine(f2, v2, f, val);
    }
    int ex_f = __shfl_up_sync(full, f, 1);
    V ex_val = __shfl_up_sync(full, val, 1);
    if (lane == 31) {
      s_warp_flag[warp] = f;
      s_warp_val[warp] = val;
    }
    __syncthreads();
    // The warps' totals, scanned across the lanes of every warp alike.
    int wf = 0;
    V wv = V(0);
    if (lane < nwarps) {
      wf = s_warp_flag[lane];
      wv = s_warp_val[lane];
    }
#pragma unroll
    for (int d = 1; d < kMaxWarps; d <<= 1) {
      const int f2 = __shfl_up_sync(full, wf, d);
      const V v2 = __shfl_up_sync(full, wv, d);
      if (lane >= d) combine(f2, v2, wf, wv);
    }
    int pf = __shfl_sync(full, wf, (warp + 31) & 31);   // warps before this
    V pv = __shfl_sync(full, wv, (warp + 31) & 31);
    int tf = __shfl_sync(full, wf, nwarps - 1);          // all warps
    V tv = __shfl_sync(full, wv, nwarps - 1);
    if (warp == 0) {
      pf = 0;
      pv = V(0);
    }
    combine(0, init, pf, pv);
    combine(0, init, tf, tv);
    if (lane > 0)
      combine(pf, pv, ex_f, ex_val);
    else
      ex_val = pv;
    if (first_row >= 0) s_partial[first_row] = ex_val + first_sum;
    carry = tv;   // the partial of the row open at the tile's end
    __syncthreads();

    for (int i = tid; i < h.rows; i += blockDim.x) {
      V out = alpha * s_partial[i];
      if (y_in != nullptr) out += beta * __ldg(y_in + h.row0 + i);
      y[h.row0 + i] = out;
    }
    if (!more && tid == 0) {
      carry_row[my_run] = h.row0 + h.rows;
      carry_val[my_run] = carry;
    }
    *my_marks = make_int4(-1, -1, -1, -1);
    if (!more) break;
    __syncthreads();   // this tile's products, marks and partials are read

    unsigned char* stage = stages + ((k + 1) & 1) * stage_len;
    h = prepare(stage, hdr + ((k + 1) & 1), xv, carry, s_prod, s_partial,
                s_mark, carry_to_run);
    // The stage's edge copies were written through the generic proxy; the
    // bulk copy that refills it after the barrier is in the async proxy.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (stager && t + 3 < end)
      stage_tile(values, cols, row_end, rB, rC, nB, nC, tile_len, stage,
                 hdr + ((k + 1) & 1), bar + ((k + 1) & 1), policy, warp,
                 nwarps, lane);
    rB = rC;
    nB = nC;
    if (t + 4 < end) {
      rC = __ldg(tile_rows + t + 5);
      nC = __ldg(tile_nnz + t + 5);
    }
  }

  if (kFused) {
    // Once the block's threads have written their y rows and thread 0 the
    // run's pair (the barrier orders them before thread 0's next step),
    // thread 0 takes a ticket with an acquire-release atomic at device
    // scope: it releases the block's writes, and the block that takes the
    // last ticket acquires every other block's, which the barrier after
    // passes on to its threads, and runs the fix-up.  This is the pattern
    // of cooperative groups' grid barrier, without the wait.  The
    // increment wraps: it stores 0 where it hands out ticket G - 1, so the
    // counter is 0 again for the next launch without a store of its own.
    // The warp totals are no longer read: s_warp_flag[0] carries "this
    // block took the last ticket" to the block's threads, and the tile's
    // partials, no longer read either, hold the fix-up's group totals.
    __syncthreads();
    if (tid == 0) {
      unsigned int* counter = tickets != nullptr ? tickets : &g_tickets;
      unsigned int ticket;
      asm volatile("atom.acq_rel.gpu.inc.u32 %0, [%1], %2;"
                   : "=r"(ticket) : "l"(counter), "r"(gridDim.x - 1)
                   : "memory");
      s_warp_flag[0] = ticket == gridDim.x - 1;
    }
    __syncthreads();
    if (s_warp_flag[0])
      fix_up_pairs(carry_row, carry_val, static_cast<int>(gridDim.x),
                   num_rows, alpha, y, s_partial,
                   reinterpret_cast<int*>(s_partial + 2 * kMaxWarps));
  }
}

// The fix-up as a launch of its own: one block, the fused tail's body, so
// its bits are the fused kernel's at the same runs.
template <typename V>
__global__ void carry_fixup_kernel(const int* __restrict__ carry_row,
                                   const V* __restrict__ carry_val,
                                   int num_pairs, int num_rows, V alpha,
                                   V* __restrict__ y) {
  __shared__ V s_val[2 * kMaxWarps];
  __shared__ int s_flag[2 * kMaxWarps];
  fix_up_pairs(carry_row, carry_val, num_pairs, num_rows, alpha, y, s_val,
               s_flag);
}

// The instantiation for (fused, policy); null for an unknown policy.
template <typename V, int kPolicy>
const void* tile_kernel(int fused) {
  return fused ? reinterpret_cast<const void*>(
                     merge_tile_kernel<V, true, kPolicy>)
               : reinterpret_cast<const void*>(
                     merge_tile_kernel<V, false, kPolicy>);
}

template <typename V>
const void* tile_kernel(int fused, int policy) {
  if (policy == kStream) return tile_kernel<V, kStream>(fused);
  if (policy == kL1) return tile_kernel<V, kL1>(fused);
  return nullptr;
}

template <typename V>
int launch_merge_tile(const void* values, const void* cols,
                      const void* row_end, const void* x, const void* y_in,
                      const void* tile_rows, const void* tile_nnz,
                      double alpha, double beta, void* y, void* carry_row,
                      void* carry_val, int num_rows, int num_tiles,
                      int run_tiles, int sm_blocks, int threads,
                      int shared_bytes, int fused, int policy,
                      void* tickets, void* stream) {
  const void* kernel = tile_kernel<V>(fused, policy);
  if (kernel == nullptr || num_tiles < 1 || run_tiles < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<size_t>(shared_bytes) !=
          tile_shared_bytes<V>(threads * kItems))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = num_tiles / run_tiles + (num_tiles % run_tiles != 0);
  if (sm_blocks < 1 || grid % sm_blocks != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernel's parameters, in its order and types
  const V* a_values = static_cast<const V*>(values);
  const int* a_cols = static_cast<const int*>(cols);
  const int* a_row_end = static_cast<const int*>(row_end);
  const V* a_x = static_cast<const V*>(x);
  const V* a_y_in = static_cast<const V*>(y_in);
  const int* a_tile_rows = static_cast<const int*>(tile_rows);
  const int* a_tile_nnz = static_cast<const int*>(tile_nnz);
  V a_alpha = static_cast<V>(alpha);
  V a_beta = static_cast<V>(beta);
  V* a_y = static_cast<V*>(y);
  int* a_carry_row = static_cast<int*>(carry_row);
  V* a_carry_val = static_cast<V*>(carry_val);
  unsigned int* a_tickets = static_cast<unsigned int*>(tickets);
  void* args[] = {&a_values, &a_cols, &a_row_end, &a_x, &a_y_in,
                  &a_tile_rows, &a_tile_nnz, &a_alpha, &a_beta, &a_y,
                  &a_carry_row, &a_carry_val, &num_rows, &num_tiles,
                  &run_tiles, &sm_blocks, &a_tickets};
  const cudaError_t e = cudaLaunchKernel(kernel, dim3(grid), dim3(threads),
                                         args, shared_bytes,
                                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename V>
int merge_tile_occupancy(int fused, int policy, int threads,
                         int shared_bytes, int* blocks_per_sm,
                         int* registers) {
  const void* kernel = tile_kernel<V>(fused, policy);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, threads, shared_bytes));
}

// The percentage of an SM's shared memory that one block of the default
// tile needs: kL1's carveout.  A larger tile makes the CUDA driver raise it
// at launch, as it may when a launch needs more than the preference.
template <typename V>
int l1_carveout() {
  const size_t need = tile_shared_bytes<V>(kDefaultTileItems) +
                      kBlockReserved;
  return static_cast<int>((need * 100 + kSmSharedBytes - 1) /
                          kSmSharedBytes);
}

// The opt-in above 48 KB of every instantiation of value type V, and the
// kL1 ones' carveout.
template <typename V>
cudaError_t init_tile_kernels() {
  cudaError_t e = cudaSuccess;
  for (int policy = kStream; policy <= kL1; ++policy)
    for (int fused = 0; fused < 2 && e == cudaSuccess; ++fused) {
      const void* kernel = tile_kernel<V>(fused, policy);
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSharedBytes);
      if (e == cudaSuccess && policy == kL1)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            l1_carveout<V>());
    }
  return e;
}

template <typename V>
int launch_carry_fixup(const void* carry_row, const void* carry_val,
                       int num_pairs, int num_rows, double alpha, void* y,
                       void* stream) {
  carry_fixup_kernel<V><<<1, kFixupThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(carry_row), static_cast<const V*>(carry_val),
      num_pairs, num_rows, static_cast<V>(alpha), static_cast<V*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Lets every instantiation of the tile kernel take more than the default
// 48 KB of dynamic shared memory on the current device, and sets the kL1
// ones' carveout.  Called once, before any launch, so that no launch (nor a
// CUDA graph that captures one) sets an attribute.
int merge_csrmv_init() {
  cudaError_t e = init_tile_kernels<float>();
  if (e == cudaSuccess) e = init_tile_kernels<double>();
  return static_cast<int>(e);
}

// fused != 0 launches the instantiation with the fix-up as its tail: y is
// then the finished result, carry_row / carry_val are its scratch, and
// tickets is its counter (one zeroed unsigned int; null: the module's).
// policy is a Policy; sm_blocks, the blocks resident per SM, lets the
// blocks of one SM walk neighbouring runs (1: block b walks run b; the
// grid must be a multiple of it).
#define MERGE_TILE_ENTRY(SFX, V)                                             \
  int merge_tile_##SFX(const void* values, const void* cols,                 \
                       const void* row_end, const void* x, const void* y_in, \
                       const void* tile_rows, const void* tile_nnz,          \
                       double alpha, double beta, void* y, void* carry_row,  \
                       void* carry_val, int num_rows, int num_tiles,         \
                       int run_tiles, int sm_blocks, int threads,            \
                       int shared_bytes, int fused, int policy,              \
                       void* tickets, void* stream) {                        \
    return launch_merge_tile<V>(values, cols, row_end, x, y_in, tile_rows,   \
                                tile_nnz, alpha, beta, y, carry_row,         \
                                carry_val, num_rows, num_tiles, run_tiles,   \
                                sm_blocks, threads, shared_bytes, fused,     \
                                policy, tickets, stream);                    \
  }                                                                          \
  int merge_tile_occupancy_##SFX(int fused, int policy, int threads,         \
                                 int shared_bytes, int* blocks_per_sm,       \
                                 int* registers) {                           \
    return merge_tile_occupancy<V>(fused, policy, threads, shared_bytes,     \
                                   blocks_per_sm, registers);                \
  }

MERGE_TILE_ENTRY(f32, float)
MERGE_TILE_ENTRY(f64, double)
#undef MERGE_TILE_ENTRY

int carry_fixup_f32(const void* carry_row, const void* carry_val,
                    int num_pairs, int num_rows, double alpha, void* y,
                    void* stream) {
  return launch_carry_fixup<float>(carry_row, carry_val, num_pairs, num_rows,
                                   alpha, y, stream);
}

int carry_fixup_f64(const void* carry_row, const void* carry_val,
                    int num_pairs, int num_rows, double alpha, void* y,
                    void* stream) {
  return launch_carry_fixup<double>(carry_row, carry_val, num_pairs,
                                    num_rows, alpha, y, stream);
}

const char* merge_csrmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
