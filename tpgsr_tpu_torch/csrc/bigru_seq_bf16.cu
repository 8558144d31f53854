// K1 in bf16, forward: the bidirectional GRU recurrence on Hopper's tensor cores (sm_90a).
//
// Replaces the bf16 path of tpgsr_tpu/ops/pallas_gru.py::_gru_seq_kernel
// (pallas_gru.py:34, launched by _bigru_pallas_impl at :95) at every hidden
// size K1 is built for, 8 to 128; the fp32 paths are csrc/bigru_seq.cu and,
// at 64 and 128, csrc/bigru_seq_wide.cu.  The input projection stays
// outside, one cuBLAS addmm (ops/rnn.py); this kernel runs the serial
// recurrence from h0 = 0:
//
//   hp = h W_hh^T + b_hh;  r = sig(xr + hr);  z = sig(xz + hz);
//   n = tanh(xn + r * hn);  h = (1 - z) n + z h
//
// Layout as csrc/bigru_seq.cu's: xp [N, T, 6H] and out [N, T, 2H] in bf16,
// w_t [2, H, 3H] (W_hh transposed per direction) and b_hh [2, 3H] in fp32
// holding bf16 values (the wrapper rounds them, ops/gru_seq.py).
//
// What bound the first bf16 kernel (csrc/bigru_seq.cu instantiated for bf16
// storage, 0.332 ms per SR forward at batch 48 on an H100 SXM at 700 W).  bf16
// halved only the bytes (0.075 ms per SR forward at 3.35 TB/s); each thread
// still formed its (row, unit)'s three dot products with 3H fp32 FMAs a step
// (0.090 ms of fp32 products per SR forward at 67 TFLOP/s), read h from a
// shared-memory double buffer and closed every step with a warp barrier.
//
// This design puts the recurrent products on the tensor cores and keeps h in
// registers.
//   1. A group of H/8 warps owns an m-tile of 16 rows of one direction (or 8,
//      below); warp q of the group owns hidden units 8q .. 8q + 7.  Each step
//      it forms its units' columns of hp [16, 3H] = h [16, H] . W_hh^T (three
//      8-column n-tiles, one a gate) with mma.sync.m16n8k16 (bf16 x bf16 ->
//      fp32) over ceil(H/16) k-blocks.  Its B fragments are loaded into
//      registers once, before the loop (6 ceil(H/16) registers).
//   2. The accumulator fragment of an n-tile gives lane l rows l/4 and
//      l/4 + 8 and columns 2 (l%4) + {0, 1}: r, z and n of the warp's units
//      lie at the same place in its three n-tiles, so a lane holds the three
//      pre-activations of its own (row, unit) pairs (4 at 16 rows), computes
//      their gates and keeps their h in fp32 registers.  The same layout is
//      the A fragment of the next step's product for those 8 columns: each
//      warp writes its fragments to shared memory (double-buffered by the
//      step's parity) and reads the group's others, one named barrier of the
//      group a step.  A single warp an m-tile (the first design of this
//      kernel) needed no exchange, but left each lane all of its rows'
//      units' gates: measured slower than the fp32-state kernel over W.
//   3. The arithmetic is the fp32 kernel's.  W_hh holds bf16 values, so each
//      product with a bf16 operand is exact in fp32.  The fp32 h is split
//      into three bf16 terms, h = h1 + h2 + h3 (8 + 8 + 8 significant bits,
//      fp32's 24; exact for |h| >= 2^-110, and within 2^-134 below), each
//      term's products into an fp32 accumulator of its own (the largest
//      starting at b_hh; three chains of dependent products a third as
//      long as one), the three added smallest first.  At 8 rows an m-tile
//      the product's rows l/4 + 8, empty, carry the second term beside the
//      first's rows l/4: two products a k-block and gate where 16 rows take
//      three.  Only the order of the sums differs from the
//      plain version (ops/rnn.py::bigru_recurrence), now with the tensor
//      core's own rounding of its fp32 sums.  Accurate tanhf; sigmoid through
//      tanhf.
//   4. xp arrives through a ring of S = 3 slots in shared memory, each warp
//      copying its own units' r, z and n slices (three 16-byte chunks a row)
//      by cp.async S - 1 steps ahead, one commit group a step (empty ones
//      where there is nothing to load, so ragged rows and T < S keep the
//      count); a warp barrier a step makes them visible.  A ring row is three
//      chunks, an odd number, so the lanes' 4-byte reads of their pairs hit
//      32 distinct banks.  out is stored as bf16 pairs after the group's
//      barrier: stored before it, the barrier waited on them.
//   5. Rows an m-tile, 8 or 16, from ops/gru_seq.py::tile_config.  Four warps
//      a block up to H = 32 (4 / (H/8) m-tiles), one m-tile of H/8 warps
//      above; a group past N returns.
//
// At H = 64 and 128 the same design replaces the fp32 wide kernel's bf16
// instantiation (csrc/bigru_seq_wide.cu: 1.701 ms per SR forward at
// --hd_u 64, batch 48, H100 SXM at 700 W).  That kernel formed 3H fp32 FMAs
// a (row, unit) and step, read every weight from shared memory at each step
// for at most four rows, and closed each step with a barrier of 256 or 512
// threads.  Here the m-tile's group is 8 or 16 warps, still one named
// barrier a step; each warp keeps its 24 (H = 64) or 48 (H = 128) B
// fragments in registers for the sweep, each serving 16 rows a product; the
// block asks for shared memory beyond 48 KB where it needs it (H = 128 at
// 16 rows, 61,440 B).
//
// What bounds it now.  Each sweep at batch 48 reads xp (18.9 MB) and writes
// out (6.3 MB): 7.5 us at 3.35 TB/s, 0.075 ms per SR forward; its products
// with the split, 1.8 GFLOP (3 terms), take 1.8 us at 989 TFLOP/s.  The bytes
// bind; the chain of T dependent steps, each the products' latency, a lane's
// gates (three tanhf a pair) and the group's barrier, is what a warp waits on.
// At H = 128 the products bind (over W, 29 GFLOP with the three terms, 29 us
// at 989 TFLOP/s): 16 warps an SM, each with 72 mma.sync a step, run at
// about mma.sync's rate (ablate_k1.py --bf16 --hidden 128: the products
// are 0.106 of the sweep's 0.192 ms), and the 96 m-tiles of 16 rows over W
// leave 36 of 132 SMs idle (8-row m-tiles, two waves, measured slower).
//
// -Xptxas -v on sm_90a (registers; no spills, no stack frame; dynamic shared
// memory a block at 16 / 8 rows: 15,360 / 7,680 B up to H = 32, 30,720 /
// 15,360 B at 64, 61,440 / 30,720 B at 128): H = 128: 16 rows 128, 8 rows
// 128; H = 64: 123, 85; H = 32: 96, 74; H = 16: 68, 63; H = 8: 72, 61.
//
// Measured (tpgsr_tpu_torch/bench_k1.py --bf16 and ablate_k1.py --bf16,
// H100 SXM at 700 W): alone 35.2 us over W (8 rows; 16 rows 39.5) and
// 21.8 us over H (16 rows; 8 rows 25.2) at batch 48, 0.285 ms per SR
// forward against 0.332 for the fp32-state kernel's bf16 instantiation in
// the same call, 3.8x the byte bound; 0.184 / 0.185 ms a sweep at batch 512
// against 0.295 / 0.294.  Over W, taking out the products saves 8.4 us,
// accurate tanhf (fast approximations instead) 8.9 us, the out store 1.4
// us: the chain of 64 steps of ~1,080 cycles, not the bytes, binds.  At
// H = 64 (16 rows): 79.1 / 55.9 us over W / H, 0.675 ms per SR forward
// (products 28.1 us over W, accurate tanhf 13.2, the out store 3.0); at
// H = 128: 191.9 / 156.3 us, where 8-row m-tiles take 220.7 / 187.4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kStages = 3;  // slots of the xp ring

// As in csrc/bigru_seq.cu: sigmoid(x) = tanh(x / 2) / 2 + 1 / 2.
__device__ __forceinline__ float sigmoid_f32(float x) { return fmaf(0.5f, tanhf(0.5f * x), 0.5f); }

// A bf16 pair as the 32 bits mma.sync takes (the lower column in the low half), and back.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}
__device__ __forceinline__ float low_f32(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float high_f32(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// (x, y) as three bf16 pairs, the largest first: x = lo(p[0]) + lo(p[1]) +
// lo(p[2]) and y likewise (design 3; ops/rnn.py::bf16_split3 is its plain version).
__device__ __forceinline__ void split3(float x, float y, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pack(x, y);
    x -= low_f32(p[i]);
    y -= high_f32(p[i]);
  }
}

// d += a b on the tensor cores: a [16, 16] (row-major fragment), b [16, 8]
// (column-major fragment), bf16 in, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int H, int MR>
struct Shape {
  static_assert(H % 8 == 0 && (32 % H == 0 || H % 32 == 0) && (MR == 8 || MR == 16),
                "H a multiple of 8 dividing 32 or a multiple of 32, 8 or 16 rows an m-tile");
  static constexpr int kQ = H / 8;                // 8-unit tiles of h: warps an m-tile, one tile each
  static constexpr int kWarps = kQ > 4 ? kQ : 4;  // warps a block: 4 / kQ m-tiles, or one m-tile of kQ warps
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGroups = kWarps / kQ;     // m-tiles a block
  static constexpr int kBlocksK = (H + 15) / 16;  // k-blocks of 16 over h (H = 8: the upper half zero)
  static constexpr int kHalves = MR / 8;          // rows a lane holds: l/4, and l/4 + 8 at 16 rows
  static constexpr int kProducts = kHalves == 2 ? 3 : 2;  // products a k-block and gate (design 3)
  static constexpr int kStride = 24;              // a ring row: the warp's 8 units of r, z, n
  static constexpr int kSlot = MR * kStride;      // bf16 a slot
  static constexpr int kCopies = (3 * MR + 31) / 32;  // 16-byte copies a lane a step
  static constexpr int kTerms = 3 * kHalves * kQ * 32;  // words of one buffer of h's terms, [3][kHalves][kQ][32]
};

template <int H, int MR>
constexpr size_t smem_bytes() {
  using Sh = Shape<H, MR>;
  return sizeof(uint32_t) * Sh::kGroups * 2 * Sh::kTerms +
         sizeof(__nv_bfloat16) * Sh::kWarps * kStages * Sh::kSlot;
}

template <int H, int MR>
__global__ void __launch_bounds__(Shape<H, MR>::kThreads)
    bigru_seq_bf16_kernel(const __nv_bfloat16* __restrict__ xp, const float* __restrict__ w_t,
                          const float* __restrict__ b_hh, __nv_bfloat16* __restrict__ out, int n, int t_len) {
  using Sh = Shape<H, MR>;
  constexpr int S = kStages;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;              // the fragments' row and column pair
  const int group = warp / Sh::kQ, q0 = warp % Sh::kQ;  // the warp's m-tile in the block, its unit tile
  const int dir = blockIdx.y;
  const int row0 = (blockIdx.x * Sh::kGroups + group) * MR;  // the m-tile: rows row0 .. row0 + MR - 1
  if (row0 >= n) return;  // the whole group: its barrier spans it alone

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* terms = smem + group * 2 * Sh::kTerms;  // the group's [2][3][kHalves][kQ][32]
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + Sh::kGroups * 2 * Sh::kTerms) + warp * S * Sh::kSlot;
  auto term_at = [&](int buf, int term, int hv, int q) -> uint32_t& {
    return terms[(((buf * 3 + term) * Sh::kHalves + hv) * Sh::kQ + q) * 32 + lane];
  };
  auto sync_group = [&] { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * Sh::kQ) : "memory"); };

  // Design 1: B fragments of W_hh^T, B[k][c] = w_t[dir][k][c], for k-block kb
  // and the n-tile of gate `gate`: lane (g, tig) holds rows
  // k = 16 kb + 8 half + 2 tig + {0, 1} of column c = gate H + 8 q0 + g.
  uint32_t wb[Sh::kBlocksK][3][2];
  const float* w = w_t + static_cast<size_t>(dir) * H * 3 * H;
#pragma unroll
  for (int kb = 0; kb < Sh::kBlocksK; ++kb)
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = 16 * kb + 8 * half + 2 * tig, c = gate * H + 8 * q0 + g;
        wb[kb][gate][half] = k < H ? pack(w[k * 3 * H + c], w[(k + 1) * 3 * H + c]) : 0u;
      }
  // b_hh at the accumulator's columns gate H + 8 q0 + 2 tig + {0, 1}
  float bias[3][2];
  const float* b = b_hh + dir * 3 * H + 8 * q0 + 2 * tig;
#pragma unroll
  for (int gate = 0; gate < 3; ++gate) {
    bias[gate][0] = b[gate * H];
    bias[gate][1] = b[gate * H + 1];
  }

  // 32-bit element offsets (the wrapper checks that they fit).
  const int x_row = t_len * 6 * H, o_row = t_len * 2 * H;
  auto time_of = [&](int t) { return dir ? t_len - 1 - t : t; };

  // Design 4: copy i = 32 p + lane of a step moves gate i % 3 of row i / 3;
  // rows past n are zero-filled from a valid address.
  auto stage = [&](int t) {
    const int step = time_of(t) * 6 * H + dir * 3 * H + 8 * q0;
    __nv_bfloat16* slot = ring + (t % S) * Sh::kSlot;
#pragma unroll
    for (int p = 0; p < Sh::kCopies; ++p) {
      const int i = 32 * p + lane;
      const int r = i / 3, gate = i % 3;
      if (i < 3 * MR) {
        const bool ok = row0 + r < n;
        cp_async16(slot + r * Sh::kStride + 8 * gate, ok ? xp + (row0 + r) * x_row + step + gate * H : xp, ok);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < t_len) stage(t);
    cp_async_commit();
  }

  // Design 2: the lane's state, rows g + 8 hv and units 8 q0 + 2 tig + e;
  // buffer 0 holds h0 = 0.
  float h[Sh::kHalves][2];
#pragma unroll
  for (int hv = 0; hv < Sh::kHalves; ++hv) {
    h[hv][0] = h[hv][1] = 0.f;
#pragma unroll
    for (int term = 0; term < 3; ++term) term_at(0, term, hv, q0) = 0u;
  }
  sync_group();

#pragma unroll 1
  for (int t = 0; t < t_len; ++t) {
    // Step t's group is complete once at most S - 2 newer ones are pending;
    // the barrier makes every lane's copies visible and closes step t - 1,
    // whose slot the next copy reuses.
    cp_async_wait<S - 2>();
    __syncwarp();
    if (t + S - 1 < t_len) stage(t + S - 1);
    cp_async_commit();

    // Design 3: h's three bf16 terms from the group's buffer t % 2, each
    // term's products summed by an accumulator of its own (the largest
    // starting at b_hh), the three added smallest first.  At 8 rows an
    // m-tile the empty rows l/4 + 8 of the first product carry the second
    // term: two products a k-block and gate, not three.
    float acc[Sh::kProducts][3][4];  // [product][gate][fragment]
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      acc[0][gate][0] = bias[gate][0];
      acc[0][gate][1] = bias[gate][1];
      acc[0][gate][2] = Sh::kHalves == 2 ? bias[gate][0] : 0.f;
      acc[0][gate][3] = Sh::kHalves == 2 ? bias[gate][1] : 0.f;
#pragma unroll
      for (int p = 1; p < Sh::kProducts; ++p) acc[p][gate][0] = acc[p][gate][1] = acc[p][gate][2] = acc[p][gate][3] = 0.f;
    }
    auto frag = [&](int term, int q) {  // rows l/4 + 8 hv of term `term` at k-tile q, zero past H
      return q < Sh::kQ ? term_at(t & 1, term % 3, term / 3, q < Sh::kQ ? q : 0) : 0u;
    };
    // A's rows l/4 (upper 0) and l/4 + 8 (upper 1) of product p: at 16 rows
    // term p of both row halves; at 8 rows terms 1 | 2, then 3 | zeros.
    auto a_rows = [&](int p, int upper, int q) -> uint32_t {
      if constexpr (Sh::kHalves == 2) return frag(p + 3 * upper, q);
      return p == 0 ? frag(upper, q) : (upper ? 0u : frag(2, q));
    };
#pragma unroll
    for (int kb = 0; kb < Sh::kBlocksK; ++kb)
#pragma unroll
      for (int p = 0; p < Sh::kProducts; ++p) {
        const uint32_t a0 = a_rows(p, 0, 2 * kb), a1 = a_rows(p, 1, 2 * kb), a2 = a_rows(p, 0, 2 * kb + 1),
                       a3 = a_rows(p, 1, 2 * kb + 1);
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          mma_bf16(acc[p][gate], a0, a1, a2, a3, wb[kb][gate][0], wb[kb][gate][1]);
      }
    // hp at the lane's row g + 8 hv and unit 8 q0 + 2 tig + e: (b_hh + term 1) + (term 2 + term 3)
    auto hp = [&](int gate, int hv, int e) {
      if constexpr (Sh::kHalves == 2) {
        const int c = 2 * hv + e;
        return acc[0][gate][c] + (acc[1][gate][c] + acc[2][gate][c]);
      }
      return acc[0][gate][e] + (acc[0][gate][2 + e] + acc[1][gate][e]);
    };

    const __nv_bfloat16* xs = ring + (t % S) * Sh::kSlot;
#pragma unroll
    for (int hv = 0; hv < Sh::kHalves; ++hv) {
      const int r = g + 8 * hv;
      const __nv_bfloat16* x = xs + r * Sh::kStride + 2 * tig;
      const uint32_t xg[3] = {*reinterpret_cast<const uint32_t*>(x), *reinterpret_cast<const uint32_t*>(x + 8),
                              *reinterpret_cast<const uint32_t*>(x + 16)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        auto xv = [&](int gate) { return e ? high_f32(xg[gate]) : low_f32(xg[gate]); };
        const float rg = sigmoid_f32(xv(0) + hp(0, hv, e));
        const float zg = sigmoid_f32(xv(1) + hp(1, hv, e));
        const float ng = tanhf(xv(2) + rg * hp(2, hv, e));
        h[hv][e] = (1.0f - zg) * ng + zg * h[hv][e];
      }
      uint32_t p[3];
      split3(h[hv][0], h[hv][1], p);
#pragma unroll
      for (int term = 0; term < 3; ++term) term_at((t + 1) & 1, term, hv, q0) = p[term];
    }
    sync_group();  // buffer (t + 1) % 2 complete; buffer t % 2 free for step t + 1 to write

    // out after the barrier, which would otherwise wait on the stores: the
    // next barrier is a step away.
    const int o_step = time_of(t) * 2 * H + dir * H + 8 * q0 + 2 * tig;
#pragma unroll
    for (int hv = 0; hv < Sh::kHalves; ++hv) {
      const int r = g + 8 * hv;
      if (row0 + r < n) *reinterpret_cast<uint32_t*>(out + (row0 + r) * o_row + o_step) = pack(h[hv][0], h[hv][1]);
    }
  }
  cp_async_wait<0>();
}

// Shared memory beyond the 48 KB a launch gets without opting in (H = 128
// at 16 rows an m-tile) is asked for before the launch and the occupancy query.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return bytes <= 48 * 1024 ? cudaSuccess
                            : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(bytes));
}

// Ops run by dispatch() on the instantiation of (hidden, rows an m-tile).
struct Forward {
  const __nv_bfloat16* xp;
  const float *w_t, *b_hh;
  __nv_bfloat16* out;
  int n, t_len;
  cudaStream_t stream;

  template <int H, int MR>
  int run() const {
    using Sh = Shape<H, MR>;
    constexpr size_t bytes = smem_bytes<H, MR>();
    static_assert(bytes <= 227 * 1024, "beyond a block's shared memory");
    const auto kernel = bigru_seq_bf16_kernel<H, MR>;
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (n + MR - 1) / MR;
    const dim3 grid((tiles + Sh::kGroups - 1) / Sh::kGroups, 2);
    kernel<<<grid, Sh::kThreads, bytes, stream>>>(xp, w_t, b_hh, out, n, t_len);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Occupancy {
  int* blocks;

  template <int H, int MR>
  int run() const {
    const auto kernel = bigru_seq_bf16_kernel<H, MR>;
    const cudaError_t err = allow_smem(kernel, smem_bytes<H, MR>());
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, Shape<H, MR>::kThreads,
                                                                          smem_bytes<H, MR>()));
  }
};

template <int H, class Op>
int by_rows(const Op& op, int rows) {
  switch (rows) {
    case 8:
      return op.template run<H, 8>();
    case 16:
      return op.template run<H, 16>();
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Op>
int dispatch(const Op& op, int hidden, int rows) {
  switch (hidden) {
    case 8:
      return by_rows<8>(op, rows);
    case 16:
      return by_rows<16>(op, rows);
    case 32:
      return by_rows<32>(op, rows);
    case 64:
      return by_rows<64>(op, rows);
    case 128:
      return by_rows<128>(op, rows);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both return a cudaError_t as int: 0 on success.  xp and out are
// __nv_bfloat16; w_t and b_hh are float holding bf16 values; rows is 8 or 16.
extern "C" int tpgsr_bigru_seq_bf16_forward(const void* xp, const float* w_t, const float* b_hh, void* out, int n,
                                            int t_len, int hidden, int rows, void* stream) {
  if (n <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Forward op{static_cast<const __nv_bfloat16*>(xp), w_t, b_hh, static_cast<__nv_bfloat16*>(out), n, t_len,
                   static_cast<cudaStream_t>(stream)};
  return dispatch(op, hidden, rows);
}

// Resident blocks an SM for the instantiation (hidden, rows), written to *blocks.
extern "C" int tpgsr_bigru_seq_bf16_occupancy(int hidden, int rows, int* blocks) {
  const Occupancy op{blocks};
  return dispatch(op, hidden, rows);
}
