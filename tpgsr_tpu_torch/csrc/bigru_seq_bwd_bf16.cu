// K1 in bf16, backward: BPTT of the bidirectional GRU recurrence on Hopper's tensor cores (sm_90a).
//
// The backward of the bf16 path of tpgsr_tpu/ops/pallas_gru.py::_gru_seq_kernel
// (pallas_gru.py:34; the JAX package differentiates its lax.scan instead).
// The forward is csrc/bigru_seq_bf16.cu, the fp32 backward csrc/bigru_seq_bwd.cu,
// the plain version ops/rnn.py::bigru_recurrence_backward.  Per row and
// direction, in reverse time, from dh = 0 after the last step:
//
//   hp = W_hh h_{t-1} + b_hh and the gates r, z, n, recomputed from h_{t-1}
//   dh = grad_out_t + dh_next;  dn = dh (1 - z);  dz = dh (h_{t-1} - n)
//   dn^ = dn (1 - n^2);  dr^ = dn^ hn r (1 - r);  dz^ = dz z (1 - z)
//   dxp_t = [dr^, dz^, dn^];  dhp_t = [dr^, dz^, dn^ r]
//   dh_next = dh z + W_hh^T dhp_t
//
// Layout as csrc/bigru_seq_bwd.cu's: xp [N, T, 6H], out and grad_out
// [N, T, 2H], dxp [N, T, 6H] in bf16; w_t [2, H, 3H] (W_hh transposed per
// direction) and b_hh [2, 3H] in fp32 holding bf16 values; dhp [2, Np, T, 3H]
// and h_{t-1} [2, Np, T, H] in fp32 for the rows below N, which feed the
// GEMM for dW_hh and db_hh outside (ops/gru_seq.py::recurrent_weight_grads).
//
// What bound the first bf16 backward (csrc/bigru_seq_bwd.cu instantiated for
// bf16 storage, 0.796 ms per SR backward at batch 48 on an H100 SXM at 700 W,
// 6 % slower than fp32 with half the bytes): each step each thread
// recomputed its unit's gates with 3H fp32 FMAs and formed W_hh^T dhp_t with
// 3H FMAs and a 31-shuffle reduce-scatter, at the 168-register cap.
//
// This design, as the forward's (csrc/bigru_seq_bf16.cu, design 1-5):
//   1. A group of H/8 warps owns an m-tile of 8 rows of one direction; warp
//      q owns hidden units 8q .. 8q + 7.  Both products of a step run on the
//      tensor cores with mma.sync.m16n8k16: the recompute, the warp's three
//      n-tiles of hp = h_{t-1} W_hh^T over ceil(H/16) k-blocks, and its
//      n-tile of dhp_t W_hh over ceil(3H/16) k-blocks.  Both sets of B
//      fragments sit in registers, loaded once (6 ceil(H/16) + 2 ceil(3H/16)
//      of them).
//   2. The accumulator layout is the A layout: h_{t-1}, read from out as
//      bf16 pairs, is the recompute's A fragment (every warp copies the
//      m-tile's whole h_{t-1} rows) and holds the lane's own h_{t-1} values;
//      the gates and dhp_t come out at the lane's own (row, unit) pairs, in
//      the A layout of the second product's k-blocks.  Each warp writes its
//      dhp_t fragments to shared memory (double-buffered by the step's
//      parity) and, after one named barrier of the group a step, reads the
//      group's others; dh_next comes out in h's layout and stays in fp32
//      registers.
//   3. The arithmetic is the fp32 kernel's: h_{t-1} is bf16 already (one
//      term, exact); dhp_t, fp32, is split into three bf16 terms.  The
//      m-tile fills a product's rows l/4; its rows l/4 + 8 carry dhp_t's
//      second term beside the first, so two products a k-block where three
//      terms would take three.  Each product is summed by two accumulators
//      (even and odd k-blocks: the chains of dependent products a sixth as
//      long), and dh_next = (dh z + term 1) + (term 2 + term 3).  Only the
//      order of the sums differs from the plain version, now with the tensor
//      core's own rounding of its fp32 sums.  Accurate tanhf.
//   4. A warp's slices of xp (its units' r, z, n) and grad_out (its units),
//      and the m-tile's h_{t-1}, arrive through the warp's ring of S = 3
//      slots in shared memory by cp.async, S - 1 steps ahead; rows padded to
//      an odd number of 16-byte chunks.  dxp is stored as bf16 pairs, dhp and
//      h_{t-1} as fp32 pairs, after the step's barrier (before it, the barrier
//      waited on them: measured in the forward, csrc/bigru_seq_bf16.cu).
//   5. 8 rows an m-tile at every N: each lane's chain of steps carries one
//      row's pairs, the most work a step of any kernel of K1's.  16-row
//      m-tiles (two rows a lane, all of a product's rows used) were slower
//      at three of the four sweeps timed (batch 48 and 512) on an H100, so
//      only 8 is built.  Four warps a block (4 / (H/8) m-tiles).

// What bounds it now.  Each sweep at batch 48 reads xp (18.9 MB), out and
// grad_out (6.3 MB each) and writes dxp (18.9 MB) in bf16, and dhp (37.7 MB)
// and h_{t-1} (12.6 MB) in fp32: 101 MB, 30 us at 3.35 TB/s, 0.30 ms per SR
// backward (0.150 without the fp32 outputs, which only feed the GEMM); the
// products, 2.4 GFLOP a sweep with dhp's three terms, 2.4 us at 989 TFLOP/s.
//
// -Xptxas -v on sm_90a (registers; no spills, no stack frame; dynamic shared
// memory a block): H = 32: 88 (23,040 B); H = 16: 66 (19,968 B); H = 8: 60
// (16,896 B).
//
// Measured (tpgsr_tpu_torch/bench_k1.py --bf16, H100 SXM at 700 W): alone
// 70.3 us over W and 59.4 us over H at batch 48, 0.649 ms per SR backward
// against 0.798 for the fp32-state kernel's bf16 instantiation in the same
// call, 2.2x the byte bound with the fp32 dhp and h_{t-1}; with the dW_hh
// GEMM 1.498 ms against 1.630.  At batch 512, 0.535 / 0.503 ms a sweep
// against 0.754 / 0.751.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kWarps = 4;  // warps a block: 4 / (H/8) m-tiles
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;  // slots of the input rings

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

// (x, y) as three bf16 pairs, the largest first (ops/rnn.py::bf16_split3).
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

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// A row of `values` bf16 padded to an odd number of 16-byte chunks, so that
// 8 rows x 4 consecutive 4-byte words fall in 32 distinct banks.
constexpr int padded(int values) { return values + ((values / 8) % 2 == 0 ? 8 : 0); }

constexpr int kRows = 8;  // rows an m-tile (design 5)

template <int H>
struct Shape {
  static_assert(H % 8 == 0 && kWarps % (H / 8) == 0, "H a multiple of 8 dividing 32");
  static constexpr int kQ = H / 8;                    // 8-unit tiles of h: warps an m-tile, one tile each
  static constexpr int kGroups = kWarps / kQ;         // m-tiles a block
  static constexpr int kTiles = 3 * kQ;               // 8-column tiles of dhp [8, 3H]
  static constexpr int kBlocksH = (H + 15) / 16;      // k-blocks of the recompute (over h)
  static constexpr int kBlocksG = (3 * H + 15) / 16;  // k-blocks of dhp W_hh (over 3H)
  static constexpr int kStrideX = 24;                 // ring row of the warp's xp slice: 8 units of r, z, n
  static constexpr int kStrideG = 8;                  // ... of its grad_out slice
  static constexpr int kStrideH = padded(H);          // ... of the m-tile's h_{t-1}
  static constexpr int kSlot = kRows * (kStrideX + kStrideG + kStrideH);  // bf16 a slot
  static constexpr int kChunks = kRows * (3 + 1 + kQ);                    // a step's 16-byte copies
  static constexpr int kCopies = (kChunks + 31) / 32;                     // ... a lane
  static constexpr int kTerms = 3 * kTiles * 32;  // words of one buffer of dhp's terms, [3][kTiles][32]
};

template <int H>
constexpr size_t smem_bytes() {
  using Sh = Shape<H>;
  return sizeof(uint32_t) * Sh::kGroups * 2 * Sh::kTerms + sizeof(__nv_bfloat16) * kWarps * kStages * Sh::kSlot;
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    bigru_seq_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ xp, const float* __restrict__ w_t,
                              const float* __restrict__ b_hh, const __nv_bfloat16* __restrict__ out,
                              const __nv_bfloat16* __restrict__ grad_out, __nv_bfloat16* __restrict__ dxp,
                              float* __restrict__ dhp, float* __restrict__ h_prev_out, int n, int n_pad,
                              int t_len) {
  using Sh = Shape<H>;
  constexpr int S = kStages;
  constexpr int Q = Sh::kQ;
  constexpr int G = 3 * H;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;    // the fragments' row and column pair
  const int group = warp / Q, q0 = warp % Q;  // the warp's m-tile in the block, its unit tile
  const int dir = blockIdx.y;
  const int row0 = (blockIdx.x * Sh::kGroups + group) * kRows;  // the m-tile: rows row0 .. row0 + 7
  if (row0 >= n) return;  // the whole group: its barrier spans it alone
  const int row = row0 + g;  // the lane's row
  const bool valid = row < n;

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* terms = smem + group * 2 * Sh::kTerms;  // the group's [2][3][kTiles][32]
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + Sh::kGroups * 2 * Sh::kTerms) + warp * S * Sh::kSlot;
  auto term_at = [&](int buf, int term, int tile) -> uint32_t& {
    return terms[((buf * 3 + term) * Sh::kTiles + tile) * 32 + lane];
  };
  auto sync_group = [&] { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * Q) : "memory"); };

  // Design 1: w[j * G + c] = W_hh[c][j].  The recompute's B[k = j][c] for the
  // warp's column c = gate H + 8 q0 + g, and the second product's
  // B[k = c][j] for its unit j = 8 q0 + g; lane (g, tig) holds rows
  // k = 16 kb + 8 half + 2 tig + {0, 1}.
  const float* w = w_t + static_cast<size_t>(dir) * H * G;
  uint32_t wh[Sh::kBlocksH][3][2], wg[Sh::kBlocksG][2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int kb = 0; kb < Sh::kBlocksH; ++kb)
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        const int k = 16 * kb + 8 * half + 2 * tig, c = gate * H + 8 * q0 + g;
        wh[kb][gate][half] = k < H ? pack(w[k * G + c], w[(k + 1) * G + c]) : 0u;
      }
#pragma unroll
    for (int kb = 0; kb < Sh::kBlocksG; ++kb) {
      const int k = 16 * kb + 8 * half + 2 * tig, j = 8 * q0 + g;
      wg[kb][half] = k < G ? pack(w[j * G + k], w[j * G + k + 1]) : 0u;
    }
  }
  float bias[3][2];  // b_hh at the accumulator's columns gate H + 8 q0 + 2 tig + {0, 1}
  const float* b = b_hh + dir * G + 8 * q0 + 2 * tig;
#pragma unroll
  for (int gate = 0; gate < 3; ++gate) {
    bias[gate][0] = b[gate * H];
    bias[gate][1] = b[gate * H + 1];
  }

  // 32-bit element offsets (the wrapper checks that they fit).
  const int x_row = t_len * 6 * H, o_row = t_len * 2 * H;
  auto time_of = [&](int s) { return dir ? t_len - 1 - s : s; };  // step s of this direction

  // Design 4: copy i = 32 p + lane of step s: gate i % 3 of the warp's xp
  // slice of row i / 3, then its grad_out slice of each row, then the
  // m-tile's h_{t-1} (out at time_of(s - 1), zeros at s = 0) chunk by chunk;
  // rows past n are zero-filled from a valid address.
  auto stage = [&](int s) {
    __nv_bfloat16* slot = ring + (s % S) * Sh::kSlot;
#pragma unroll
    for (int p = 0; p < Sh::kCopies; ++p) {
      const int i = 32 * p + lane;
      if (i < Sh::kChunks) {
        int r, off, kind;  // kind 0: xp, 1: grad_out, 2: h_{t-1}; off: the chunk's bf16 in the slice
        if (i < 3 * kRows) {
          kind = 0, r = i / 3, off = 8 * (i % 3);
        } else if (i < 4 * kRows) {
          kind = 1, r = i - 3 * kRows, off = 0;
        } else {
          kind = 2, r = (i - 4 * kRows) / Q, off = 8 * ((i - 4 * kRows) % Q);
        }
        const bool ok = row0 + r < n && (kind < 2 || s > 0);
        const int te = time_of(kind < 2 ? s : max(s - 1, 0));
        const __nv_bfloat16* src =
            kind == 0 ? xp + (row0 + r) * x_row + te * 6 * H + dir * G + 8 * q0 + off / 8 * H
                      : (kind == 1 ? grad_out + 8 * q0 : out + off) + (row0 + r) * o_row + te * 2 * H + dir * H;
        __nv_bfloat16* dst = kind == 0   ? slot + r * Sh::kStrideX + off
                             : kind == 1 ? slot + kRows * Sh::kStrideX + r * Sh::kStrideG
                                         : slot + kRows * (Sh::kStrideX + Sh::kStrideG) + r * Sh::kStrideH + off;
        cp_async16(dst, ok ? src : xp, ok);
      }
    }
  };
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (t_len - 1 - k >= 0) stage(t_len - 1 - k);
    cp_async_commit();
  }

  // Design 2: dh_next at the lane's row and units 8 q0 + 2 tig + e.
  float dh_next[2] = {0.f, 0.f};

#pragma unroll 1
  for (int s = t_len - 1; s >= 0; --s) {
    // Step s's group is complete once at most S - 2 newer ones are pending;
    // the barrier makes every lane's copies visible and closes step s + 1,
    // whose slot the next copy reuses.
    cp_async_wait<S - 2>();
    __syncwarp();
    if (s - (S - 1) >= 0) stage(s - (S - 1));
    cp_async_commit();

    const __nv_bfloat16* xs = ring + (s % S) * Sh::kSlot;
    const __nv_bfloat16* gs = xs + kRows * Sh::kStrideX;
    const __nv_bfloat16* hs = gs + kRows * Sh::kStrideG;
    // h_{t-1} as bf16 pairs: the recompute's A fragments (rows l/4; rows
    // l/4 + 8 zero), and at tile q0 the lane's own values.
    auto h_frag = [&](int q) { return q < Q ? lds32(hs + g * Sh::kStrideH + 8 * q + 2 * tig) : 0u; };
    float acc[3][4];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      acc[gate][0] = acc[gate][2] = bias[gate][0];
      acc[gate][1] = acc[gate][3] = bias[gate][1];
    }
#pragma unroll
    for (int kb = 0; kb < Sh::kBlocksH; ++kb) {
      const uint32_t a0 = h_frag(2 * kb), a2 = h_frag(2 * kb + 1);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) mma_bf16(acc[gate], a0, 0u, a2, 0u, wh[kb][gate][0], wh[kb][gate][1]);
    }

    // The gates and dhp_t at the lane's pairs; dhp_t's terms to the group's
    // buffer s % 2, tile gate * Q + q0.
    const int te = time_of(s);
    const int buf = s & 1;
    // dh_next's partial sums, [product][k-block parity][fragment]: product 0
    // holds dh z + term 1 in rows l/4 and term 2 in rows l/4 + 8, product 1
    // term 3 in rows l/4
    float acc_g[2][2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int par = 0; par < 2; ++par) acc_g[p][par][0] = acc_g[p][par][1] = acc_g[p][par][2] = acc_g[p][par][3] = 0.f;
    float d_r[2], d_z[2], d_n[2], d_hn[2];
    const __nv_bfloat16* x = xs + g * Sh::kStrideX + 2 * tig;
    const uint32_t xg[3] = {lds32(x), lds32(x + 8), lds32(x + 16)};
    const uint32_t go = lds32(gs + g * Sh::kStrideG + 2 * tig);
    const uint32_t hp = h_frag(q0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      auto lo_hi = [&](uint32_t u) { return e ? high_f32(u) : low_f32(u); };
      const float h_prev = lo_hi(hp);
      const float hn = acc[2][e];
      const float rg = sigmoid_f32(lo_hi(xg[0]) + acc[0][e]);
      const float zg = sigmoid_f32(lo_hi(xg[1]) + acc[1][e]);
      const float ng = tanhf(lo_hi(xg[2]) + rg * hn);
      const float dh = lo_hi(go) + dh_next[e];
      const float dn_hat = dh * (1.0f - zg) * (1.0f - ng * ng);
      d_n[e] = dn_hat;
      d_r[e] = dn_hat * hn * rg * (1.0f - rg);
      d_z[e] = dh * (h_prev - ng) * zg * (1.0f - zg);
      d_hn[e] = dn_hat * rg;
      acc_g[0][0][e] = dh * zg;
    }
    auto put = [&](int gate, float lo, float hi) {
      uint32_t t3[3];
      split3(lo, hi, t3);
#pragma unroll
      for (int term = 0; term < 3; ++term) term_at(buf, term, gate * Q + q0) = t3[term];
    };
    put(0, d_r[0], d_r[1]);
    put(1, d_z[0], d_z[1]);
    put(2, d_hn[0], d_hn[1]);
    sync_group();  // buffer s % 2 complete; buffer (s + 1) % 2 free for step s - 1 to write

    // dh_next = dh z + dhp_t W_hh at the warp's units.  A's rows l/4 and
    // l/4 + 8: terms 1 | 2, then 3 | zeros.
    auto frag = [&](int term, int tile) {  // zero past 3H
      return tile < Sh::kTiles ? term_at(buf, term, tile < Sh::kTiles ? tile : 0) : 0u;
    };
#pragma unroll
    for (int kb = 0; kb < Sh::kBlocksG; ++kb) {
      mma_bf16(acc_g[0][kb % 2], frag(0, 2 * kb), frag(1, 2 * kb), frag(0, 2 * kb + 1), frag(1, 2 * kb + 1), wg[kb][0],
               wg[kb][1]);
      mma_bf16(acc_g[1][kb % 2], frag(2, 2 * kb), 0u, frag(2, 2 * kb + 1), 0u, wg[kb][0], wg[kb][1]);
    }

    // The step's outputs after the barrier, which would otherwise wait on
    // the stores: the next barrier is a step away.
    if (valid) {
      const int col = 8 * q0 + 2 * tig;
      __nv_bfloat16* dx = dxp + row * x_row + te * 6 * H + dir * G + col;
      *reinterpret_cast<uint32_t*>(dx) = pack(d_r[0], d_r[1]);
      *reinterpret_cast<uint32_t*>(dx + H) = pack(d_z[0], d_z[1]);
      *reinterpret_cast<uint32_t*>(dx + 2 * H) = pack(d_n[0], d_n[1]);
      const int p = (dir * n_pad + row) * t_len + te;  // row-step of dhp and h_prev_out
      *reinterpret_cast<float2*>(dhp + p * G + col) = make_float2(d_r[0], d_r[1]);
      *reinterpret_cast<float2*>(dhp + p * G + H + col) = make_float2(d_z[0], d_z[1]);
      *reinterpret_cast<float2*>(dhp + p * G + 2 * H + col) = make_float2(d_hn[0], d_hn[1]);
      *reinterpret_cast<float2*>(h_prev_out + p * H + col) = make_float2(low_f32(hp), high_f32(hp));
    }
    auto sum = [&](int p, int c) { return acc_g[p][0][c] + acc_g[p][1][c]; };
#pragma unroll
    for (int e = 0; e < 2; ++e) dh_next[e] = sum(0, e) + (sum(0, 2 + e) + sum(1, e));  // (dh z + 1) + (2 + 3)
  }
  cp_async_wait<0>();
}

// Ops run by dispatch() on the instantiation of hidden.  Shared memory
// stays under the 48 KB a launch gets without opting in.
struct Backward {
  const __nv_bfloat16* xp;
  const float *w_t, *b_hh;
  const __nv_bfloat16 *out, *grad_out;
  __nv_bfloat16* dxp;
  float *dhp, *h_prev;
  int n, n_pad, t_len;
  cudaStream_t stream;

  template <int H>
  int run() const {
    static_assert(smem_bytes<H>() <= 48 * 1024, "the rings need an opt-in to more shared memory");
    constexpr int groups = Shape<H>::kGroups;
    const int tiles = (n + kRows - 1) / kRows;
    const dim3 grid((tiles + groups - 1) / groups, 2);
    bigru_seq_bwd_bf16_kernel<H><<<grid, kThreads, smem_bytes<H>(), stream>>>(xp, w_t, b_hh, out, grad_out, dxp,
                                                                             dhp, h_prev, n, n_pad, t_len);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Occupancy {
  int* blocks;

  template <int H>
  int run() const {
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, bigru_seq_bwd_bf16_kernel<H>, kThreads, smem_bytes<H>()));
  }
};

template <class Op>
int dispatch(const Op& op, int hidden) {
  switch (hidden) {
    case 8:
      return op.template run<8>();
    case 16:
      return op.template run<16>();
    case 32:
      return op.template run<32>();
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both return a cudaError_t as int: 0 on success.  xp, out, grad_out and dxp
// are __nv_bfloat16; w_t and b_hh float holding bf16 values; dhp and h_prev
// float.
extern "C" int tpgsr_bigru_seq_bf16_backward(const void* xp, const float* w_t, const float* b_hh, const void* out,
                                             const void* grad_out, void* dxp, float* dhp, float* h_prev, int n,
                                             int n_pad, int t_len, int hidden, void* stream) {
  if (n <= 0 || t_len <= 0 || n_pad < n) return static_cast<int>(cudaErrorInvalidValue);
  const Backward op{static_cast<const __nv_bfloat16*>(xp), w_t, b_hh, static_cast<const __nv_bfloat16*>(out),
                    static_cast<const __nv_bfloat16*>(grad_out), static_cast<__nv_bfloat16*>(dxp), dhp, h_prev,
                    n, n_pad, t_len, static_cast<cudaStream_t>(stream)};
  return dispatch(op, hidden);
}

// Resident blocks an SM for the instantiation of hidden, written to *blocks.
extern "C" int tpgsr_bigru_seq_bf16_backward_occupancy(int hidden, int* blocks) {
  const Occupancy op{blocks};
  return dispatch(op, hidden);
}
