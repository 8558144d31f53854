// K1 at hidden sizes 64 and 128: the bidirectional GRU recurrence and its
// BPTT, for Hopper (sm_90a), in fp32 or bf16 storage.
//
// Replaces the TPU kernel tpgsr_tpu/ops/pallas_gru.py::_gru_seq_kernel
// (launched by _bigru_pallas_impl at pallas_gru.py:95) where a row's state
// no longer fits one warp; the backward is the BPTT of the same recurrence,
// as csrc/bigru_seq_bwd.cu computes it at H <= 32.  The layout contract is
// that of csrc/bigru_seq.cu and csrc/bigru_seq_bwd.cu: xp [N, T, 6H], w_t
// [2, H, 3H] (W_hh transposed per direction), b_hh [2, 3H], out and
// grad_out [N, T, 2H]; the backward writes dxp [N, T, 6H], and per
// direction dhp [2, Np, T, 3H] and h_{t-1} [2, Np, T, H] for the rows below
// N, from which ops/gru_seq.py forms dW_hh and db_hh with one GEMM.  Every
// other hidden size up to 128 reaches these kernels padded with zero units
// (ops/gru_seq.py, ops/rnn.py::pad_hidden).
//
//   forward:  hp = h W_hh^T + b_hh;  r = sig(xr + hr);  z = sig(xz + hz);
//             n = tanh(xn + r * hn);  h = (1 - z) n + z h
//   backward: the gates recomputed from h_{t-1} (out's previous step);
//             dh = grad_out_t + dh_next;  dn^ = dh (1 - z)(1 - n^2);
//             dr^ = dn^ hn r (1 - r);  dz^ = dh (h_{t-1} - n) z (1 - z);
//             dxp_t = [dr^, dz^, dn^];  dhp_t = [dr^, dz^, dn^ r];
//             dh_next = dh z + W_hh^T dhp_t
//
// What bounds it.  At H = 64 a row-step's recurrent product is 3H x H =
// 12,288 FMAs against 8H = 512 values of xp and out (fp32: 2 KB), so the
// sweeps are bound by operations: the flagship's two sweeps at --hd_u 64
// and batch 48 (N*T = 49,152 row-steps, both directions) do 2.4 GFLOP of
// recurrent products, 36 us at the fp32 peak of 67 TFLOP/s, against 101 MB,
// 30 us at 3.35 TB/s; at H = 128, 9.7 GFLOP (144 us).  The backward runs
// two such products a row-step.
//
// The design: the simplest that is right beyond a warp.
//   1. W_hh^T stays in shared memory, not in registers (3H weights a
//      thread would need 192 registers at H = 64): [H][3H + 1] floats, 49 KB
//      at H = 64 and 193 KB at H = 128 (beyond 48 KB by opt-in).  The odd
//      row stride makes both products conflict-free: the forward's and the
//      recompute's (lane j reads column j of row k, consecutive across
//      lanes) and the backward's transposed one (lane j reads row j, a
//      stride of 3H + 1 words across lanes).
//   2. A block is H x 4 threads: thread (j, g) owns hidden unit j of its
//      group's RPT rows (1, 2 or 4, chosen in Python from this kernel's
//      occupancy: ops/gru_seq.py, launch_config), so each weight it reads
//      from shared memory feeds RPT FMAs.  A row spans H / 32 warps, so h
//      (double-buffered) and the backward's h_{t-1} and dhp_t pass through
//      shared memory under block barriers: one a forward step, two a
//      backward step.
//   3. Each step's inputs (xp, and in the backward grad_out and h_{t-1})
//      are loaded one step ahead into registers.
// fp32 arithmetic with accurate tanhf (sigmoid through tanhf) in both
// storage types; bf16 storage rounds only out and dxp, as the plain versions
// (ops/rnn.py) do.  Only the order of the sums differs from them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 4;  // row groups a block (threadIdx.y)

// sigmoid(x) = tanh(x / 2) / 2 + 1 / 2: one accurate tanhf, no expf and no
// division; exactly 0.5 at 0, so a padded unit stays 0.
__device__ __forceinline__ float sigmoid_f32(float x) { return fmaf(0.5f, tanhf(0.5f * x), 0.5f); }

// The storage type to fp32 and back (round to nearest even).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

template <int H, int RPT>
struct Wide {
  static_assert(H % 32 == 0, "a row spans whole warps");
  static constexpr int kThreads = H * kGroups;
  static constexpr int kMinBlocks = H <= 64 ? 2 : 1;  // at most 128 registers a thread either way
  static constexpr int kRows = kGroups * RPT;         // rows of a block
  static constexpr int kGates = 3 * H;
  static constexpr int kStride = 3 * H + 1;           // the weights' row stride in shared memory
  static constexpr int kWeights = H * kStride;        // a multiple of 4: what follows is 16-byte aligned
};

// Shared memory of the forward: the weights, then h in two buffers.
template <int H, int RPT>
constexpr size_t forward_smem() {
  return sizeof(float) * (Wide<H, RPT>::kWeights + 2 * Wide<H, RPT>::kRows * H);
}

// ... of the backward: the weights, h_{t-1}, then dhp_t.
template <int H, int RPT>
constexpr size_t backward_smem() {
  return sizeof(float) * (Wide<H, RPT>::kWeights + Wide<H, RPT>::kRows * 4 * H);
}

// w_t [H][3H] of one direction into shared memory [H][3H + 1], by the whole
// block (coalesced reads).
template <int H, int RPT>
__device__ __forceinline__ void load_weights(float* w_s, const float* __restrict__ w, int tid) {
  using Sh = Wide<H, RPT>;
  for (int i = tid; i < H * Sh::kGates; i += Sh::kThreads) w_s[(i / Sh::kGates) * Sh::kStride + i % Sh::kGates] = w[i];
}

// sum_k W[c][k] h[k] + b for the three gates c = j, H + j, 2H + j of each of
// the thread's rows, h read from shared memory (rows of H floats, the same
// address across a warp: a broadcast).  The bias is added after the sum, as
// cuBLAS's baddbmm in the plain version adds it: a running sum that starts
// at a large value rounds every term at that value's scale.
template <int H, int RPT>
__device__ __forceinline__ void gate_sums(const float* w_s, const float* h_rows, int j, float br, float bz,
                                          float bn, float (&ar)[RPT], float (&az)[RPT], float (&an)[RPT]) {
  using Sh = Wide<H, RPT>;
#pragma unroll
  for (int i = 0; i < RPT; ++i) ar[i] = az[i] = an[i] = 0.f;
#pragma unroll 4
  for (int k = 0; k < H; k += 4) {
    float hv[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float4 h4 = *reinterpret_cast<const float4*>(h_rows + i * H + k);
      hv[i][0] = h4.x;
      hv[i][1] = h4.y;
      hv[i][2] = h4.z;
      hv[i][3] = h4.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* wk = w_s + (k + q) * Sh::kStride;
      const float wr = wk[j], wz = wk[H + j], wn = wk[2 * H + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        ar[i] = fmaf(wr, hv[i][q], ar[i]);
        az[i] = fmaf(wz, hv[i][q], az[i]);
        an[i] = fmaf(wn, hv[i][q], an[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    ar[i] += br;
    az[i] += bz;
    an[i] += bn;
  }
}

template <typename T, int H, int RPT>
__global__ void __launch_bounds__(Wide<H, RPT>::kThreads, Wide<H, RPT>::kMinBlocks)
    bigru_wide_forward_kernel(const T* __restrict__ xp, const float* __restrict__ w_t,
                              const float* __restrict__ b_hh, T* __restrict__ out, int n, int t_len) {
  using Sh = Wide<H, RPT>;
  constexpr int G = Sh::kGates;
  const int j = threadIdx.x;
  const int g = threadIdx.y;
  const int dir = blockIdx.y;
  const int lrow0 = g * RPT;                       // the thread's first row in the block
  const int row0 = blockIdx.x * Sh::kRows + lrow0;  // ... and in the batch

  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                  // [H][kStride]
  float* h_s = smem + Sh::kWeights;   // [2][kRows][H]
  load_weights<H, RPT>(w_s, w_t + static_cast<size_t>(dir) * H * G, g * H + j);
  const float* b = b_hh + dir * G;
  const float br = b[j], bz = b[H + j], bn = b[2 * H + j];

  // Rows beyond n run the loop on zeros (every thread reaches the barriers)
  // and store nothing.
  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) valid |= static_cast<unsigned>(row0 + i < n) << i;
  const size_t x_row = static_cast<size_t>(t_len) * 6 * H, o_row = static_cast<size_t>(t_len) * 2 * H;
  const size_t x0 = static_cast<size_t>(row0) * x_row + dir * G + j;
  const size_t o0 = static_cast<size_t>(row0) * o_row + dir * H + j;
  auto time_of = [&](int t) { return dir ? t_len - 1 - t : t; };  // step t of this direction

  float xr[RPT], xz[RPT], xn[RPT], h[RPT];
  auto load_x = [&](int t, float (&r)[RPT], float (&z)[RPT], float (&nn)[RPT]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      r[i] = z[i] = nn[i] = 0.f;
      if (((valid >> i) & 1u) && t < t_len) {
        const T* x = xp + x0 + i * x_row + static_cast<size_t>(time_of(t)) * 6 * H;
        r[i] = to_f32(x[0]);
        z[i] = to_f32(x[H]);
        nn[i] = to_f32(x[2 * H]);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    h[i] = 0.f;
    h_s[(lrow0 + i) * H + j] = 0.f;
  }
  load_x(0, xr, xz, xn);
  __syncthreads();  // the weights and h_0

  for (int t = 0; t < t_len; ++t) {
    float nr[RPT], nz[RPT], nn[RPT];
    load_x(t + 1, nr, nz, nn);  // the next step's inputs, in flight during this one
    const float* hc = h_s + (t & 1) * Sh::kRows * H;
    float* hn = h_s + ((t + 1) & 1) * Sh::kRows * H;
    float ar[RPT], az[RPT], an[RPT];
    gate_sums<H, RPT>(w_s, hc + lrow0 * H, j, br, bz, bn, ar, az, an);
    const size_t te = static_cast<size_t>(time_of(t)) * 2 * H;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float rg = sigmoid_f32(xr[i] + ar[i]);
      const float zg = sigmoid_f32(xz[i] + az[i]);
      const float ng = tanhf(xn[i] + rg * an[i]);
      h[i] = (1.0f - zg) * ng + zg * h[i];
      hn[(lrow0 + i) * H + j] = h[i];
      if ((valid >> i) & 1u) out[o0 + i * o_row + te] = from_f32<T>(h[i]);
      xr[i] = nr[i];
      xz[i] = nz[i];
      xn[i] = nn[i];
    }
    // h_{t+1} complete for every row; the reads of buffer t & 1, which step
    // t+1 overwrites, are done
    __syncthreads();
  }
}

template <typename T, int H, int RPT>
__global__ void __launch_bounds__(Wide<H, RPT>::kThreads, Wide<H, RPT>::kMinBlocks)
    bigru_wide_backward_kernel(const T* __restrict__ xp, const float* __restrict__ w_t,
                               const float* __restrict__ b_hh, const T* __restrict__ out,
                               const T* __restrict__ grad_out, T* __restrict__ dxp, float* __restrict__ dhp,
                               float* __restrict__ h_prev_out, int n, int n_pad, int t_len) {
  using Sh = Wide<H, RPT>;
  constexpr int G = Sh::kGates;
  const int j = threadIdx.x;
  const int g = threadIdx.y;
  const int dir = blockIdx.y;
  const int lrow0 = g * RPT;
  const int row0 = blockIdx.x * Sh::kRows + lrow0;

  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                               // [H][kStride]
  float* h_s = smem + Sh::kWeights;                // h_{t-1}, [kRows][H]
  float* d_s = h_s + Sh::kRows * H;                // dhp_t, [kRows][3H]
  load_weights<H, RPT>(w_s, w_t + static_cast<size_t>(dir) * H * G, g * H + j);
  const float* b = b_hh + dir * G;
  const float br = b[j], bz = b[H + j], bn = b[2 * H + j];

  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) valid |= static_cast<unsigned>(row0 + i < n) << i;
  const size_t x_row = static_cast<size_t>(t_len) * 6 * H, o_row = static_cast<size_t>(t_len) * 2 * H;
  const size_t x0 = static_cast<size_t>(row0) * x_row + dir * G + j;  // xp, dxp
  const size_t o0 = static_cast<size_t>(row0) * o_row + dir * H + j;  // out, grad_out
  const size_t p0 = (static_cast<size_t>(dir) * n_pad + row0) * t_len;  // dhp, h_prev_out: row-steps
  auto time_of = [&](int s) { return dir ? t_len - 1 - s : s; };

  // Step s's inputs of the thread's rows: xp's three gates, grad_out and
  // h_{t-1} (out at the direction's previous step, 0 at its first).
  struct Inputs {
    float r[RPT], z[RPT], n[RPT], go[RPT], hp[RPT];
  };
  auto load = [&](int s, Inputs& in) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      in.r[i] = in.z[i] = in.n[i] = in.go[i] = in.hp[i] = 0.f;
      if (((valid >> i) & 1u) && s >= 0) {
        const T* x = xp + x0 + i * x_row + static_cast<size_t>(time_of(s)) * 6 * H;
        in.r[i] = to_f32(x[0]);
        in.z[i] = to_f32(x[H]);
        in.n[i] = to_f32(x[2 * H]);
        in.go[i] = to_f32(grad_out[o0 + i * o_row + static_cast<size_t>(time_of(s)) * 2 * H]);
        if (s > 0) in.hp[i] = to_f32(out[o0 + i * o_row + static_cast<size_t>(time_of(s - 1)) * 2 * H]);
      }
    }
  };

  Inputs cur, next;
  load(t_len - 1, cur);
  float dh_next[RPT], carry[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) dh_next[i] = 0.f;

  for (int s = t_len - 1; s >= 0; --s) {
    const int te = time_of(s);
#pragma unroll
    for (int i = 0; i < RPT; ++i) h_s[(lrow0 + i) * H + j] = cur.hp[i];
    load(s - 1, next);  // in flight during this step
    // h_{t-1} complete for every row; the previous step's reads of d_s are done
    __syncthreads();

    float ar[RPT], az[RPT], an[RPT];
    gate_sums<H, RPT>(w_s, h_s + lrow0 * H, j, br, bz, bn, ar, az, an);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float rg = sigmoid_f32(cur.r[i] + ar[i]);
      const float zg = sigmoid_f32(cur.z[i] + az[i]);
      const float ng = tanhf(cur.n[i] + rg * an[i]);
      const float dh = cur.go[i] + dh_next[i];
      const float dn_hat = dh * (1.0f - zg) * (1.0f - ng * ng);
      const float dr_hat = dn_hat * an[i] * rg * (1.0f - rg);
      const float dz_hat = dh * (cur.hp[i] - ng) * zg * (1.0f - zg);
      const float dhn = dn_hat * rg;
      if ((valid >> i) & 1u) {
        const size_t x = x0 + i * x_row + static_cast<size_t>(te) * 6 * H;
        const size_t p = p0 + static_cast<size_t>(i) * t_len + te;
        dxp[x] = from_f32<T>(dr_hat);
        dxp[x + H] = from_f32<T>(dz_hat);
        dxp[x + 2 * H] = from_f32<T>(dn_hat);
        dhp[p * G + j] = dr_hat;
        dhp[p * G + H + j] = dz_hat;
        dhp[p * G + 2 * H + j] = dhn;
        h_prev_out[p * H + j] = cur.hp[i];
      }
      float* d = d_s + (lrow0 + i) * G;
      d[j] = dr_hat;
      d[H + j] = dz_hat;
      d[2 * H + j] = dhn;
      carry[i] = dh * zg;
    }
    // dhp_t complete for every row
    __syncthreads();

    // (W_hh^T dhp_t)_j = sum_m W_hh[m][j] dhp_t[m] = sum_m w_t[j][m] dhp_t[m]:
    // lane j walks row j of the weights, dhp_t a broadcast; dh z is added
    // after the sum, as in the plain version
    const float* wj = w_s + j * Sh::kStride;
#pragma unroll
    for (int i = 0; i < RPT; ++i) dh_next[i] = 0.f;
#pragma unroll 4
    for (int m = 0; m < G; m += 4) {
      const float w0 = wj[m], w1 = wj[m + 1], w2 = wj[m + 2], w3 = wj[m + 3];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 d4 = *reinterpret_cast<const float4*>(d_s + (lrow0 + i) * G + m);
        dh_next[i] = fmaf(w0, d4.x, dh_next[i]);
        dh_next[i] = fmaf(w1, d4.y, dh_next[i]);
        dh_next[i] = fmaf(w2, d4.z, dh_next[i]);
        dh_next[i] = fmaf(w3, d4.w, dh_next[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) dh_next[i] += carry[i];
    cur = next;
  }
}

// Ops run by by_dtype() on the instantiation of (storage type, hidden, rpt).
// Shared memory beyond 48 KB is opted into at every launch and query.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

struct Forward {
  const void* xp;
  const float *w_t, *b_hh;
  void* out;
  int n, t_len;
  cudaStream_t stream;

  template <typename T, int H, int RPT>
  int run() const {
    using Sh = Wide<H, RPT>;
    constexpr size_t bytes = forward_smem<H, RPT>();
    static_assert(bytes <= 232448, "beyond a block's shared memory");
    const auto kernel = bigru_wide_forward_kernel<T, H, RPT>;
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + Sh::kRows - 1) / Sh::kRows, 2);
    kernel<<<grid, dim3(H, kGroups), bytes, stream>>>(static_cast<const T*>(xp), w_t, b_hh, static_cast<T*>(out), n,
                                                      t_len);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Backward {
  const void* xp;
  const float *w_t, *b_hh;
  const void *out, *grad_out;
  void* dxp;
  float *dhp, *h_prev;
  int n, n_pad, t_len;
  cudaStream_t stream;

  template <typename T, int H, int RPT>
  int run() const {
    using Sh = Wide<H, RPT>;
    constexpr size_t bytes = backward_smem<H, RPT>();
    static_assert(bytes <= 232448, "beyond a block's shared memory");
    const auto kernel = bigru_wide_backward_kernel<T, H, RPT>;
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + Sh::kRows - 1) / Sh::kRows, 2);
    kernel<<<grid, dim3(H, kGroups), bytes, stream>>>(
        static_cast<const T*>(xp), w_t, b_hh, static_cast<const T*>(out), static_cast<const T*>(grad_out),
        static_cast<T*>(dxp), dhp, h_prev, n, n_pad, t_len);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Occupancy {
  bool backward;
  int* blocks;

  template <typename T, int H, int RPT>
  int run() const {
    const size_t bytes = backward ? backward_smem<H, RPT>() : forward_smem<H, RPT>();
    const auto fwd = bigru_wide_forward_kernel<T, H, RPT>;
    const auto bwd = bigru_wide_backward_kernel<T, H, RPT>;
    const cudaError_t err = backward ? allow_smem(bwd, bytes) : allow_smem(fwd, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = Wide<H, RPT>::kThreads;
    return static_cast<int>(backward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, bwd, threads, bytes)
                                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fwd, threads, bytes));
  }
};

template <typename T, int H, class Op>
int by_rpt(const Op& op, int rpt) {
  switch (rpt) {
    case 1:
      return op.template run<T, H, 1>();
    case 2:
      return op.template run<T, H, 2>();
    case 4:
      return op.template run<T, H, 4>();
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, class Op>
int by_hidden(const Op& op, int hidden, int rpt) {
  switch (hidden) {
    case 64:
      return by_rpt<T, 64>(op, rpt);
    case 128:
      return by_rpt<T, 128>(op, rpt);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Op>
int by_dtype(const Op& op, int hidden, int rpt, int bf16) {
  return bf16 ? by_hidden<__nv_bfloat16>(op, hidden, rpt) : by_hidden<float>(op, hidden, rpt);
}

}  // namespace

// Each returns a cudaError_t as int: 0 on success.  xp, out, grad_out and dxp
// are float, or __nv_bfloat16 where bf16 is 1; w_t, b_hh, dhp and h_prev are
// float.
extern "C" int tpgsr_bigru_wide_forward(const void* xp, const float* w_t, const float* b_hh, void* out, int n,
                                        int t_len, int hidden, int rpt, int bf16, void* stream) {
  if (n <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Forward op{xp, w_t, b_hh, out, n, t_len, static_cast<cudaStream_t>(stream)};
  return by_dtype(op, hidden, rpt, bf16);
}

extern "C" int tpgsr_bigru_wide_backward(const void* xp, const float* w_t, const float* b_hh, const void* out,
                                         const void* grad_out, void* dxp, float* dhp, float* h_prev, int n,
                                         int n_pad, int t_len, int hidden, int rpt, int bf16, void* stream) {
  if (n <= 0 || t_len <= 0 || n_pad < n) return static_cast<int>(cudaErrorInvalidValue);
  const Backward op{xp, w_t, b_hh, out, grad_out, dxp, dhp, h_prev, n, n_pad, t_len,
                    static_cast<cudaStream_t>(stream)};
  return by_dtype(op, hidden, rpt, bf16);
}

// Resident blocks an SM for the instantiation (hidden, rpt, bf16) of the
// forward, or of the backward where backward is 1, written to *blocks.
extern "C" int tpgsr_bigru_wide_occupancy(int hidden, int rpt, int bf16, int backward, int* blocks) {
  const Occupancy op{backward != 0, blocks};
  return by_dtype(op, hidden, rpt, bf16);
}
