// K1's backward: BPTT of the bidirectional GRU recurrence, for Hopper (sm_90a).
//
// The backward of the recurrence that tpgsr_tpu/ops/pallas_gru.py::_gru_seq_kernel
// computes (pallas_gru.py:34; the JAX package has no backward kernel and
// differentiates its lax.scan instead).  The forward is csrc/bigru_seq.cu; the
// plain version is ops/rnn.py::bigru_recurrence_backward.  Per row and
// direction, in reverse time, from dh = 0 after the last step:
//
//   hp = W_hh h_{t-1} + b_hh and the gates r, z, n, recomputed from h_{t-1}
//   dh = grad_out_t + dh_next;  dn = dh (1 - z);  dz = dh (h_{t-1} - n)
//   dn^ = dn (1 - n^2);  dr^ = dn^ hn r (1 - r);  dz^ = dz z (1 - z)
//   dxp_t = [dr^, dz^, dn^];  dhp_t = [dr^, dz^, dn^ r]
//   dh_next = dh z + W_hh^T dhp_t
//
// Layout: xp [N, T, 6H] and out [N, T, 2H] as the forward's, w_t [2, H, 3H]
// (W_hh transposed per direction), b_hh [2, 3H], grad_out [N, T, 2H]; writes
// dxp [N, T, 6H], and per direction dhp [2, Np, T, 3H] and h_{t-1}
// [2, Np, T, H] for the rows below N (Np >= N; the wrapper zeroes the rest).
// dW_hh = sum_t dhp_t^T h_{t-1} and db_hh = sum_t dhp_t are one batched GEMM
// and one sum outside (ops/gru_seq.py), as the input projection's gradients
// are: laid out so, the GEMM splits its N*T-long sum into chunks of whole
// rows without a copy (one [3H, N*T] x [N*T, H] product gives cuBLAS a
// single output tile and took 1.8 ms a sweep at batch 48).  The backward
// direction walks t_eff = T-1-t through strides, as the forward does.
//
// What bounds it.  At the flagship's batch of 48 both sweeps have N*T = 49,152
// row-steps at H = 32.  It reads xp (37.7 MB), out (12.6 MB) and grad_out
// (12.6 MB) and writes dxp (37.7 MB), dhp (37.7 MB) and h_{t-1} (12.6 MB):
// 151 MB, 45 us at 3.35 TB/s, against 1.2 GFLOP of recurrent products (18 us
// at the fp32 peak).
// Like the forward, the chain of T dependent steps binds first: each step
// needs the whole row's h_{t-1} for the recompute and its whole dhp_t for
// W_hh^T dhp_t.
//
// The design, simple first.  Thread (j, g) owns hidden unit j of one row (rows
// of a block: 128 / H), so a row lies within one warp and its vectors are
// exchanged through shared memory with one __syncwarp() each.  W_hh is needed
// twice a step, by rows (the recompute) and by columns (W_hh^T dhp): holding
// both in registers would take 6H = 192 values a thread at H = 32, so the
// row copy (3H values, loaded as the forward does) stays in registers and
// w_t itself sits in shared memory (12.8 KB at H = 32), its rows padded to
// 3H + 4 floats so that lane j's float4 reads of row j hit distinct banks.
// A step's global loads (xp, grad_out, and the thread's own h_{t-1}) are
// issued one step ahead, off the chain.  The partial sums of W_hh^T dhp run
// in four chains.  fp32 throughout with accurate tanhf; only the order of the
// sums differs from the plain version.  A cp.async ring, several rows a
// thread and tensor-core products are left for a redesign.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// As in the forward: sigmoid(x) = tanh(x / 2) / 2 + 1 / 2.
__device__ __forceinline__ float sigmoid_f32(float x) { return fmaf(0.5f, tanhf(0.5f * x), 0.5f); }

template <int H>
struct Shape {
  static constexpr int kRows = kThreads / H;  // rows of a block (threadIdx.y)
  static constexpr int kGates = 3 * H;
  static constexpr int kStride = 3 * H + 4;   // padded row of w_t in shared memory
  static_assert(H % 4 == 0 && 32 % H == 0, "H must divide 32 and be a multiple of 4");
};

template <int H>
constexpr size_t smem_bytes() {
  using Sh = Shape<H>;
  return sizeof(float) * (H * Sh::kStride + Sh::kRows * H + Sh::kRows * Sh::kGates);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    bigru_seq_backward_kernel(const float* __restrict__ xp, const float* __restrict__ w_t,
                              const float* __restrict__ b_hh, const float* __restrict__ out,
                              const float* __restrict__ grad_out, float* __restrict__ dxp,
                              float* __restrict__ dhp, float* __restrict__ h_prev_out, int n, int n_pad,
                              int t_len) {
  using Sh = Shape<H>;
  constexpr int G = Sh::kGates;
  const int j = threadIdx.x;
  const int g = threadIdx.y;
  const int dir = blockIdx.y;
  const int row = blockIdx.x * Sh::kRows + g;
  const bool valid = row < n;

  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                                // [H][kStride]
  float* h_row = w_s + H * Sh::kStride + g * H;     // this row's h_{t-1}
  float* d_row = w_s + H * Sh::kStride + Sh::kRows * H + g * G;  // this row's dhp_t

  const float* w = w_t + static_cast<size_t>(dir) * H * G;
  for (int idx = g * H + j; idx < H * G; idx += kThreads) w_s[idx / G * Sh::kStride + idx % G] = w[idx];
  float wr[H], wz[H], wn[H];  // row j of W_hh for each gate, contiguous across j
#pragma unroll
  for (int k = 0; k < H; ++k) {
    wr[k] = w[k * G + j];
    wz[k] = w[k * G + H + j];
    wn[k] = w[k * G + 2 * H + j];
  }
  const float* b = b_hh + dir * G;
  const float br = b[j], bz = b[H + j], bn = b[2 * H + j];
  __syncthreads();

  // Rows beyond n run the loop on row 0's data (every lane of a warp must
  // reach its barriers) and store nothing.
  const size_t r = valid ? static_cast<size_t>(row) : 0;
  const float* x_r = xp + r * t_len * 6 * H + dir * G;
  const float* o_r = out + r * t_len * 2 * H + dir * H;
  const float* go_r = grad_out + r * t_len * 2 * H + dir * H;
  float* dx_r = dxp + r * t_len * 6 * H + dir * G;
  float* dp_r = dhp + (static_cast<size_t>(dir) * n_pad + r) * t_len * G;
  float* hp_r = h_prev_out + (static_cast<size_t>(dir) * n_pad + r) * t_len * H;
  auto time_of = [&](int s) { return dir ? t_len - 1 - s : s; };  // step s of this direction

  int te = time_of(t_len - 1);
  float nx_r = x_r[te * 6 * H + j], nx_z = x_r[te * 6 * H + H + j], nx_n = x_r[te * 6 * H + 2 * H + j];
  float n_go = go_r[te * 2 * H + j];
  float n_hp = t_len > 1 ? o_r[time_of(t_len - 2) * 2 * H + j] : 0.f;
  float dh_next = 0.f;

  for (int s = t_len - 1; s >= 0; --s) {
    te = time_of(s);
    const float xr = nx_r, xz = nx_z, xn = nx_n, go = n_go, h_prev = n_hp;
    if (s > 0) {  // step s-1's loads, in flight while this step computes
      const int tp = time_of(s - 1);
      nx_r = x_r[tp * 6 * H + j];
      nx_z = x_r[tp * 6 * H + H + j];
      nx_n = x_r[tp * 6 * H + 2 * H + j];
      n_go = go_r[tp * 2 * H + j];
      n_hp = s > 1 ? o_r[time_of(s - 2) * 2 * H + j] : 0.f;
    }

    // The row's h_{t-1} in shared memory.  The previous step's barrier
    // after d_row's stores closed its reads of h_row.
    h_row[j] = h_prev;
    __syncwarp();
    float ar = br, az = bz, an = bn;
#pragma unroll
    for (int k = 0; k < H; k += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(h_row + k);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ar = fmaf(wr[k + q], hv[q], ar);
        az = fmaf(wz[k + q], hv[q], az);
        an = fmaf(wn[k + q], hv[q], an);
      }
    }
    const float rg = sigmoid_f32(xr + ar);
    const float zg = sigmoid_f32(xz + az);
    const float ng = tanhf(xn + rg * an);

    const float dh = go + dh_next;
    const float dn_hat = dh * (1.0f - zg) * (1.0f - ng * ng);
    const float dr_hat = dn_hat * an * rg * (1.0f - rg);
    const float dz_hat = dh * (h_prev - ng) * zg * (1.0f - zg);
    const float dhn_j = dn_hat * rg;
    if (valid) {
      float* dx = dx_r + static_cast<size_t>(te) * 6 * H;
      dx[j] = dr_hat;
      dx[H + j] = dz_hat;
      dx[2 * H + j] = dn_hat;
      float* dp = dp_r + static_cast<size_t>(te) * G;
      dp[j] = dr_hat;
      dp[H + j] = dz_hat;
      dp[2 * H + j] = dhn_j;
      hp_r[static_cast<size_t>(te) * H + j] = h_prev;
    }

    // The row's dhp_t in shared memory; this barrier also closes the reads
    // of h_row above, and the next step's first barrier closes the reads of
    // d_row below.
    d_row[j] = dr_hat;
    d_row[H + j] = dz_hat;
    d_row[2 * H + j] = dhn_j;
    __syncwarp();
    // (W_hh^T dhp_t)_j = sum_i w_t[j][i] dhp_t[i]: row j of w_t, four chains.
    const float* wj = w_s + j * Sh::kStride;
    float acc[4] = {dh * zg, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(wj + i);
      const float4 dv = *reinterpret_cast<const float4*>(d_row + i);
      acc[0] = fmaf(wv.x, dv.x, acc[0]);
      acc[1] = fmaf(wv.y, dv.y, acc[1]);
      acc[2] = fmaf(wv.z, dv.z, acc[2]);
      acc[3] = fmaf(wv.w, dv.w, acc[3]);
    }
    dh_next = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

template <int H>
int launch(const float* xp, const float* w_t, const float* b_hh, const float* out, const float* grad_out,
           float* dxp, float* dhp, float* h_prev, int n, int n_pad, int t_len, cudaStream_t stream) {
  static_assert(smem_bytes<H>() <= 48 * 1024, "shared memory beyond the default 48 KB needs an opt-in");
  constexpr int rows = Shape<H>::kRows;
  const dim3 grid((n + rows - 1) / rows, 2);
  const dim3 block(H, rows);
  bigru_seq_backward_kernel<H><<<grid, block, smem_bytes<H>(), stream>>>(xp, w_t, b_hh, out, grad_out, dxp, dhp,
                                                                         h_prev, n, n_pad, t_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t as int: 0 on success.
extern "C" int tpgsr_bigru_seq_backward(const float* xp, const float* w_t, const float* b_hh, const float* out,
                                        const float* grad_out, float* dxp, float* dhp, float* h_prev, int n,
                                        int n_pad, int t_len, int hidden, void* stream) {
  if (n <= 0 || t_len <= 0 || n_pad < n) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 8:
      return launch<8>(xp, w_t, b_hh, out, grad_out, dxp, dhp, h_prev, n, n_pad, t_len, s);
    case 16:
      return launch<16>(xp, w_t, b_hh, out, grad_out, dxp, dhp, h_prev, n, n_pad, t_len, s);
    case 32:
      return launch<32>(xp, w_t, b_hh, out, grad_out, dxp, dhp, h_prev, n, n_pad, t_len, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
