"""The train slice of the port held to the JAX package on the CPU: the
gradient map and the losses, ``grid_sample``, the STN head and TPS, K1's plain
backward, the SR clip, and the whole train step over 3 steps.

Inputs come from numpy seeds; weights cross through
``tpgsr_tpu_torch.interop.from_jax``.  Tolerances are fp32 noise unless a
test states otherwise."""

import re

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tpgsr_tpu import losses as jax_losses
from tpgsr_tpu.charset import CTC_NUM_CLASSES
from tpgsr_tpu.config import default_args, load_config
from tpgsr_tpu.models import stn as jax_stn
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS
from tpgsr_tpu.models.tsrn import TSRN_TL as JaxTSRN_TL
from tpgsr_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from tpgsr_tpu.ops import image as jax_image
from tpgsr_tpu.ops.rnn import bigru_fused
from tpgsr_tpu.train.state import clip_sr_grads as jax_clip_sr_grads
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import _as_image as jax_as_image
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu_torch import losses
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.stn import STNHead, TPSSpatialTransformer
from tpgsr_tpu_torch.models.tsrn import TSRN_TL
from tpgsr_tpu_torch.ops import gru_seq, image, rnn
from tpgsr_tpu_torch.ops.grid_sample import grid_sample
from tpgsr_tpu_torch.train.state import clip_sr_grads, create_train_state
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.train.step import EvalModels, _as_image, make_eval_step, make_train_step
from tests.test_torch_kernels import GRU_CASES, gru_params, torch_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, unfreeze(variables))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _images(seed, shape=(3, 16, 24, 4)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    return a, np.clip(a + 0.1 * rng.standard_normal(shape).astype(np.float32), 0, 1)


def test_gradient_map_matches_jax():
    a, _ = _images(0)
    np.testing.assert_allclose(image.gradient_map(_t(a)).numpy(), np.asarray(jax_image.gradient_map(a)), atol=1e-6)


@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "gradient_prior_loss", "image_loss", "image_loss_no_gradient"])
def test_image_losses_match_jax(name):
    a, b = _images(1)
    kwargs = {"gradient": False} if name == "image_loss_no_gradient" else {}
    fn = name.replace("_no_gradient", "")
    got = getattr(losses, fn)(_t(a), _t(b), **kwargs)
    np.testing.assert_allclose(float(got), float(getattr(jax_losses, fn)(a, b, **kwargs)), rtol=1e-5)


def test_semantic_loss_matches_jax():
    rng = np.random.default_rng(2)
    pred = jax.nn.softmax(rng.standard_normal((26, 4, 37)).astype(np.float32), -1)
    gt = jax.nn.softmax(3 * rng.standard_normal((26, 4, 37)).astype(np.float32), -1)
    pred, gt = np.asarray(pred), np.asarray(gt)
    np.testing.assert_allclose(float(losses.semantic_loss(_t(pred), _t(gt))),
                               float(jax_losses.semantic_loss(pred, gt)), rtol=1e-5)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("method", ["contraction", "gather"])
def test_grid_sample_matches_jax(method, padding, align):
    """Output and the gradients with respect to the image and the grid, on a
    grid that reaches past [-1, 1] so that both padding modes act."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 6, 9, 3), dtype=np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)
    cot = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)

    def jax_fn(x_, g_):
        return jax_grid_sample(x_, g_, align_corners=align, padding_mode=padding, method=method)

    ref, vjp = jax.vjp(jax_fn, x, grid)
    ref_dx, ref_dgrid = vjp(cot)
    tx, tg = _t(x).requires_grad_(True), _t(grid).requires_grad_(True)
    got = grid_sample(tx, tg, align_corners=align, padding_mode=padding)
    got.backward(_t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx), atol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(ref_dgrid), atol=1e-4)


def _random_stats(v, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, val in node.items():
            if isinstance(val, dict):
                walk(val)
            elif k == "mean":
                node[k] = (0.1 * rng.standard_normal(val.shape)).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)

    walk(v.get("batch_stats", {}))
    return v


def test_stn_head_and_tps_match_flax_in_train_mode():
    """STNHead in train mode (output, control points and the updated batch
    statistics) and the TPS warp, at the tiny LR 16x32 (fc1 reads 256
    features there).  fc2's weights are drawn at random so that the control
    points depend on the image.  Features at 1e-4: six conv-BN layers and a
    BatchNorm1d over a batch of 4, all normalising by batch statistics,
    amplify the reordered fp32 sums."""
    rng = np.random.default_rng(4)
    x = rng.random((4, 16, 32, 4), dtype=np.float32)
    head = jax_stn.STNHead()
    v = _random_stats(_numpy_tree(head.init(jax.random.PRNGKey(4), x, train=True)), 4)
    v["params"]["fc2_kernel"] = (0.05 * rng.standard_normal(v["params"]["fc2_kernel"].shape)).astype(np.float32)
    (ref_feat, ref_pts), mut = head.apply(v, x, train=True, mutable=["batch_stats"])
    sd = {}
    from_jax._stn_head(sd, v["params"], v["batch_stats"], "h")
    port = STNHead(4, input_size=(16, 32))
    port.load_state_dict({k[2:]: t for k, t in sd.items()})
    port.train()
    feat, pts = port(_t(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(ref_feat), atol=1e-4)
    np.testing.assert_allclose(pts.detach().numpy(), np.asarray(ref_pts), atol=1e-5)
    new = {}
    from_jax._stn_head(new, v["params"], _numpy_tree(mut)["batch_stats"], "h")
    for k, t in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), new["h." + k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)

    tps = TPSSpatialTransformer((16, 32))
    ref_tps = jax_stn.TPSSpatialTransformer((16, 32))
    np.testing.assert_allclose(tps.inverse_kernel.numpy(), ref_tps.inverse_kernel, atol=0)
    ctrl = np.asarray(ref_pts)
    ref_out, ref_src = ref_tps(x, ctrl)
    out, src = tps(_t(x.transpose(0, 3, 1, 2)), _t(ctrl))
    # the source coordinates are sums of 23 products with the inverse
    # kernel's large entries (2e-5); the sampler turns a coordinate error into
    # error x W / 2 pixels of a random image (5e-4)
    np.testing.assert_allclose(src.numpy(), np.asarray(ref_src), atol=2e-5)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref_out), atol=5e-4)


def _vjp_case(n, t, c, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, t, c), dtype=np.float32)
    fw, bw = gru_params(rng, c, h)
    cot = rng.standard_normal((n, t, 2 * h)).astype(np.float32)
    return x, fw, bw, cot


@pytest.mark.parametrize("n,t,c,h", GRU_CASES)
def test_bigru_backward_plain_matches_autograd_and_jax(n, t, c, h):
    """``rnn.bigru_recurrence_backward`` against torch autograd through
    ``bigru_recurrence`` and against ``jax.vjp`` of ``bigru_fused``, for the
    input projection and the recurrent weights, at 1e-5 (the forward's),
    relative as well for the biases' sums over N * T steps."""
    x, fw, bw, cot = _vjp_case(n, t, c, h, n + t)
    fw_t, bw_t = torch_params(fw), torch_params(bw)
    xp = rnn.input_projection(_t(x), fw_t, bw_t).contiguous()
    w_hh = torch.stack([fw_t["w_hh"], bw_t["w_hh"]]).requires_grad_(True)
    b_hh = torch.stack([fw_t["b_hh"], bw_t["b_hh"]]).requires_grad_(True)
    xp_leaf = xp.clone().requires_grad_(True)
    out = rnn.bigru_recurrence(xp_leaf, w_hh, b_hh)
    out.backward(_t(cot))
    dxp, dw_hh, db_hh = rnn.bigru_recurrence_backward(xp, w_hh.detach(), b_hh.detach(), out.detach(), _t(cot))
    for got, want in ((dxp, xp_leaf.grad), (dw_hh, w_hh.grad), (db_hh, b_hh.grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)

    _, vjp = jax.vjp(lambda fw_, bw_: bigru_fused(x, fw_, bw_), fw, bw)
    ref_fw, ref_bw = vjp(cot)
    # chain the plain backward through the projection by autograd: the
    # wrapper's CPU path
    fw_l = {k: v.clone().requires_grad_(True) for k, v in fw_t.items()}
    bw_l = {k: v.clone().requires_grad_(True) for k, v in bw_t.items()}
    gru_seq.bigru(_t(x), fw_l, bw_l).backward(_t(cot))
    for ours, ref in ((fw_l, ref_fw), (bw_l, ref_bw)):
        for k in ours:
            np.testing.assert_allclose(ours[k].grad.numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n,t", [(9, 7), (256, 8)])
def test_recurrent_weight_grads_match_plain(n, t):
    """The CUDA path's dW_hh / db_hh (a batched GEMM over chunks of rows of
    the kernel's dhp and h_{t-1}, then sums) against the plain loop's sums;
    dhp and h_{t-1} are rebuilt here from the plain dxp, ``out`` and the
    recomputed r gate.  (256, 8) splits into chunks of rows, (9, 7) takes
    one."""
    x, fw, bw, cot = _vjp_case(n, t, 8, 8, 5)
    fw_t, bw_t = torch_params(fw), torch_params(bw)
    xp = rnn.input_projection(_t(x), fw_t, bw_t).contiguous()
    w_hh = torch.stack([fw_t["w_hh"], bw_t["w_hh"]])
    b_hh = torch.stack([fw_t["b_hh"], bw_t["b_hh"]])
    out = rnn.bigru_recurrence(xp, w_hh, b_hh)
    dxp, dw_hh, db_hh = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, _t(cot))
    h = 8
    h_prev = torch.stack([torch.nn.functional.pad(out[:, :-1, :h], (0, 0, 1, 0)),
                          torch.nn.functional.pad(out[:, 1:, h:], (0, 0, 0, 1))])  # [2, N, T, H]
    dhp = []
    for d in range(2):
        r = torch.sigmoid(xp[..., 3 * h * d : 3 * h * d + h] + h_prev[d] @ w_hh[d, :h].t() + b_hh[d, :h])
        dx = dxp[..., 3 * h * d : 3 * h * (d + 1)]
        dhp.append(torch.cat([dx[..., : 2 * h], dx[..., 2 * h :] * r], -1))
    got_w, got_b = gru_seq.recurrent_weight_grads(torch.stack(dhp), h_prev)
    torch.testing.assert_close(got_w, dw_hh, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_b, db_hh, rtol=1e-5, atol=1e-5)


def test_bigru_wrapper_cpu_backward_takes_plain_version():
    """On CPU tensors the wrapper's autograd runs the plain backward and
    launches nothing; its gradients equal autograd through ``rnn.bigru``."""
    x, fw, bw, cot = _vjp_case(6, 5, 8, 8, 6)
    grads = []
    for fn in (gru_seq.bigru, rnn.bigru):
        xt = _t(x).requires_grad_(True)
        fw_l = {k: v.requires_grad_(True) for k, v in torch_params(fw).items()}
        bw_l = {k: v.requires_grad_(True) for k, v in torch_params(bw).items()}
        before = gru_seq.BACKWARD_LAUNCHES
        fn(xt, fw_l, bw_l).backward(_t(cot))
        assert gru_seq.BACKWARD_LAUNCHES == before
        grads.append([xt.grad] + [d[k].grad for d in (fw_l, bw_l) for k in sorted(d)])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_clip_sr_grads_matches_jax():
    """Each SR model clipped at global norm 0.25 (one above the clip, one
    below); the students untouched."""
    rng = np.random.default_rng(7)
    models = [torch.nn.Linear(4, 3), torch.nn.Linear(5, 2)]
    grads = []
    for m, scale in zip(models, (10.0, 0.01)):
        g = {k: (scale * rng.standard_normal(tuple(p.shape))).astype(np.float32) for k, p in m.named_parameters()}
        for k, p in m.named_parameters():
            p.grad = _t(g[k].copy())
        grads.append(g)
    clip_sr_grads(models)
    ref = jax_clip_sr_grads({"sr": tuple(grads), "stu": ()})
    for m, r in zip(models, ref["sr"]):
        for k, p in m.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(r[k]), rtol=1e-6)


B, H, W = 8, 16, 32  # tests/test_train.py's tiny geometry: LR 16x32 -> HR 32x64
LR = 1e-3
# conv biases that a BatchNorm follows in train mode: their gradient is zero
# in exact arithmetic, so each framework's is rounding noise
PRE_BN_BIAS = re.compile(r"(block\d+\.conv[12]|block4\.0|stn_convnet\.\d+\.0|stn_fc1\.0|cnn\.conv[246])\.bias$")
# per step: the losses' rtol (the JAX package's own whole-run bounds,
# tests/test_reference_whole_run.py:536-538, with 2e-3 at step 3 where two
# stages share one student), and the model-level relative errors of Adam's
# moments (averages of the clipped gradients) and of the BN statistics
LOSS_RTOL = (5e-6, 1e-4, 2e-3)
MOMENT_RTOL = (5e-3, 5e-2, 1e-1)
STATS_RTOL = (1e-5, 2e-3, 1e-2)


def _jax_setup(stu_iter, sr_share, tpg_share):
    args = default_args(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True,
                        stu_iter=stu_iter, sr_share=sr_share, tpg_share=tpg_share, srb=2, hd_u=8)
    config = load_config()
    config.TRAIN.width, config.TRAIN.height = W * 2, H * 2
    config.TRAIN.batch_size = B
    config.TRAIN.compute_dtype = "fp32"
    sr_model = JaxTSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True, srb_nums=2,
                          hidden_units=8)
    stu_model = JaxCRNN(nclass=CTC_NUM_CLASSES)
    crnn_in = np.zeros((B, 32, W * 2, 1), np.float32)

    def build(key):  # jitted: the op-by-op init alone takes ~30 s on the CPU
        return jax_create_train_state(
            key, sr_model,
            (np.zeros((B, H, W, 4), np.float32), np.zeros((B, 1, 26, CTC_NUM_CLASSES), np.float32)),
            n_sr=1 if sr_share else stu_iter, stu_model=stu_model, stu_example_inputs=(crnn_in,),
            n_stu=1 if tpg_share else stu_iter,
            teacher_variables=stu_model.init(jax.random.PRNGKey(1), crnn_in, train=False))

    state = jax.jit(build)(jax.random.PRNGKey(0))
    step = jax_make_train_step("tsrn_tl_cascade", ARCHS["tsrn_tl_cascade"], sr_model, stu_model, args, config,
                               donate=False)
    return args, state, step


def _vars(params, stats):
    return _numpy_tree({"params": params, "batch_stats": stats})


def _sr_sd(params, stats):
    return from_jax.tsrn_tl_state_dict(_vars(params, stats), srb_nums=2)


def _crnn_sd(params, stats):
    return from_jax.crnn_state_dict(_vars(params, stats))


def _port_state(state):
    def tsrn(p, s):
        m = TSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True, srb_nums=2, hidden_units=8)
        m.load_state_dict(_sr_sd(p, s))
        return m

    teacher = CRNN(nclass=CTC_NUM_CLASSES)
    teacher.load_state_dict(_crnn_sd(state.teacher_params, state.teacher_stats))
    return create_train_state([tsrn(p, s) for p, s in zip(state.sr_params, state.sr_stats)], teacher,
                              n_stu=len(state.stu_params))


def _rel(pairs):
    num = sum(float((a - b).pow(2).sum()) for a, b in pairs)
    den = sum(float(b.pow(2).sum()) for _, b in pairs)
    return (num / max(den, 1e-30)) ** 0.5


@pytest.mark.parametrize("stu_iter,sr_share,tpg_share", [(1, True, False), (2, False, True)])
def test_train_step_matches_jax(stu_iter, sr_share, tpg_share):
    """Three fp32 steps from shared weights on the same batches: the flagship
    arguments, and two stages with shared students.  After each step:

    * every metric, at rtol 5e-6, 1e-4, 2e-3 (the JAX package's bounds for
      its own whole-run parity, the last doubled: later steps inherit Adam's
      amplification);
    * Adam's first and second moments, which average the clipped gradients,
      per model (relative L2 over every parameter but the pre-BN biases):
      5e-3 after the first step, where they are the gradients themselves,
      then 5e-2 and 1e-1;
    * every BatchNorm statistic, per model (relative L2): 1e-5, 2e-3, 1e-2;
    * every parameter element within Adam's reach of the JAX one: 2.5 lr a
      step.  Adam's first update is lr * g / (|g| + eps), about +-lr wherever
      g is not tiny, so a gradient near zero whose sign differs between the
      two frameworks' roundings moves the two copies 2 lr apart; the pre-BN
      biases (gradient zero in exact arithmetic) do so by design.
    * After the first step the update of every parameter but the pre-BN
      biases, per model, within 5 % (relative L2) of the JAX update.
    """
    args, state, jax_step = _jax_setup(stu_iter, sr_share, tpg_share)
    port = _port_state(state)
    step = make_train_step(args, width=W * 2, device="cpu")
    init = [{k: t.clone() for k, t in m.state_dict().items()} for m in (*port.sr, *port.stu)]
    rng = np.random.default_rng(stu_iter)
    for k in range(3):
        batch = {"hr": rng.random((B, 2 * H, 2 * W, 4), dtype=np.float32),
                 "lr": rng.random((B, H, W, 4), dtype=np.float32)}
        state, ref = jax_step(state, batch)
        got = step(port, batch)
        assert sorted(got) == sorted(ref)
        for name in got:
            np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=LOSS_RTOL[k], err_msg=name)
        adam = state.opt_state[0]
        models = [("sr", i, m, _sr_sd) for i, m in enumerate(port.sr)] + \
                 [("stu", i, m, _crnn_sd) for i, m in enumerate(port.stu)]
        for j, (kind, i, m, to_sd) in enumerate(models):
            stats = (state.sr_stats if kind == "sr" else state.stu_stats)[i]
            params = (state.sr_params if kind == "sr" else state.stu_params)[i]
            ref_sd = to_sd(params, stats)
            sd = m.state_dict()
            named = dict(m.named_parameters())
            tracked = [n for n in named if not PRE_BN_BIAS.search(n)]
            for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                ref_m = to_sd(getattr(adam, moment)[kind][i], stats)
                err = _rel([(port.optimizer.state[named[n]][key], ref_m[n]) for n in tracked])
                assert err <= MOMENT_RTOL[k], (kind, i, k, moment, err)
            running = [n for n in sd if "running" in n]
            assert _rel([(sd[n], ref_sd[n]) for n in running]) <= STATS_RTOL[k], (kind, i, k)
            for n in named:
                reach = float((sd[n] - ref_sd[n]).abs().max())
                assert reach <= 2.5 * LR * (k + 1), (kind, i, k, n, reach)
            if k == 0:
                err = _rel([(sd[n] - init[j][n], ref_sd[n] - init[j][n]) for n in tracked])
                assert err <= 0.05, (kind, i, err)
    assert port.step == 3


def test_train_step_rejects_what_is_not_ported():
    """The archs not ported raise; ``--ssim_loss`` (tests/test_torch_tl_simple.py)
    and ``--use_label`` (tests/test_torch_data.py) are ported."""
    for arch in ("tsrn_c2f", "sem_tsrn"):
        with pytest.raises(NotImplementedError, match=arch):
            make_train_step({"arch": arch, "stu_iter": 1}, device="cpu")
    make_train_step({"stu_iter": 1, "ssim_loss": True}, device="cpu")
    make_train_step({"stu_iter": 1, "use_label": True}, device="cpu")


def test_as_image_matches_jax_on_a_uint8_batch():
    """Every uint8 value becomes the JAX package's fp32 value exactly (x / 255
    in fp32); a float batch is only cast."""
    u8 = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1).repeat(4, -1)
    got = _as_image(u8, torch.device("cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_as_image(u8, np.float32)))
    f64 = u8.astype(np.float64) / 255.0
    np.testing.assert_array_equal(_as_image(f64, torch.device("cpu")).numpy(), f64.astype(np.float32))


def _tiny_models(seed):
    """TSRN_TL (2 SRBs, hidden 8, LR 16x32) and two CRNNs, seeded."""
    gen = torch.Generator().manual_seed(seed)
    sr = TSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True, srb_nums=2, hidden_units=8)
    return [init_torch_defaults_(m, gen) for m in (sr, CRNN(nclass=CTC_NUM_CLASSES), CRNN(nclass=CTC_NUM_CLASSES))]


def _u8_batch(seed, n=2):
    rng = np.random.default_rng(seed)
    u8 = {"hr": rng.integers(0, 256, (n, 2 * H, 2 * W, 4), dtype=np.uint8),
          "lr": rng.integers(0, 256, (n, H, W, 4), dtype=np.uint8)}
    return u8, {k: v.astype(np.float32) / np.float32(255) for k, v in u8.items()}


def test_eval_step_takes_a_uint8_batch_as_float_over_255():
    """The same SR, MSE, SSIM and logits from the uint8 batch as from the
    same batch in float / 255."""
    sr, stu, teacher = _tiny_models(8)
    models = EvalModels(sr=[sr], stu=[stu], teacher=teacher).eval()
    step = make_eval_step({"stu_iter": 1, "sr_share": True}, width=W * 2, device="cpu")
    u8, f32 = _u8_batch(8)
    sr_u8, outs_u8 = step(models, u8)
    sr_f, outs_f = step(models, f32)
    torch.testing.assert_close(sr_u8, sr_f, rtol=0, atol=0)
    assert sorted(outs_u8) == sorted(outs_f)
    for k in outs_f:
        torch.testing.assert_close(outs_u8[k], outs_f[k], rtol=0, atol=0, msg=k)


def test_train_step_takes_a_uint8_batch_as_float_over_255():
    """One train step from the same weights: the same losses from the uint8
    batch as from the float / 255 one."""
    metrics = []
    u8, f32 = _u8_batch(9, n=4)
    for batch in (u8, f32):
        sr, _, teacher = _tiny_models(9)
        state = create_train_state([sr], teacher, n_stu=1)
        step = make_train_step({"stu_iter": 1, "sr_share": True, "use_distill": True, "gradient": True},
                               width=W * 2, device="cpu")
        metrics.append({k: float(v) for k, v in step(state, batch).items()})
    assert metrics[0] == metrics[1]


@pytest.mark.parametrize("factory", [make_eval_step, make_train_step])
@pytest.mark.parametrize("arch,error", [("tsrn_c2f", NotImplementedError), ("sem_tsrn", NotImplementedError),
                                        ("no_such_arch", ValueError)], ids=["tsrn_c2f", "sem_tsrn", "unknown"])
def test_step_factories_raise_for_an_arch_not_ported(factory, arch, error):
    """The cascade, one-student and plain branches are ported for every arch
    of the JAX package but ``tsrn_c2f`` and ``sem_tsrn`` (their own branches
    and collates), which raise naming themselves; a name the JAX package
    lacks too raises ``ValueError``."""
    with pytest.raises(error, match=arch):
        factory({"arch": arch, "stu_iter": 1}, device="cpu")
    for ported in ("tsrn_tl_cascade", "tsrn_tl_wmask", "vdsr"):
        factory({"arch": ported, "stu_iter": 1}, device="cpu")
