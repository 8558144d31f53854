"""The port's bf16 train step (TRAIN.compute_dtype 'bf16', the packaged
YAML's default) held to the JAX package's on the CPU: K1's plain bf16
recurrences, ``_as_image`` in bf16, one train step against the JAX fp32 and
bf16 steps from shared weights, and ``TextSR`` on the packaged YAML.

The JAX bf16 step is not the reference to equal: it carries the BiGRU's
state in bf16 (``bigru_fused``) where the port keeps the TPU kernel's fp32
state, and rounds at other places than autocast does.  The port is held to
be at least as close to the JAX fp32 step as the JAX bf16 step is: with
E_jax = |JAX bf16 - JAX fp32| and E_port = |port bf16 - JAX fp32|, each
quantity satisfies E_port <= 2 E_jax + a floor this file states.

Sizes are tests/test_torch_train.py's (2 SRBs, hidden 8, LR 16x32 -> HR
32x64, batch 8)."""

import contextlib
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import make_textzoom_lmdb
from tests.test_torch_kernels import bf16_ulp, gru_params, torch_params
from tests.test_torch_train import B, H, PRE_BN_BIAS, W, _crnn_sd, _port_state, _rel, _sr_sd
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.charset import CTC_NUM_CLASSES
from tpgsr_tpu.config import default_args, load_config
from tpgsr_tpu.interop.torch_import import restore_reference_checkpoint
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS
from tpgsr_tpu.models.tsrn import TSRN_TL as JaxTSRN_TL
from tpgsr_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from tpgsr_tpu.ops.pallas_gru import _bigru_pallas_impl
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import _as_image as jax_as_image
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu_torch import cli, config
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.ops import gru_seq, rnn
from tpgsr_tpu_torch.ops.grid_sample import grid_sample
from tpgsr_tpu_torch.train import trainer
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.step import _as_image, make_eval_step, make_train_step

BF16 = torch.bfloat16
# the floors of E_port <= 2 E_jax + floor: for the losses 1e-3 of the fp32
# value; for each gradient (Adam's first moment after one step is half the
# clipped gradient), each model's second moments and its BatchNorm
# statistics, a relative L2 error of 2e-2, about five bf16 roundings (2^-8
# each), so that a quantity the JAX bf16 step happens to round almost
# exactly is not held to that luck
LOSS_FLOOR = 1e-3
REL_FLOOR = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------- K1's plain versions in bf16


@pytest.mark.parametrize("n,t,c,h", [(7, 5, 6, 16), (13, 9, 16, 8)])
def test_plain_bf16_recurrences_are_fp32_on_the_rounded_inputs(n, t, c, h):
    """The bf16 plain forward and backward equal, bit for bit, the fp32 plain
    versions fed the same bf16 values (xp, out, grad_out, and W_hh, b_hh
    rounded to bf16), with out and dxp rounded to bf16 at the end; dW_hh and
    db_hh return in fp32."""
    rng = np.random.default_rng(n + t)
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32)).to(BF16)
    fw, bw = (torch_params(p) for p in gru_params(rng, c, h))
    xp = rnn.input_projection(x, fw, bw).contiguous()
    assert xp.dtype == BF16
    w_hh = torch.stack([fw["w_hh"], bw["w_hh"]])
    b_hh = torch.stack([fw["b_hh"], bw["b_hh"]])
    w_r, b_r = rnn.rounded_to(w_hh, BF16), rnn.rounded_to(b_hh, BF16)
    out = rnn.bigru_recurrence(xp, w_hh, b_hh)
    assert out.dtype == BF16
    assert torch.equal(out, rnn.bigru_recurrence(xp.float(), w_r, b_r).to(BF16))
    cot = torch.from_numpy(rng.standard_normal((n, t, 2 * h)).astype(np.float32)).to(BF16)
    got = rnn.bigru_recurrence_backward(xp, w_hh, b_hh, out, cot)
    want = rnn.bigru_recurrence_backward(xp.float(), w_r, b_r, out.float(), cot.float())
    assert [g.dtype for g in got] == [BF16, torch.float32, torch.float32]
    assert torch.equal(got[0], want[0].to(BF16))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("n,t,h", [(4, 5, 8), (6, 7, 16)])
def test_plain_bf16_recurrence_matches_the_pallas_kernel(n, t, h):
    """The port's bf16 BiGRU against the TPU kernel (``_bigru_pallas_impl``
    in interpret mode) fed the same bf16 values: both keep the state in
    fp32; the port stores out in bf16, the kernel in fp32, so they agree
    within one bf16 ulp of each output.  The input projection is the
    identity, so that both recurrences read the same xp."""
    rng = np.random.default_rng(10 * n + t)
    x = torch.from_numpy(rng.random((n, t, 3 * h), dtype=np.float32)).to(BF16)
    params = []
    for p in gru_params(rng, 3 * h, h):
        p = {k: torch.from_numpy(v).to(BF16).float().numpy() for k, v in p.items()}
        p["w_ih"], p["b_ih"] = np.eye(3 * h, dtype=np.float32), np.zeros(3 * h, np.float32)
        params.append(p)
    got = gru_seq.bigru(x, *(torch_params(p) for p in params))
    assert got.dtype == BF16
    want = _bigru_pallas_impl(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              *({k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()} for p in params),
                              interpret=True)
    assert want.dtype == jnp.float32
    want = torch.from_numpy(np.array(want))
    diff = (got.float() - want).abs()
    assert bool((diff <= bf16_ulp(want) + 1e-6).all()), float(diff.max())


def test_as_image_in_bf16_matches_jax_bit_for_bit():
    """uint8 batches are divided by 255 in fp32, then rounded to bf16; float
    batches are rounded to bf16: the JAX package's ``_as_image`` values."""
    u8 = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1).repeat(4, -1)
    f32 = np.random.default_rng(0).random((2, 8, 8, 4), dtype=np.float32)
    for arr in (u8, f32):
        got = _as_image(arr, torch.device("cpu"), dtype=BF16)
        assert got.dtype == BF16
        want = np.asarray(jax_as_image(arr, jnp.bfloat16)).astype(np.float32)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("method", ["contraction", "gather"])
def test_grid_sample_in_bf16_matches_jax_within_two_ulps(method):
    """A bf16 image at a bf16 grid, under autocast as the STN runs it: the
    port's sample is bf16 and within 2 bf16 ulps of the JAX package's bf16
    sample by either of its methods (both take the coordinates in fp32)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((2, 16, 32, 4), dtype=np.float32)).to(BF16)
    grid = torch.from_numpy(rng.uniform(-1.05, 1.05, (2, 16, 64, 2)).astype(np.float32)).to(BF16)
    with torch.autocast("cpu", dtype=BF16):
        got = grid_sample(x, grid)
    assert got.dtype == BF16
    want = torch.from_numpy(np.asarray(jax_grid_sample(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                                       jnp.asarray(grid.float().numpy(), jnp.bfloat16),
                                                       method=method)).astype(np.float32))
    diff = (got.float() - want).abs()
    assert bool((diff <= 2 * bf16_ulp(want)).all()), float(diff.max())


# ---------------------------------------------------------------- the train step against the JAX package


@functools.lru_cache(maxsize=None)
def _jax_state():
    """The JAX train state at this file's sizes (one SR model, one student),
    as tests/test_torch_train.py builds it; built once for every test here."""
    sr_model, stu_model = _jax_models()
    crnn_in = np.zeros((B, 32, W * 2, 1), np.float32)

    def build(key):
        return jax_create_train_state(
            key, sr_model,
            (np.zeros((B, H, W, 4), np.float32), np.zeros((B, 1, 26, CTC_NUM_CLASSES), np.float32)),
            n_sr=1, stu_model=stu_model, stu_example_inputs=(crnn_in,), n_stu=1,
            teacher_variables=stu_model.init(jax.random.PRNGKey(1), crnn_in, train=False))

    return jax.jit(build)(jax.random.PRNGKey(0))


def _jax_models():
    return (JaxTSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True, srb_nums=2, hidden_units=8),
            JaxCRNN(nclass=CTC_NUM_CLASSES))


def _jax_steps(args):
    """The JAX package's fp32 and bf16 train steps for ``args``."""
    sr_model, stu_model = _jax_models()
    steps = []
    for dtype in ("fp32", "bf16"):
        cfg = load_config()
        cfg.TRAIN.width, cfg.TRAIN.height, cfg.TRAIN.batch_size = W * 2, H * 2, B
        cfg.TRAIN.compute_dtype = dtype
        steps.append(jax_make_train_step("tsrn_tl_cascade", ARCHS["tsrn_tl_cascade"], sr_model, stu_model, args,
                                         cfg, donate=False))
    return steps


@pytest.fixture(scope="module")
def one_step():
    """One step of JAX fp32, JAX bf16 and the port in bf16 from the same
    weights and batch: the flagship's arguments with ``--use_label`` and two
    stages that share the SR model and the student (the second reads the
    first's bf16 SR).  The labels' CTC term gives the student a gradient
    that JAX bf16 keeps within 0.4 of JAX fp32 (relative L2), so that the
    relations below can fail for it; the distillation alone leaves the
    student's gradient to the signs of |teacher - student| where the
    student, a copy of the teacher, nearly ties with it, and bf16 flips
    them."""
    args = default_args(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, use_label=True, gradient=True,
                        stu_iter=2, sr_share=True, tpg_share=True, srb=2, hd_u=8)
    state = _jax_state()
    step32, step16 = _jax_steps(args)
    port = _port_state(state)
    rng = np.random.default_rng(2)
    lengths = rng.integers(3, 9, B).astype(np.int32)
    labels = rng.integers(1, CTC_NUM_CLASSES, (B, 15)).astype(np.int32) * (np.arange(15) < lengths[:, None])
    batch = {"hr": rng.random((B, 2 * H, 2 * W, 4), dtype=np.float32),
             "lr": rng.random((B, H, W, 4), dtype=np.float32),
             "ctc_labels": labels, "ctc_lengths": lengths, "weighted_tics": np.ones(B, np.float32)}
    state32, m32 = step32(state, batch)
    state16, m16 = step16(state, batch)
    got = make_train_step(args, width=W * 2, device="cpu", compute_dtype="bf16")(port, batch)
    return {"jax32": (state32, m32), "jax16": (state16, m16), "port": (port, got)}


def test_bf16_losses_as_close_to_fp32_as_jax_bf16(one_step):
    """For loss_img, loss_distill and loss_total (and each stage's image
    loss): E_port <= 2 E_jax + 1e-3 |JAX fp32|; the port's bf16 total within
    5 % of the fp32 one, as tests/test_train.py holds the JAX bf16 step."""
    (_, m32), (_, m16), (_, got) = one_step["jax32"], one_step["jax16"], one_step["port"]
    assert sorted(got) == sorted(m32)
    for k in got:
        ref, e_jax, e_port = float(m32[k]), abs(float(m16[k]) - float(m32[k])), abs(float(got[k]) - float(m32[k]))
        assert np.isfinite(float(got[k]))
        assert e_port <= 2 * e_jax + LOSS_FLOOR * abs(ref), (k, e_port, e_jax, ref)
    assert abs(float(got["loss_total"]) - float(m32["loss_total"])) <= 0.05 * abs(float(m32["loss_total"]))


def _model(one_step, kind):
    """(port module, JAX -> port state_dict) of the trained model ``kind``."""
    port = one_step["port"][0]
    return (port.sr[0], _sr_sd) if kind == "sr" else (port.stu[0], _crnn_sd)


def _ref(one_step, which, kind, to_sd, moment=None):
    """A JAX state's parameters (or Adam moment) of model ``kind`` as a port
    state_dict, with its BatchNorm statistics."""
    state = one_step[which][0]
    stats = (state.sr_stats if kind == "sr" else state.stu_stats)[0]
    if moment is None:
        return to_sd((state.sr_params if kind == "sr" else state.stu_params)[0], stats)
    return to_sd(getattr(state.opt_state[0], moment)[kind][0], stats)


def _cos(pairs):
    a, b = (torch.cat([t.flatten() for t in ts]) for ts in zip(*pairs))
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


@pytest.mark.parametrize("kind", ["sr", "stu"])
def test_bf16_gradients_as_close_to_fp32_as_jax_bf16(one_step, kind):
    """Each gradient but the pre-BN biases' (their exact value is zero), read
    from Adam's first moment after the step (half the clipped gradient in
    both packages), finite, with E_port <= 2 E_jax + 2e-2 on its relative L2
    error; and so the model's gradient as a whole, whose bound stays below
    1, so that a zeroed, negated or random gradient (errors 1, 2 and about
    1.4) fails it."""
    port = one_step["port"][0]
    m, to_sd = _model(one_step, kind)
    want, jax16 = (_ref(one_step, w, kind, to_sd, "mu") for w in ("jax32", "jax16"))
    tracked = []
    for n, p in m.named_parameters():
        got = port.optimizer.state[p]["exp_avg"]
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all()), n
        if PRE_BN_BIAS.search(n):
            continue
        tracked.append((n, got))
        e_jax, e_port = _rel([(jax16[n], want[n])]), _rel([(got, want[n])])
        assert e_port <= 2 * e_jax + REL_FLOOR, (kind, n, e_port, e_jax)
    e_jax, e_port = _rel([(jax16[n], want[n]) for n, _ in tracked]), _rel([(g, want[n]) for n, g in tracked])
    assert e_port <= 2 * e_jax + REL_FLOOR < 1, (kind, e_port, e_jax)


@pytest.mark.parametrize("kind", ["sr", "stu"])
def test_bf16_gradients_point_as_the_fp32_ones(one_step, kind):
    """The model's bf16 gradient (Adam's first moment, the pre-BN biases
    apart) has a cosine to JAX fp32's of at least half JAX bf16's, and the
    JAX bf16 cosine itself is above 0.9: a check that a zeroed or negated
    gradient fails whatever the relative errors allow."""
    port = one_step["port"][0]
    m, to_sd = _model(one_step, kind)
    want, jax16 = (_ref(one_step, w, kind, to_sd, "mu") for w in ("jax32", "jax16"))
    named = [(n, p) for n, p in m.named_parameters() if not PRE_BN_BIAS.search(n)]
    cos_jax = _cos([(jax16[n], want[n]) for n, _ in named])
    cos_port = _cos([(port.optimizer.state[p]["exp_avg"], want[n]) for n, p in named])
    assert cos_jax > 0.9 and cos_port >= cos_jax / 2, (kind, cos_port, cos_jax)


@pytest.mark.parametrize("kind", ["sr", "stu"])
def test_bf16_adam_and_batchnorm_as_close_to_fp32_as_jax_bf16(one_step, kind):
    """Per model, relative L2 over every parameter but the pre-BN biases:
    Adam's second moments; and over the BatchNorm running statistics, which
    stay fp32: E_port <= 2 E_jax + 2e-2."""
    port = one_step["port"][0]
    m, to_sd = _model(one_step, kind)
    named = dict(m.named_parameters())
    tracked = [n for n in named if not PRE_BN_BIAS.search(n)]
    want, jax16 = (_ref(one_step, w, kind, to_sd, "nu") for w in ("jax32", "jax16"))
    e_jax = _rel([(jax16[n], want[n]) for n in tracked])
    e_port = _rel([(port.optimizer.state[named[n]]["exp_avg_sq"], want[n]) for n in tracked])
    assert e_port <= 2 * e_jax + REL_FLOOR, (kind, "nu", e_port, e_jax)
    sd = m.state_dict()
    running = [n for n in sd if "running" in n]
    assert all(sd[n].dtype == torch.float32 for n in running)
    want, jax16 = (_ref(one_step, w, kind, to_sd) for w in ("jax32", "jax16"))
    e_jax, e_port = _rel([(jax16[n], want[n]) for n in running]), _rel([(sd[n], want[n]) for n in running])
    assert e_port <= 2 * e_jax + REL_FLOOR, (kind, "batch_stats", e_port, e_jax)


# ---------------------------------------------------------------- TextSR on the packaged YAML


FLAGS = ["--arch", "tsrn_tl_cascade", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
         "--stu_iter=1", "--srb", "2", "--hd_u", "8", "--batch_size", str(B)]


@contextlib.contextmanager
def _in_dir(path):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(path)
        yield


def _packaged_yaml(root, db, teacher_path, ckpt_dir, epochs):
    """The packaged YAML as it is (bf16), with the data, the tiny geometry
    and the intervals of this file: 2 iterations an epoch, val and save at
    each epoch's end."""
    cfg = config.load_config()
    assert cfg.TRAIN.compute_dtype == "bf16"
    t = cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [db], [db]
    t.width, t.height, t.epochs, t.workers = 2 * W, 2 * H, epochs, 0
    t.VAL.valInterval, t.saveInterval, t.displayInterval = 2, 2, 2
    t.VAL.crnn_pretrained, t.ckpt_dir = teacher_path, str(ckpt_dir)
    path = root / f"{ckpt_dir.name}.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    return str(path)


@pytest.fixture(scope="module")
def packaged(tmp_path_factory):
    root = tmp_path_factory.mktemp("packaged")
    teacher_path = str(root / "crnn.pth")
    torch.save(init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), torch.Generator().manual_seed(7)).state_dict(),
               teacher_path)
    return root, make_textzoom_lmdb(str(root / "tz"), n=16), teacher_path


def _train(packaged, name, epochs, *extra):
    """``cli.main`` on the packaged YAML for ``epochs``: (state, each step's
    losses, each val's metric dicts)."""
    root, db, teacher_path = packaged
    argv = FLAGS + ["--config", _packaged_yaml(root, db, teacher_path, root / name, epochs), "--vis_dir", "run",
                    *extra]
    losses, vals = [], []
    make, run_val = trainer.make_train_step, trainer.TextSR._run_val

    def recorded_make(*a, **k):
        assert k["compute_dtype"] == "bf16"
        step = make(*a, **k)

        def recorded(state, batch):
            metrics = step(state, batch)
            losses.append({k2: float(v) for k2, v in metrics.items()})
            return metrics

        return recorded

    def recorded_val(mission, *a, **k):
        out = run_val(mission, *a, **k)
        vals.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp, _in_dir(root):
        mp.setattr(trainer, "make_train_step", recorded_make)
        mp.setattr(trainer.TextSR, "_run_val", recorded_val)
        state = cli.main(argv, device="cpu")
    return state, losses, vals


def test_textsr_trains_the_packaged_yaml_in_bf16(packaged):
    """The flagship's flags with the packaged YAML (bf16) train 2 iterations
    on the CPU with finite losses.  The val runs the fp32 eval step: its
    metric dict equals the fp32 eval step's on the weights it read.  The
    checkpoint holds fp32 tensors in the original's layout, which the JAX
    package's ``restore_reference_checkpoint`` reads."""
    root, db, _ = packaged
    state, losses, vals = _train(packaged, "one", 1)
    assert state.step == 2 and len(losses) == 2 and len(vals) == 1
    assert all(np.isfinite(v) for m in losses for v in m.values())
    args = config.AttrDict(vars(config.build_arg_parser().parse_args(FLAGS)))
    (loader,) = trainer.val_loaders([db], "tsrn_tl_cascade", mask=True, batch_size=B, height=2 * H, width=2 * W,
                                    workers=0, device="cpu")
    models = trainer.TextSR._eval_models(state)
    assert evaluate(make_eval_step(args, 2 * W, device="cpu"), models, loader) == vals[0]["tz"]

    path = root / "one" / "run" / "checkpoint_0.pth"
    sd = torch.load(path, weights_only=True)["state_dict_G"]
    assert sd.keys() == state.sr[0].state_dict().keys()
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    restored = restore_reference_checkpoint(str(path), _jax_state(), "tsrn_tl_cascade", srb_nums=2)
    got = _sr_sd(restored.sr_params[0], restored.sr_stats[0])
    for k, v in state.sr[0].state_dict().items():
        if v.is_floating_point():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_bf16_resume_equals_an_uninterrupted_run(packaged):
    """Two epochs in one run equal, bit for bit on the CPU, one epoch, a
    save, then ``--resume`` for one more: every loss, weight and BatchNorm
    statistic (Adam's state, the step and the fp32 weights come back from the
    files)."""
    root = packaged[0]
    whole, whole_losses, _ = _train(packaged, "whole", 2)
    _, first, _ = _train(packaged, "halves", 1)
    resumed, second, _ = _train(packaged, "halves", 1, "--resume", str(root / "halves" / "run"))
    assert len(whole_losses) == 4 and first + second == whole_losses
    assert whole.step == resumed.step == 4
    for a, b in zip((*whole.sr, *whole.stu), (*resumed.sr, *resumed.stu)):
        want = a.state_dict()
        for k, v in b.state_dict().items():
            assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------- at the flagship's width, by hand


def flagship_comparison(batch_size: int = 8, seed: int = 3) -> dict:
    """One train step of the flagship (TSRN_TL at 5 SRBs, hidden 32, LR
    16x64; ``train_TPGSR-TSRN.sh``'s flags) on the CPU from shared weights
    and batch: the JAX package in fp32 and in bf16, the port in bf16.  For
    the SR model and the student, the cosine and the relative L2 error of
    each bf16 gradient (Adam's first moment; the pre-BN biases apart)
    against JAX fp32's, and the losses.  A few minutes of JIT compilation;
    run it as ``python -m tests.test_torch_bf16``."""
    import re

    from tpgsr_tpu_torch.models.tsrn import TSRN_TL
    from tpgsr_tpu_torch.train.state import create_train_state

    pre_bn_bias = re.compile(r"(block\d+\.conv[12]|block7\.0|stn_convnet\.\d+\.0|stn_fc1\.0|cnn\.conv[246])\.bias$")
    h, w = 16, 64
    args = default_args(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True, stu_iter=1,
                        sr_share=True)
    sr_model = JaxTSRN_TL(scale_factor=2, width=2 * w, height=2 * h, stn=True, mask=True, srb_nums=5, hidden_units=32)
    stu_model = JaxCRNN(nclass=CTC_NUM_CLASSES)
    crnn_in = np.zeros((batch_size, 32, 100, 1), np.float32)

    def build(key):
        return jax_create_train_state(
            key, sr_model, (np.zeros((batch_size, h, w, 4), np.float32),
                            np.zeros((batch_size, 1, 26, CTC_NUM_CLASSES), np.float32)),
            n_sr=1, stu_model=stu_model, stu_example_inputs=(crnn_in,), n_stu=1,
            teacher_variables=stu_model.init(jax.random.PRNGKey(1), crnn_in, train=False))

    state = jax.jit(build)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    batch = {"hr": rng.random((batch_size, 2 * h, 2 * w, 4), dtype=np.float32),
             "lr": rng.random((batch_size, h, w, 4), dtype=np.float32)}
    out, mus = {}, {}
    for dtype in ("fp32", "bf16"):
        cfg = load_config()
        cfg.TRAIN.batch_size, cfg.TRAIN.compute_dtype = batch_size, dtype
        step = jax_make_train_step("tsrn_tl_cascade", ARCHS["tsrn_tl_cascade"], sr_model, stu_model, args, cfg,
                                   donate=False)
        new, metrics = step(state, batch)
        out[f"jax_{dtype}_losses"] = {k: float(v) for k, v in metrics.items()}
        mus[f"jax_{dtype}"] = new.opt_state[0].mu

    def variables(params, stats):
        return jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})

    sr = TSRN_TL(scale_factor=2, width=2 * w, height=2 * h, stn=True, mask=True, srb_nums=5, hidden_units=32)
    sr.load_state_dict(from_jax.tsrn_tl_state_dict(variables(state.sr_params[0], state.sr_stats[0]), srb_nums=5))
    teacher = CRNN(nclass=CTC_NUM_CLASSES)
    teacher.load_state_dict(from_jax.crnn_state_dict(variables(state.teacher_params, state.teacher_stats)))
    port = create_train_state([sr], teacher, n_stu=1)
    out["port_bf16_losses"] = {k: float(v) for k, v in
                               make_train_step(args, 128, device="cpu", compute_dtype="bf16")(port, batch).items()}
    for kind, model, to_sd, stats in (
            ("sr", port.sr[0], functools.partial(from_jax.tsrn_tl_state_dict, srb_nums=5), state.sr_stats[0]),
            ("stu", port.stu[0], from_jax.crnn_state_dict, state.stu_stats[0])):
        sds = {name: to_sd(variables(mus[name][kind][0], stats)) for name in ("jax_fp32", "jax_bf16")}
        named = dict(model.named_parameters())
        keys = [n for n in named if not pre_bn_bias.search(n)]
        want = torch.cat([sds["jax_fp32"][n].flatten() for n in keys])
        for name, got in (("jax_bf16", torch.cat([sds["jax_bf16"][n].flatten() for n in keys])),
                          ("port_bf16", torch.cat([port.optimizer.state[named[n]]["exp_avg"].flatten()
                                                   for n in keys]))):
            out[f"{kind}_{name}"] = {"cos_vs_jax_fp32": float(torch.nn.functional.cosine_similarity(got, want, dim=0)),
                                     "rel_err_vs_jax_fp32": float((got - want).norm() / want.norm())}
    return out


if __name__ == "__main__":
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    print(json.dumps(flagship_comparison()))
