"""The port's data parallelism held on the CPU, two gloo ranks spawned by
``tpgsr_tpu_torch.parallel.spawn`` (one thread each, every group under a
120 s limit): the global BatchNorm against ``nn.BatchNorm2d``/``1d`` over
the whole batch, the train sampler's shards against the JAX loader's, the
reduced flagship's train step on two ranks against the JAX package's step
on the conftest's 8-device mesh and against the port's one-process step,
``evaluate`` on two ranks against one process, and the launcher's
failure path.  The ranks run ``tests/torch_parallel.py``."""

import jax
import numpy as np
import pytest
import torch

from tests import torch_parallel as tp
from tests.test_torch_train import LR, MOMENT_RTOL, PRE_BN_BIAS, STATS_RTOL, LOSS_RTOL, _rel
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.config import default_args as jax_default_args
from tpgsr_tpu.config import load_config as jax_load_config
from tpgsr_tpu.data.loader import DataLoader as JaxDataLoader
from tpgsr_tpu.interop import torch_import as ti
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS
from tpgsr_tpu.models.tsrn import TSRN_TL as JaxTSRN_TL
from tpgsr_tpu.parallel import data_mesh, shard_batch, shard_params
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu_torch import parallel
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.data.loader import EpochBatchSampler
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.lapsrn import LapSRN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.ops import gru_seq
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.state import create_train_state
from tpgsr_tpu_torch.train.step import make_eval_step, make_train_step

WORLD = 2
GROUP_TIMEOUT_S = 120
EVAL_SEED = 4
B = 8  # the global batch
H, W = tp.H, tp.W
# the parameters' gradients sum a product over every row and pixel; against
# fp64, torch's fp32 BatchNorm lands 7e-8 of the gradient's largest entry
# away and the global one 1.2e-7: held at 5e-7 of it
PARAM_GRAD_RTOL = 5e-7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _spawn(fn, *args):
    return parallel.spawn(WORLD, fn, *args, device="cpu", timeout=GROUP_TIMEOUT_S)


# -------------------------------------------------------------- BatchNorm
def _bn_inputs(seed):
    rng = np.random.default_rng(seed)
    bf16 = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731  (values bf16 holds exactly)
    x4 = (3 * rng.standard_normal((B, 6, 5, 7)) + 1).astype(np.float32)
    x2 = (2 * rng.standard_normal((B, 12)) - 1).astype(np.float32)
    cases = {"fp32": (x4, rng.standard_normal(x4.shape).astype(np.float32), "float32"),
             "bf16": (bf16(x4), bf16(rng.standard_normal(x4.shape).astype(np.float32)), "bfloat16"),
             "fp32_1d": (x2, rng.standard_normal(x2.shape).astype(np.float32), "float32")}
    return cases


@pytest.fixture(scope="module")
def runs():
    """One group of two ranks for the BatchNorm cases, the train step and
    ``evaluate`` (``tp.suite``), and the inputs each test compares with."""
    bn = _bn_inputs(0)
    sr_sd, teacher_sd, sr_vars, teacher_vars = _weights(5)
    batch = _batch(6)
    eval_batches = _eval_batches()
    lapsrn_sd = {k: v.numpy() for k, v in init_torch_defaults_(
        LapSRN(2, 3, False, W * 2, H * 2), torch.Generator().manual_seed(8)).state_dict().items()}
    got = _spawn(tp.suite, [(k, *v) for k, v in bn.items()], sr_sd, teacher_sd, batch, EVAL_SEED, eval_batches,
                 lapsrn_sd)
    return {"bn": bn, "got": got, "sd": (sr_sd, teacher_sd), "jax": (sr_vars, teacher_vars), "batch": batch,
            "eval_batches": eval_batches, "lapsrn_sd": lapsrn_sd}


def _reference_bn(x, cot, bf16):
    """``nn.BatchNorm1d``/``2d`` over the whole batch as ``tp.batchnorm_case``
    sets it up; under the bf16 rule its input is the bf16 values in fp32 and
    its output is rounded to bf16, as the global one computes."""
    c = x.shape[1]
    bn = (torch.nn.BatchNorm2d if x.ndim == 4 else torch.nn.BatchNorm1d)(c)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
        bn.running_mean.fill_(0.1)
        bn.running_var.fill_(2.0)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    if bf16:
        y = y.bfloat16()
    (y.float() * torch.from_numpy(cot)).sum().backward()
    return bn, y.detach().float().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("case", ["fp32", "bf16", "fp32_1d"])
def test_global_batchnorm_matches_batchnorm_over_the_whole_batch(runs, case):
    """Two ranks of four rows against one ``nn.BatchNorm`` of eight: the
    output and the input's gradient (of sum(y * cot), each rank its rows) at
    atol 1e-6; the parameters' gradients, averaged over the ranks, equal
    that loss's over the whole batch divided by the world (the global loss
    is the ranks' mean), at 5e-7 of their largest entry; running mean and
    var (Bessel's factor of the global count) at 1e-6, the count 1.  Under
    the bf16 rule (a bf16 input, statistics and normalization in fp32, the
    output rounded to bf16) output and input gradient within one bf16 ulp."""
    x, cot, dtype = runs["bn"][case]
    got = runs["got"]["batchnorm"][case]
    bn, y, x_grad = _reference_bn(x, cot, bf16=dtype == "bfloat16")
    assert got["dtype"] == f"torch.{dtype}"
    if dtype == "bfloat16":
        np.testing.assert_allclose(got["y"], y, rtol=2 ** -7, atol=1e-6)
        np.testing.assert_allclose(got["x_grad"], torch.from_numpy(x_grad).bfloat16().float().numpy(),
                                   rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got["y"], y, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["x_grad"], x_grad, rtol=0, atol=1e-6)
    for k in ("weight", "bias"):
        want = getattr(bn, k).grad.numpy() / WORLD
        np.testing.assert_allclose(got[f"{k}_grad"], want, rtol=0, atol=PARAM_GRAD_RTOL * np.abs(want).max())
    np.testing.assert_allclose(got["running_mean"], bn.running_mean.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["running_var"], bn.running_var.numpy(), rtol=0, atol=1e-6)
    assert int(got["num_batches_tracked"]) == int(bn.num_batches_tracked) == 1


def test_global_batchnorm_outside_a_group_is_batchnorm2d_bit_for_bit():
    """A world of one: ``globalize_batchnorm`` keeps the ``state_dict`` keys
    and the very tensors, and the module is ``nn.BatchNorm2d``'s forward and
    backward bit for bit, in train and eval mode, running statistics too."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((2 * rng.standard_normal((5, 3, 4, 6)) + 0.5).astype(np.float32))
    plain = torch.nn.Sequential(torch.nn.Conv2d(3, 3, 1), torch.nn.BatchNorm2d(3))
    init_torch_defaults_(plain, torch.Generator().manual_seed(0))
    glob = torch.nn.Sequential(torch.nn.Conv2d(3, 3, 1), torch.nn.BatchNorm2d(3))
    glob.load_state_dict(plain.state_dict())
    weight = glob[1].weight
    parallel.globalize_batchnorm(glob)
    assert isinstance(glob[1], parallel.GlobalBatchNorm) and glob[1].weight is weight
    assert list(glob.state_dict()) == list(plain.state_dict())
    assert parallel.plain_batchnorms([glob]) == [] and parallel.plain_batchnorms([plain]) == ["0.1"]
    for mode in ("train", "eval"):
        outs = []
        for m in (plain, glob):
            getattr(m, mode)()
            xt = x.clone().requires_grad_(True)
            y = m(xt)
            y.square().sum().backward()
            outs.append([y.detach(), xt.grad, m[1].weight.grad.clone(), *m[1].state_dict().values()])
            m.zero_grad()
        for a, b in zip(*outs):
            assert torch.equal(a, b), mode


# ------------------------------------------------------------------ sampler
@pytest.mark.parametrize("count", [2, 4])
def test_sampler_shards_match_the_jax_loader(count):
    """Each rank's batches are the JAX ``DataLoader._batch_indices`` with the
    same ``shard_index``/``shard_count`` (the seeded shuffle every rank
    shares, then its contiguous slice), epochs 1 to 3, and the ranks' slices
    put together are the one-process batches."""
    n, batch = 37, 8
    ref = JaxDataLoader(list(range(n)), batch, collate_fn=None, seed=11)
    whole = EpochBatchSampler(n, batch, seed=11)
    samplers = [EpochBatchSampler(n, batch, seed=11, shard_index=r, shard_count=count) for r in range(count)]
    jax_loaders = [JaxDataLoader(list(range(n)), batch, collate_fn=None, seed=11, shard_index=r, shard_count=count)
                   for r in range(count)]
    for epoch in (1, 2, 3):
        full = list(whole)
        parts = [list(s) for s in samplers]
        for r, loader in enumerate(jax_loaders):
            loader._epoch = epoch
            assert [list(b) for b in parts[r]] == [b.tolist() for b in loader._batch_indices()]
            assert all(b.epoch == epoch and b.index == i for i, b in enumerate(parts[r]))
        assert [sum(bs, []) for bs in zip(*parts)] == full
        ref._epoch = epoch
        assert full == [b.tolist() for b in ref._batch_indices()]


@pytest.mark.parametrize("kw,match", [({"batch_size": 6, "shard_count": 4}, "divide evenly"),
                                      ({"batch_size": 8, "shard_count": 2, "drop_last": False}, "drop_last")])
def test_sampler_raises_the_jax_value_errors(kw, match):
    for make in (lambda **k: EpochBatchSampler(20, **k), lambda **k: JaxDataLoader(list(range(20)), collate_fn=None,
                                                                                   **k)):
        with pytest.raises(ValueError, match=match):
            make(**kw)


@pytest.mark.parametrize("n,t", [(384, 64), (1536, 16)])
def test_k1_configs_at_a_ranks_share_of_the_flagship(n, t):
    """A rank's share of the flagship at batch 48 over two cards (24 rows)
    runs K1 over W at N = 24 x 16 = 384 and over H at 24 x 64 = 1,536: at
    an H100's 132 SMs and any occupancy of one to eight blocks an SM, the
    fp32 kernels' rows a thread and the bf16 kernels' m-tiles are
    instantiations they have, with a grid that covers every row."""
    for per_sm in range(1, 9):
        occ = {k: per_sm for k in (*gru_seq.RPTS, *gru_seq.TILE_ROWS)}
        cfg = gru_seq.launch_config(n, 32, 132, occ)
        assert cfg.rpt in gru_seq.RPTS and cfg.blocks * gru_seq.THREADS // 32 * cfg.rpt >= 2 * n
        for backward in (False, True):
            tile = gru_seq.tile_config(n, 32, 132, occ, backward=backward)
            assert tile.rows in gru_seq.TILE_ROWS and (tile.rows == 8 or not backward)
            assert tile.blocks * tile.rows * (gru_seq.TILE_WARPS // 4) >= 2 * n


# ------------------------------------------------------------ the train step
def _weights(seed):
    """The reduced flagship's SR model and teacher drawn by the port from
    ``seed``, as port ``state_dict``s of numpy arrays and as flax variables
    (the SR model round-tripped, so both packages start from the same
    numbers)."""
    gen = torch.Generator().manual_seed(seed)
    sr, teacher = init_torch_defaults_(tp.small_tsrn(), gen), init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), gen)
    sr_vars = jax.tree_util.tree_map(np.asarray, ti.import_tsrn({k: v.numpy() for k, v in sr.state_dict().items()},
                                                                srb_nums=2))
    sr_sd = {k: v.numpy() for k, v in from_jax.tsrn_tl_state_dict(sr_vars, srb_nums=2).items()}
    teacher_sd = {k: v.numpy().copy() for k, v in teacher.state_dict().items()}
    return sr_sd, teacher_sd, sr_vars, ti.import_crnn(teacher_sd)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"hr": rng.random((B, 2 * H, 2 * W, 4), dtype=np.float32),
            "lr": rng.random((B, H, W, 4), dtype=np.float32)}


def _jax_mesh_step(sr_vars, teacher_vars, batch):
    """The JAX package's step on the 8-device data mesh (params replicated,
    the batch sharded: tests/test_train.py:179-182): (metrics, new state)."""
    args = jax_default_args(**tp.FLAGSHIP_ARGS)
    config = jax_load_config()
    config.TRAIN.width, config.TRAIN.height, config.TRAIN.batch_size = W * 2, H * 2, B
    config.TRAIN.compute_dtype = "fp32"
    sr_model = JaxTSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True, srb_nums=2,
                          hidden_units=8)
    stu_model = JaxCRNN(nclass=CTC_NUM_CLASSES)
    state = jax_create_train_state(jax.random.PRNGKey(0), sr_model, (), sr_init_variables=sr_vars,
                                   stu_model=stu_model, n_stu=1, teacher_variables=teacher_vars)
    step = jax_make_train_step("tsrn_tl_cascade", ARCHS["tsrn_tl_cascade"], sr_model, stu_model, args, config,
                               donate=False)
    mesh = data_mesh()
    assert mesh.devices.size == 8
    state, batch = shard_params(mesh, state), shard_batch(mesh, batch)
    # XLA's CPU backend at optimization level 0 compiles this step in 25 s
    # instead of 42 (one core) and runs the same ops; the results move by
    # fp32 rounding (1e-6 relative at most in the losses here)
    state, metrics = step.lower(state, batch).compile({"xla_backend_optimization_level": 0})(state, batch)
    return {k: float(np.asarray(v)) for k, v in metrics.items()}, jax.device_get(state)


def _one_process_step(sr_sd, teacher_sd, batch):
    sr = tp.small_tsrn()
    sr.load_state_dict({k: torch.from_numpy(v) for k, v in sr_sd.items()})
    teacher = CRNN(nclass=CTC_NUM_CLASSES)
    teacher.load_state_dict({k: torch.from_numpy(v) for k, v in teacher_sd.items()})
    state = create_train_state([sr], teacher, n_stu=1)
    metrics = make_train_step(tp.FLAGSHIP_ARGS, width=W * 2, device="cpu")(state, batch)
    moments = {f"{kind}.{name}": [state.optimizer.state[p][k].numpy() for k in ("exp_avg", "exp_avg_sq")]
               for kind, m in (("sr", state.sr[0]), ("stu", state.stu[0])) for name, p in m.named_parameters()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "sr": {k: v.numpy() for k, v in state.sr[0].state_dict().items()},
            "stu": {k: v.numpy() for k, v in state.stu[0].state_dict().items()}, "moments": moments}


def _jax_as_reference(sr_vars, teacher_vars, batch):
    metrics, state = _jax_mesh_step(sr_vars, teacher_vars, batch)
    adam = state.opt_state[0]

    def tree(kind, params):
        stats = (state.sr_stats if kind == "sr" else state.stu_stats)[0]
        v = jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})
        sd = from_jax.tsrn_tl_state_dict(v, srb_nums=2) if kind == "sr" else from_jax.crnn_state_dict(v)
        return {k: t.numpy() for k, t in sd.items()}

    out = {"metrics": metrics, "moments": {}}
    for kind in ("sr", "stu"):
        out[kind] = tree(kind, (state.sr_params if kind == "sr" else state.stu_params)[0])
        mu, nu = (tree(kind, getattr(adam, m)[kind][0]) for m in ("mu", "nu"))
        out["moments"].update({f"{kind}.{k}": [mu[k], nu[k]] for k in mu if "running" not in k
                               and "num_batches" not in k})
    return out


def _hold(got, want, init):
    """tests/test_torch_train.py's first-step bounds: metrics at rtol 5e-6;
    per model, Adam's moments (relative L2 over every parameter but the
    pre-BN biases) at 5e-3 and the BN statistics at 1e-5; every parameter
    within 2.5 lr of the reference, and the update within 5 %."""
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL[0], err_msg=k)
    for kind in ("sr", "stu"):
        names = [k for k in got["moments"] if k.startswith(kind + ".")]
        tracked = [k for k in names if not PRE_BN_BIAS.search(k.split(".", 1)[1])]
        for j in (0, 1):
            err = _rel([(torch.from_numpy(got["moments"][k][j]), torch.from_numpy(want["moments"][k][j]))
                        for k in tracked])
            assert err <= MOMENT_RTOL[0], (kind, j, err)
        sd, ref = got[kind], want[kind]
        running = [k for k in ref if "running" in k]
        assert _rel([(torch.from_numpy(sd[k]), torch.from_numpy(ref[k])) for k in running]) <= STATS_RTOL[0], kind
        params = [k.split(".", 1)[1] for k in names]
        for k in params:
            assert float(np.abs(sd[k] - ref[k]).max()) <= 2.5 * LR, (kind, k)
        upd = [k for k in params if not PRE_BN_BIAS.search(k)]
        err = _rel([(torch.from_numpy(sd[k] - init[kind][k]), torch.from_numpy(ref[k] - init[kind][k])) for k in upd])
        assert err <= 0.05, (kind, err)


def test_two_rank_flagship_step_matches_the_jax_mesh_step(runs):
    """The reduced flagship's fp32 step at global batch 8, four rows a rank
    (global BatchNorm, the gradients averaged before the 0.25 clip, the
    prior dropped for the global batch's first quarter), against the JAX
    package's step over the same batch on its 8-device data mesh, at
    tests/test_torch_train.py's first-step bounds.  The ranks end with the
    same parameters, statistics and moments, bit for bit (checked on them)."""
    got = runs["got"]["step"]
    assert got["step"] == 1
    _hold(got, _jax_as_reference(*runs["jax"], runs["batch"]), _init(runs))


def test_two_rank_flagship_step_matches_the_one_process_step(runs):
    """The same two-rank step against the port's one-process step (plain
    BatchNorm over the eight rows), at the same bounds."""
    _hold(runs["got"]["step"], _one_process_step(*runs["sd"], runs["batch"]), _init(runs))


def _init(runs):
    sr_sd, teacher_sd = runs["sd"]
    return {"sr": sr_sd, "stu": teacher_sd}


# ------------------------------------------------------------------- eval
def _eval_batches():
    """Two val batches, the last short and odd (5 rows: the ranks pad it),
    half of each batch labelled with what the one-process SR read says, so
    that the accuracies are neither 0 nor 1."""
    rng = np.random.default_rng(9)
    models = tp.eval_models(EVAL_SEED, "cpu")
    step = make_eval_step(tp.FLAGSHIP_ARGS, W * 2, device="cpu")
    batches = []
    for n in (B, 5):
        batch = {"hr": rng.integers(0, 256, (n, 2 * H, 2 * W, 3), dtype=np.uint8),
                 "lr": rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)}
        reads = decode_crnn(step(models, batch)[1]["logits_sr"])
        batch["labels"] = [r if i % 2 == 0 else "zzz" for i, r in enumerate(reads)]
        batches.append(batch)
    return batches


def test_two_rank_evaluate_gives_the_one_process_metric_dict(runs):
    """``evaluate`` on two ranks (each rank its slice of every batch, the
    short last one padded, the per-sample outputs gathered) gives every
    rank the one-process metric dict: the images unpadded, the accuracies
    exactly, PSNR and SSIM at rtol 1e-6 (means over per-sample values that
    the two batch sizes compute in other orders)."""
    want = evaluate(make_eval_step(tp.FLAGSHIP_ARGS, W * 2, device="cpu"), tp.eval_models(EVAL_SEED, "cpu"),
                    runs["eval_batches"])
    got = runs["got"]["evaluate"]
    assert sorted(got) == sorted(want) and got["images"] == want["images"] == B + 5
    assert 0 < want["accuracy"] < 1
    for k in want:
        if k.startswith(("accuracy", "images")):
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_a_sum_loss_sums_the_gradients_and_the_metrics(runs):
    """``lapsrn``'s Charbonnier loss sums over the batch, so its two-rank
    step sums the gradients and the metrics where the flagship's averages
    them (``average_gradients`` gives the ranks' mean, or their sum): its
    losses equal the one-process step's at rtol 1e-5, every parameter within
    2.5 lr of it."""
    got = runs["got"]
    assert got["reduction"] == {"mean": [1.5] * 3, "sum": [3.0] * 3}
    model = LapSRN(2, 3, False, W * 2, H * 2)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in runs["lapsrn_sd"].items()})
    state = create_train_state([model], None, n_stu=0)
    batch = {k: v[..., :3] for k, v in runs["batch"].items()}
    want = {k: float(v) for k, v in make_train_step({"arch": "lapsrn"}, width=W * 2, device="cpu")(state,
                                                                                                 batch).items()}
    assert sorted(got["lapsrn"]["metrics"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["lapsrn"]["metrics"][k], v, rtol=1e-5, err_msg=k)
    for k, v in model.state_dict().items():
        assert float(np.abs(got["lapsrn"]["sd"][k] - v.numpy()).max()) <= 2.5 * LR, k


def test_a_failing_rank_fails_the_group_and_stops_the_others():
    """Rank 1 raises while rank 0 waits for it at a barrier: ``spawn``
    raises with rank 1's traceback well before the collective's timeout,
    and no rank is left running."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        parallel.spawn(WORLD, tp.fail_on_rank_one, device="cpu", timeout=60)
    import multiprocessing

    assert not [p for p in multiprocessing.active_children() if p.is_alive()]
