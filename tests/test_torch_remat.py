"""The cascade's recompute held to the JAX package's ``jax.checkpoint`` on the
CPU: one fp32 step of ``tsrn_tl_cascade`` at ``--stu_iter 3 --sr_share``
(one TSRN_TL applied three times, each stage recomputed in the backward,
K1's plain recurrences included) against JAX's step from shared weights:
the losses, the SR model's gradients (Adam's moments) and its BatchNorm
statistics, with ``num_batches_tracked`` advanced 3 times, not 6; the same
step with ``torch.utils.checkpoint`` taken out gives the same numbers
exactly and saves more bytes for the backward.

Bounds are tests/test_torch_zoo_train.py's.  Sizes: LR 16x32 -> HR 32x64,
batch 4, 2 SRBs at hidden 8."""

import functools

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.test_torch_zoo_train import PRE_BN_BIAS
from tpgsr_tpu.charset import CTC_NUM_CLASSES
from tpgsr_tpu.config import default_args, load_config
from tpgsr_tpu.interop.torch_import import import_crnn, import_sr_checkpoint
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS as JAX_ARCHS
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES as PORT_CLASSES
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.registry import build_model
from tpgsr_tpu_torch.train import step as port_step
from tpgsr_tpu_torch.train.state import create_train_state

B, H, W = 4, 16, 32
ARCH, STAGES = "tsrn_tl_cascade", 3
ARGS = default_args(arch=ARCH, mask=True, gradient=True, sr_share=True, use_distill=True, stu_iter=STAGES, srb=2,
                    hd_u=8)
DICTS = ({"STN": False, "mask": True, "srb": 2, "hd_u": 8}, {"scale_factor": 2, "width": 2 * W, "height": 2 * H})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _drawn(module, seed):
    init_torch_defaults_(module, torch.Generator().manual_seed(seed))
    return {k: t.numpy() for k, t in module.state_dict().items()}


def _batch():
    rng = np.random.default_rng(0)
    return {"hr": rng.random((B, 2 * H, 2 * W, 4), dtype=np.float32),
            "lr": rng.random((B, H, W, 4), dtype=np.float32)}


def _vars(params, stats):
    return jax.tree_util.tree_map(np.asarray, unfreeze({"params": params, "batch_stats": stats}))


@functools.lru_cache(maxsize=None)
def _jax():
    """(initial JAX state, (state, metrics) after one step): one SR model,
    three students copied from the teacher, the port's seeded draws."""
    sr_model = JAX_ARCHS[ARCH].build(*DICTS)
    sr_init = import_sr_checkpoint(ARCH, _drawn(build_model(ARCH, *DICTS)[0], 0), srb_nums=2)
    teacher = import_crnn(_drawn(CRNN(nclass=PORT_CLASSES), 1))
    inputs = (np.zeros((B, H, W, 4), np.float32), np.zeros((B, 1, 26, CTC_NUM_CLASSES), np.float32))
    state = jax_create_train_state(jax.random.PRNGKey(0), sr_model, inputs, n_sr=1, n_stu=STAGES,
                                   teacher_variables=teacher, sr_init_variables=sr_init)
    cfg = load_config()
    cfg.TRAIN.width, cfg.TRAIN.height, cfg.TRAIN.compute_dtype = 2 * W, 2 * H, "fp32"
    step = jax_make_train_step(ARCH, JAX_ARCHS[ARCH], sr_model, JaxCRNN(nclass=CTC_NUM_CLASSES), ARGS, cfg,
                               donate=False)
    return state, step(state, _batch())


def _port_state(state):
    sr, _ = build_model(ARCH, *DICTS)
    sr.load_state_dict(from_jax.sr_state_dict(ARCH, _vars(state.sr_params[0], state.sr_stats[0]), srb_nums=2))
    teacher = CRNN(nclass=PORT_CLASSES)
    teacher.load_state_dict(from_jax.crnn_state_dict(_vars(state.teacher_params, state.teacher_stats)))
    return create_train_state([sr], teacher, n_stu=STAGES)


def _rel(pairs):
    num = sum(float((a - b).pow(2).sum()) for a, b in pairs)
    den = sum(float(b.pow(2).sum()) for _, b in pairs)
    return (num / max(den, 1e-30)) ** 0.5


def _step_saving(port, remat=True):
    """One port step on ``port``; (metrics, bytes of the distinct storages
    the forward saved for the backward).  Without ``remat`` the SR stages
    run without ``torch.utils.checkpoint``."""
    saved = {}

    def pack(t):
        storage = t.untyped_storage()
        saved[storage.data_ptr()] = storage.nbytes()
        return t

    with pytest.MonkeyPatch.context() as mp:
        if not remat:
            mp.setattr(port_step, "checkpoint", lambda fn, *a, **k: fn(*a))
        step = port_step.make_train_step(ARGS, width=2 * W, device="cpu")
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            metrics = step(port, _batch())
    return {k: float(v) for k, v in metrics.items()}, sum(saved.values())


def test_recomputed_cascade_matches_jax():
    """Losses at rtol 5e-6; the SR model's Adam moments at 5e-3 and its
    BatchNorm statistics at 1e-5 (the pre-BN biases apart); every
    ``num_batches_tracked`` at 3, one a stage."""
    state0, (state, ref) = _jax()
    port = _port_state(state0)
    got, _ = _step_saving(port)
    assert sorted(got) == sorted(ref) and f"loss_img_{STAGES - 1}" in got
    for name in got:
        np.testing.assert_allclose(got[name], float(ref[name]), rtol=5e-6, err_msg=name)
    to_sd = lambda p, s: from_jax.sr_state_dict(ARCH, _vars(p, s), srb_nums=2)  # noqa: E731
    sr = port.sr[0]
    named = dict(sr.named_parameters())
    tracked = [n for n in named if not PRE_BN_BIAS.search(n)]
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = to_sd(getattr(state.opt_state[0], moment)["sr"][0], state.sr_stats[0])
        assert _rel([(port.optimizer.state[named[n]][key], want[n]) for n in tracked]) <= 5e-3, moment
    sd, want = sr.state_dict(), to_sd(state.sr_params[0], state.sr_stats[0])
    running = [n for n in sd if "running" in n]
    assert running and _rel([(sd[n], want[n]) for n in running]) <= 1e-5
    counts = {n: int(v) for n, v in sd.items() if n.endswith("num_batches_tracked")}
    assert counts and set(counts.values()) == {STAGES}, counts


def test_recompute_changes_memory_not_results():
    """The step without the checkpoint, from the same weights: the same
    losses, gradients and statistics bit for bit, and more bytes saved for
    the backward than the recomputed step's."""
    state0, _ = _jax()
    runs = {}
    for remat in (True, False):
        port = _port_state(state0)
        metrics, saved = _step_saving(port, remat)
        runs[remat] = (metrics, saved, port.sr[0].state_dict(), [p.grad for p in port.sr[0].parameters()])
    (m_remat, b_remat, sd_remat, g_remat), (m_plain, b_plain, sd_plain, g_plain) = runs[True], runs[False]
    assert m_remat == m_plain
    assert all(torch.equal(a, b) for a, b in zip(g_remat, g_plain))
    assert all(torch.equal(sd_remat[k], sd_plain[k]) for k in sd_plain)
    assert b_remat < b_plain, (b_remat, b_plain)
