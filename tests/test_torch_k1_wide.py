"""K1 at hidden sizes beyond the flagship's 32, on the CPU: the padding that
takes any ``--hd_u`` from 1 to 128 to an instantiated size on the card
(``ops.rnn.pad_hidden``, ``unpad_output``), the plain port at wide and
padded sizes against the JAX package's TPU kernel and fused scan, and one
flagship train step at ``--hd_u 40`` against the JAX step.  The card's
kernels at these sizes (csrc/bigru_seq_wide.cu and the padded narrow ones)
run in the ``cuda`` tests of tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import gru_params, torch_params
from tests.test_torch_train import LOSS_RTOL, MOMENT_RTOL, PRE_BN_BIAS, STATS_RTOL, _rel
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.config import default_args as jax_default_args
from tpgsr_tpu.config import load_config as jax_load_config
from tpgsr_tpu.interop import torch_import as ti
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS
from tpgsr_tpu.models.tsrn import TSRN_TL as JaxTSRN_TL
from tpgsr_tpu.ops.pallas_gru import _bigru_pallas_impl
from tpgsr_tpu.ops.rnn import bigru_fused
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.tsrn import TSRN_TL
from tpgsr_tpu_torch.ops import gru_seq, rnn
from tpgsr_tpu_torch.train.state import create_train_state
from tpgsr_tpu_torch.train.step import make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bigru_padded(x, fw, bw, hidden: int) -> torch.Tensor:
    """The plain BiGRU at ``hidden`` on zero-padded weights, sliced back to
    [N, T, 2H]: what K1's wrapper does on the card."""
    h = fw["w_hh"].shape[-1]
    return rnn.unpad_output(rnn.bigru(x, rnn.pad_hidden(fw, hidden), rnn.pad_hidden(bw, hidden)), h)


def _padded_to(h: int) -> int:
    """A size to pad ``h`` to: the card's (``padded_hidden``) where it pads,
    else eight more units (64 and 128 run unpadded on the card)."""
    return max(gru_seq.padded_hidden(h), h + 8)


@pytest.mark.parametrize("h", [1, 12, 20, 40, 64, 100, 128])
def test_padded_plain_recurrence_equals_the_unpadded_one(h):
    """The plain BiGRU on zero-padded weights, sliced back, equals the plain
    BiGRU at the real size within 1e-6, forward and backward (autograd
    through the padding gives every gradient at its real shape), each
    gradient within 1e-6 of its largest entry where that is above 1: the
    padded products sum in other blocks, which moves a sum of 24 row-steps
    of about 7 by an ulp or two; the padded units' outputs, and every
    gradient on them, are exactly 0."""
    hp = _padded_to(h)
    n, t, c = 4, 6, 10
    rng = np.random.default_rng(h)
    x = torch.from_numpy(rng.random((n, t, c), dtype=np.float32))
    fw, bw = (torch_params(p) for p in gru_params(rng, c, h, scale=float(1 / np.sqrt(h))))
    g = torch.from_numpy(rng.standard_normal((n, t, 2 * h)).astype(np.float32))

    def run(pad: bool):
        leaves = [x.clone().requires_grad_(True)] + [{k: v.clone().requires_grad_(True) for k, v in d.items()}
                                                     for d in (fw, bw)]
        out = bigru_padded(*leaves, hp) if pad else rnn.bigru(*leaves)
        out.backward(g)
        return out.detach(), [leaves[0].grad] + [d[k].grad for d in leaves[1:] for k in sorted(d)]

    (got, got_grads), (want, want_grads) = run(True), run(False)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for a, b in zip(got_grads, want_grads):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * max(1.0, float(b.abs().max())))

    # the padded units, with the padded weights as leaves
    padded = [{k: v.detach().requires_grad_(True) for k, v in rnn.pad_hidden(d, hp).items()} for d in (fw, bw)]
    full = rnn.bigru(x, *padded)
    rnn.unpad_output(full, h).backward(g)
    assert not full.detach().view(n, t, 2, hp)[..., h:].any()
    for d in padded:
        gates = {k: d[k].grad.view(3, hp, -1) for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
        assert all(not v[:, h:].any() for v in gates.values())
        assert not d["w_hh"].grad[:, h:].any()


@pytest.mark.parametrize("h", [12, 40, 64, 128])
def test_plain_port_matches_the_pallas_kernel_and_bigru_fused(h):
    """The port's plain BiGRU at a padded (12, 40) or a wide size (64, 128),
    the CPU path the card's kernels are held to, against the TPU kernel
    (``_bigru_pallas_impl`` in interpret mode) and ``bigru_fused`` at atol
    1e-5, the tolerance of tests/test_rnn.py:105-120; and padded to the
    card's size, against the same."""
    n, t, c = 6, 7, 12
    rng = np.random.default_rng(100 + h)
    x = rng.random((n, t, c), dtype=np.float32)
    fw, bw = gru_params(rng, c, h, scale=float(1 / np.sqrt(h)))
    got = rnn.bigru(torch.from_numpy(x), torch_params(fw), torch_params(bw)).numpy()
    padded = bigru_padded(torch.from_numpy(x), torch_params(fw), torch_params(bw), _padded_to(h)).numpy()
    for ref in (_bigru_pallas_impl(jnp.asarray(x), fw, bw, interpret=True), bigru_fused(jnp.asarray(x), fw, bw)):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(padded, np.asarray(ref), atol=1e-5)


# one flagship step at --hd_u 40: tests/test_torch_train.py's geometry (LR
# 16x32 -> HR 32x64), one SRB, four rows
B, H, W = 4, 16, 32
HD_U = 40
FLAGSHIP_ARGS = {"arch": "tsrn_tl_cascade", "STN": True, "mask": True, "use_distill": True, "gradient": True,
                 "sr_share": True, "stu_iter": 1, "srb": 1, "hd_u": HD_U}


def _tsrn() -> TSRN_TL:
    return TSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True, srb_nums=1, hidden_units=HD_U)


def _numpy_sd(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def test_flagship_train_step_at_hd_u_40_matches_jax():
    """The flagship's fp32 step at ``--hd_u 40`` (one SRB, batch 4) from the
    port's draw, crossed to the JAX package through its importers
    (``import_tsrn``, ``import_crnn``) and back through ``from_jax``, against
    the JAX step at tests/test_torch_train.py's first-step bounds: the
    metrics at rtol 5e-6, per model Adam's moments at 5e-3 and the BN
    statistics at 1e-5 (relative L2, the pre-BN biases apart)."""
    gen = torch.Generator().manual_seed(40)
    drawn, teacher = init_torch_defaults_(_tsrn(), gen), init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), gen)
    sr_vars = jax.tree_util.tree_map(np.asarray, ti.import_tsrn(_numpy_sd(drawn.state_dict()), srb_nums=1))
    teacher_sd = _numpy_sd(teacher.state_dict())
    rng = np.random.default_rng(41)
    batch = {"hr": rng.random((B, 2 * H, 2 * W, 4), dtype=np.float32),
             "lr": rng.random((B, H, W, 4), dtype=np.float32)}

    # the JAX step
    args = jax_default_args(**FLAGSHIP_ARGS)
    config = jax_load_config()
    config.TRAIN.width, config.TRAIN.height, config.TRAIN.batch_size = W * 2, H * 2, B
    config.TRAIN.compute_dtype = "fp32"
    sr_model = JaxTSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True, srb_nums=1,
                          hidden_units=HD_U)
    stu_model = JaxCRNN(nclass=CTC_NUM_CLASSES)
    state = jax_create_train_state(jax.random.PRNGKey(0), sr_model, (), sr_init_variables=sr_vars,
                                   stu_model=stu_model, n_stu=1, teacher_variables=ti.import_crnn(teacher_sd))
    step = jax_make_train_step("tsrn_tl_cascade", ARCHS["tsrn_tl_cascade"], sr_model, stu_model, args, config,
                               donate=False)
    # XLA's CPU backend at optimization level 0 compiles in about half the
    # time and runs the same ops (tests/test_torch_parallel.py)
    state, ref = step.lower(state, batch).compile({"xla_backend_optimization_level": 0})(state, batch)
    state = jax.device_get(state)

    # the port's step from the same numbers
    sr = _tsrn()
    sr.load_state_dict(from_jax.tsrn_tl_state_dict(sr_vars, srb_nums=1))
    teacher.load_state_dict({k: torch.from_numpy(v) for k, v in teacher_sd.items()})
    port = create_train_state([sr], teacher, n_stu=1)
    got = make_train_step(FLAGSHIP_ARGS, width=W * 2, device="cpu")(port, batch)
    assert sizes_of(port.sr[0]) == {HD_U}

    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(np.asarray(v)), rtol=LOSS_RTOL[0], err_msg=k)
    adam = state.opt_state[0]
    for kind, model, to_sd in (("sr", port.sr[0], lambda v: from_jax.tsrn_tl_state_dict(v, srb_nums=1)),
                               ("stu", port.stu[0], from_jax.crnn_state_dict)):
        stats = (state.sr_stats if kind == "sr" else state.stu_stats)[0]
        params = (state.sr_params if kind == "sr" else state.stu_params)[0]

        def tree(p, stats=stats):
            return to_sd(jax.tree_util.tree_map(np.asarray, {"params": p, "batch_stats": stats}))

        named = dict(model.named_parameters())
        tracked = [k for k in named if not PRE_BN_BIAS.search(k)]
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = tree(getattr(adam, moment)[kind][0])
            err = _rel([(port.optimizer.state[named[k]][key], want[k]) for k in tracked])
            assert err <= MOMENT_RTOL[0], (kind, moment, err)
        ref_sd, sd = tree(params), model.state_dict()
        running = [k for k in sd if "running" in k]
        assert _rel([(sd[k], ref_sd[k]) for k in running]) <= STATS_RTOL[0], kind


def sizes_of(model: torch.nn.Module):
    """The hidden sizes of a model's BiGRUs."""
    return {m.weight_hh_l0.shape[-1] for m in model.modules() if hasattr(m, "weight_hh_l0")}
