"""The whole eval slice: the JAX ``make_eval_step`` + ``evaluate`` against the
port's on the same weights and batches.

State is built as ``__graft_entry__._dryrun_multichip_impl`` builds it
(TSRN_TL with STN and mask, a student CRNN per stage and a frozen teacher),
at a tiny size: 2 SRBs, hidden 8, LR 16x32 -> HR 32x64, batch 2.
Tolerances: 5e-4 on SR images and per-sample MSE/255^2 scale (the full
TSRN_TL's, tests/test_models_parity.py:101), 2e-4 on logits (the CRNN's),
1e-5 relative on the aggregated PSNR/SSIM; accuracies and counts exact."""

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)

from tpgsr_tpu.charset import CTC_NUM_CLASSES
from tpgsr_tpu.config import default_args, load_config
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS
from tpgsr_tpu.models.tsrn import TSRN_TL as JaxTSRN_TL
from tpgsr_tpu.ops.ctc import ctc_ids_to_strings
from tpgsr_tpu.train.evaluate import evaluate as jax_evaluate
from tpgsr_tpu.train.state import create_train_state
from tpgsr_tpu.train.step import make_eval_step as jax_make_eval_step
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.tsrn import TSRN_TL
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.step import EvalModels, make_eval_step

B, H, W = 2, 16, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(stu_iter, sr_share, tpg_share):
    args = default_args(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True,
                        stu_iter=stu_iter, sr_share=sr_share, tpg_share=tpg_share, srb=2, hd_u=8)
    config = load_config()
    config.TRAIN.width, config.TRAIN.height = W * 2, H * 2
    sr_model = JaxTSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True,
                          srb_nums=2, hidden_units=8)
    stu_model = JaxCRNN(nclass=CTC_NUM_CLASSES)
    crnn_in = np.zeros((B, 32, W * 2, 1), np.float32)

    def build(key):  # jitted: the op-by-op init alone takes ~30 s on the CPU
        return create_train_state(
            key, sr_model,
            (np.zeros((B, H, W, 4), np.float32), np.zeros((B, 1, 26, CTC_NUM_CLASSES), np.float32)),
            n_sr=1 if sr_share else stu_iter, stu_model=stu_model, stu_example_inputs=(crnn_in,),
            n_stu=1 if tpg_share else stu_iter,
            teacher_variables=stu_model.init(jax.random.PRNGKey(1), crnn_in, train=False),
        )

    return args, config, sr_model, stu_model, jax.jit(build)(jax.random.PRNGKey(0))


def _port_models(state):
    def vars_of(params, stats):
        return jax.tree_util.tree_map(np.asarray, unfreeze({"params": params, "batch_stats": stats}))

    def tsrn(p, s):
        m = TSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True, srb_nums=2,
                    hidden_units=8)
        m.load_state_dict(from_jax.tsrn_tl_state_dict(vars_of(p, s), srb_nums=2))
        return m

    def crnn(p, s):
        m = CRNN(nclass=CTC_NUM_CLASSES)
        m.load_state_dict(from_jax.crnn_state_dict(vars_of(p, s)))
        return m

    return EvalModels(
        sr=[tsrn(p, s) for p, s in zip(state.sr_params, state.sr_stats)],
        stu=[crnn(p, s) for p, s in zip(state.stu_params, state.stu_stats)],
        teacher=crnn(state.teacher_params, state.teacher_stats),
    ).eval()


@pytest.mark.parametrize("stu_iter,sr_share,tpg_share", [(1, True, False), (2, False, True)])
def test_eval_slice_matches_jax(stu_iter, sr_share, tpg_share):
    args, config, sr_model, stu_model, state = _setup(stu_iter, sr_share, tpg_share)
    jax_step = jax_make_eval_step("tsrn_tl_cascade", ARCHS["tsrn_tl_cascade"], sr_model,
                                  stu_model, args, config)
    models = _port_models(state)
    step = make_eval_step(args, width=config.TRAIN.width, device="cpu")

    rng = np.random.default_rng(stu_iter)
    batches = [{"hr": rng.random((B, 2 * H, 2 * W, 4), dtype=np.float32),
                "lr": rng.random((B, H, W, 4), dtype=np.float32)} for _ in range(2)]
    for batch in batches:
        ref_sr, ref = jax_step(state, batch)
        sr, outs = step(models, batch)
        np.testing.assert_allclose(sr.numpy(), np.asarray(ref_sr), atol=5e-4)
        np.testing.assert_allclose(outs["mse"].numpy() / 255.0**2, np.asarray(ref["mse"]) / 255.0**2, atol=5e-4)
        np.testing.assert_allclose(outs["ssim"].numpy(), np.asarray(ref["ssim"]), atol=5e-4)
        assert sorted(outs) == sorted(ref)
        for k in outs:
            if k.startswith("logits_"):
                np.testing.assert_allclose(outs[k].numpy(), np.asarray(ref[k]), atol=2e-4)
        # labels: the JAX HR reading for the first sample, a miss for the
        # second, so the accuracies are neither all 0 nor all 1
        hr_read = ctc_ids_to_strings(np.argmax(np.asarray(ref["logits_hr"]), -1))
        batch["labels"] = [hr_read[0], "zz-not-a-word"]

    ref_metrics = jax_evaluate(jax_step, state, batches)
    metrics = evaluate(step, models, batches)
    assert sorted(metrics) == sorted(ref_metrics)
    assert metrics["accuracy_hr"] == ref_metrics["accuracy_hr"] == 0.5
    for k, v in ref_metrics.items():
        if k in ("psnr_avg", "ssim_avg"):
            np.testing.assert_allclose(metrics[k], v, rtol=1e-5)
        else:
            assert metrics[k] == v, k
