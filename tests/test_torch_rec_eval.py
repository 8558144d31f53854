"""ASTER and MORAN as the eval recognizer, held to the JAX package on the CPU:
the eval step of the flagship (TSRN_TL at tests/test_torch_eval.py's size)
and of ``srcnn`` with each recognizer against
``tpgsr_tpu.train.step.make_eval_step(eval_rec=...)``, ``evaluate``'s metric
dict with each recognizer's decoder, and ``TextSR`` through ``cli.main``
with ``--test --rec aster`` and ``--go_test --test_model MORAN`` against the
JAX ``TextSR``, both reading one recognizer file written in the original's
layout (a ``state_dict`` entry, ``module.`` prefixes, non-tensor entries
and the constants the original keeps as buffers).

Weights: tests/torch_recognizers.py's, ASTER at ``max_len_labels`` 12 in
the step tests and at ``AsterInfo``'s 100 in ``TextSR``.  Tolerances: SR,
MSE/255^2 and SSIM at 5e-4 (tests/test_torch_eval.py's, the full
TSRN_TL's); MORAN's logits at 1e-4, and ASTER's ids and MORAN's argmax ids
exactly, where the port's margins clear tests/test_torch_aster.py's and
tests/test_torch_moran.py's ``MARGIN`` (asserted and printed); PSNR and SSIM
averages at 1e-4 relative (tests/test_torch_cli.py's), accuracies and
counts exactly."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze

from tests import test_torch_aster, test_torch_moran
from tests.fixtures import make_textzoom_lmdb
from tests.test_torch_cli import FLAGS, PSNR_SSIM_RTOL, _in_dir
from tests.test_torch_eval import _port_models, _setup
from tests.torch_recognizers import greedy_margins, jax_aster, jax_moran, port_aster, port_moran
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu import config as jax_config
from tpgsr_tpu.interop import torch_import as ti
from tpgsr_tpu.models.aster import decode_aster_ids as jax_decode_aster_ids
from tpgsr_tpu.models.moran import decode_moran_ids as jax_decode_moran_ids
from tpgsr_tpu.models.registry import ARCHS as JAX_ARCHS
from tpgsr_tpu.train.evaluate import evaluate as jax_evaluate
from tpgsr_tpu.train.state import create_train_state
from tpgsr_tpu.train.step import make_eval_step as jax_make_eval_step
from tpgsr_tpu.train.trainer import TextSR as JaxTextSR
from tpgsr_tpu_torch import cli, config
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.registry import build_model
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.step import EvalModels, make_eval_step, rec_decoder, recognizer_input

B, H, W = 2, 16, 32
STEP_MAX_LEN = 12
SR_ATOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def recognizers():
    """{kind: (JAX model, its variables, the port's model, the host decoder
    of each package)} at the step tests' ``max_len_labels``."""
    a_model, a_vars, info = jax_aster(STEP_MAX_LEN)
    m_model, m_vars = jax_moran()
    return {
        "ASTER": (a_model, a_vars, port_aster(a_vars, info, STEP_MAX_LEN),
                  lambda ids: jax_decode_aster_ids(np.asarray(ids), info), rec_decoder("ASTER", "all")),
        "MORAN": (m_model, m_vars, port_moran(m_vars), jax_decode_moran_ids, rec_decoder("MORAN")),
    }


def _srcnn_setup():
    """The JAX ``srcnn`` (no STN, the mask) on the port's seeded draw, and the
    port's model on the same weights."""
    args = jax_config.default_args(arch="srcnn", mask=True)
    cfg = jax_config.load_config()
    cfg.TRAIN.width, cfg.TRAIN.height = 2 * W, 2 * H
    a, c = {"STN": False, "mask": True, "srb": 5, "hd_u": 32}, {"scale_factor": 2, "width": 2 * W, "height": 2 * H}
    port = init_torch_defaults_(build_model("srcnn", a, c)[0], torch.Generator().manual_seed(3)).eval()
    v = ti.import_sr_checkpoint("srcnn", {k: t.numpy() for k, t in port.state_dict().items()})
    sr_model = JAX_ARCHS["srcnn"].build(a, c)
    state = create_train_state(jax.random.PRNGKey(0), sr_model, (np.zeros((B, H, W, 4), np.float32),),
                               sr_init_variables=v)
    return args, cfg, sr_model, None, state, EvalModels(sr=[port], stu=[], teacher=None)


@pytest.fixture(scope="module")
def setups():
    flag = _setup(1, True, False)
    return {"tsrn_tl_cascade": (*flag, _port_models(flag[-1])), "srcnn": _srcnn_setup()}


def _batches(seed):
    rng = np.random.default_rng(seed)
    return [{"hr": rng.random((B, 2 * H, 2 * W, 4), dtype=np.float32),
             "lr": rng.random((B, H, W, 4), dtype=np.float32)} for _ in range(2)]


def _check_rec_outputs(kind, got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if kind == "MORAN":
        margins = greedy_margins(want)
        print("MORAN logits max_abs_err", np.abs(got - want).max(), "margins", margins)
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert (margins > test_torch_moran.MARGIN).all(), margins
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["tsrn_tl_cascade", "srcnn"])
@pytest.mark.parametrize("kind", ["ASTER", "MORAN"])
def test_eval_step_with_recognizer_matches_jax(setups, recognizers, arch, kind):
    """The eval step's SR, MSE, SSIM and the recognizer's outputs on SR, LR
    and HR; then ``evaluate``'s metric dict over two batches labelled with
    what JAX reads on the first sample's HR (so that an accuracy is 1/2)."""
    args, cfg, sr_model, stu_model, state, port_models = setups[arch]
    jax_rec, jax_vars, port_rec, jax_decode, decode = recognizers[kind]
    # device arrays, as the JAX trainer passes them (MORAN indexes its
    # embeddings by traced ids)
    jax_vars = jax.tree_util.tree_map(jax.numpy.asarray, jax_vars)
    jax_step = jax_make_eval_step(arch, JAX_ARCHS[arch], sr_model, stu_model, args, cfg,
                                  eval_rec=(kind, jax_rec, jax_vars))
    models = EvalModels(sr=port_models.sr, stu=port_models.stu, teacher=port_models.teacher, rec=port_rec).eval()
    assert models.rec_kind == kind
    step = make_eval_step(args, width=cfg.TRAIN.width, device="cpu")
    batches = _batches(7)
    for batch in batches:
        ref_sr, ref = jax_step(state, batch)
        sr, outs = step(models, batch)
        np.testing.assert_allclose(sr.numpy(), np.asarray(ref_sr), atol=SR_ATOL)
        np.testing.assert_allclose(outs["mse"].numpy() / 255.0**2, np.asarray(ref["mse"]) / 255.0**2, atol=SR_ATOL)
        np.testing.assert_allclose(outs["ssim"].numpy(), np.asarray(ref["ssim"]), atol=SR_ATOL)
        assert sorted(outs) == sorted(ref)
        if kind == "ASTER":
            with torch.no_grad():
                feats = port_rec.encoder(port_rec.rectify(recognizer_input(kind, sr)))
                margins = port_rec.decoder.beam_search(feats, 5, port_rec.eos_id).margins
            print("ASTER margins on SR", margins)
            assert (margins > test_torch_aster.MARGIN).all()
        for k in ("logits_sr", "logits_lr", "logits_hr"):
            _check_rec_outputs(kind, outs[k], ref[k])
        batch["labels"] = [jax_decode(ref["logits_hr"])[0], "zz-not-a-word"]
        assert decode(outs["logits_hr"]) == jax_decode(ref["logits_hr"])

    ref_metrics = jax_evaluate(jax_step, state, batches, decoder=jax_decode)
    metrics = evaluate(step, models, batches, decoder=decode)
    print(kind, arch, metrics)
    assert sorted(metrics) == sorted(ref_metrics)
    assert metrics["accuracy_hr"] == ref_metrics["accuracy_hr"] == 0.5
    for k, v in ref_metrics.items():
        if k in ("psnr_avg", "ssim_avg"):
            np.testing.assert_allclose(metrics[k], v, rtol=PSNR_SSIM_RTOL)
        else:
            assert metrics[k] == v, k


# ------------------------------------------------------------ TextSR on a shared recognizer file


def _original_layout(sd, wrap: bool, constants):
    """A recognizer ``state_dict`` as the original's files hold it:
    ``module.`` prefixes (DataParallel), the constant buffers, and for
    ``aster_demo.pth.tar`` a dict with the epoch and a numpy score beside
    the weights."""
    out = {f"module.{k}": v for k, v in sd.items()}
    out.update({f"module.{k}": v for k, v in constants.items()})
    return {"state_dict": out, "epoch": 3, "best_res": np.float64(0.25)} if wrap else out


@pytest.fixture(scope="module")
def textsr(tmp_path_factory, recognizers):
    """``--test --rec aster`` and ``--go_test --test_model MORAN`` by the JAX
    ``TextSR`` and by ``cli.main(..., device="cpu")``, from the same SR
    weights and recognizer files (the step tests' weights: ASTER's do not
    depend on ``max_len_labels``), over the 16-pair LMDB at batch 8."""
    from tests.test_torch_cli import B as CLI_B, H as CLI_H, W as CLI_W

    root = tmp_path_factory.mktemp("rec_textsr")
    db = make_textzoom_lmdb(str(root / "db"), n=16)
    a_vars, m_vars = recognizers["ASTER"][1], recognizers["MORAN"][1]
    aster_path, moran_path = str(root / "aster_demo.pth.tar"), str(root / "moran_demo.pth")
    torch.save(_original_layout(from_jax.aster_state_dict(a_vars), True,
                                {"tps.inverse_kernel": torch.zeros(23, 23),
                                 "tps.target_coordinate_repr": torch.zeros(3200, 23)}), aster_path)
    torch.save(_original_layout(from_jax.moran_state_dict(m_vars), False, {"MORN.grid": torch.zeros(1, 32, 100, 2)}),
               moran_path)

    jax_cfg = jax_config.load_config()
    t = jax_cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [db], [db]
    t.width, t.height, t.batch_size, t.compute_dtype, t.n_devices = 2 * CLI_W, 2 * CLI_H, CLI_B, "fp32", 1
    t.VAL.rec_pretrained, t.VAL.moran_pretrained = aster_path, moran_path
    t.ckpt_dir = str(root / "ckpt_jax")
    jax_cfg.TEST.test_data_dir = db
    jax_args = jax_config.default_args(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True,
                                       sr_share=True, stu_iter=1, srb=2, hd_u=8, batch_size=CLI_B, vis_dir="jax",
                                       test=True, rec="aster")
    (root / "jax").mkdir()
    with _in_dir(root / "jax"), contextlib.redirect_stdout(io.StringIO()):
        jax_mission = JaxTextSR(jax_cfg, jax_args)
        state = jax_mission.init_state()
        variables = jax.tree_util.tree_map(np.asarray, unfreeze({"params": state.sr_params[0],
                                                                   "batch_stats": state.sr_stats[0]}))
        teacher = jax.tree_util.tree_map(np.asarray, unfreeze({"params": state.teacher_params,
                                                                 "batch_stats": state.teacher_stats}))
        ckpt_dir = root / "ckpt_from_jax"
        ckpt_dir.mkdir()
        torch.save({"state_dict_G": from_jax.tsrn_tl_state_dict(variables, srb_nums=2)}, ckpt_dir / "model_best_0.pth")
        stu = from_jax.crnn_state_dict(jax.tree_util.tree_map(np.asarray, unfreeze(
            {"params": state.stu_params[0], "batch_stats": state.stu_stats[0]})))
        torch.save(stu, ckpt_dir / "recognizer_best_0.pth")
        torch.save(from_jax.crnn_state_dict(teacher), root / "crnn.pth")
        jax_test = jax_mission.test()
        jax_mission.args.update(test=False, go_test=True, test_model="MORAN")
        jax_go = {}
        run_val = jax_mission._run_val
        jax_mission._run_val = lambda *a, **k: jax_go.update(run_val(*a, **k)) or jax_go
        jax_mission.train()

    port_cfg = config.load_config()
    t = port_cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [db], [db]
    t.width, t.height, t.compute_dtype, t.workers = 2 * CLI_W, 2 * CLI_H, "fp32", 0
    t.VAL.rec_pretrained, t.VAL.moran_pretrained = aster_path, moran_path
    t.VAL.crnn_pretrained = str(root / "crnn.pth")
    t.ckpt_dir = str(root / "ckpt_port")
    yaml_path = root / "port.yaml"
    yaml_path.write_text(yaml.safe_dump(json.loads(json.dumps(port_cfg))))
    argv = FLAGS + ["--config", str(yaml_path), "--vis_dir", "port", "--resume", str(ckpt_dir)]
    (root / "port").mkdir()
    with _in_dir(root / "port"):
        port_test = cli.main(argv + ["--test", "--rec", "aster", "--test_data_dir", db], device="cpu")
        port_go = cli.main(argv + ["--go_test", "--test_model", "MORAN"], device="cpu")
    return {"jax": (jax_test, jax_go), "port": (port_test, port_go)}


def _assert_metric_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k in ("psnr_avg", "ssim_avg"):
            np.testing.assert_allclose(got[k], v, rtol=PSNR_SSIM_RTOL, err_msg=k)
        elif k != "fps":
            assert got[k] == v, k


def test_test_mode_with_aster_matches_jax(textsr):
    """``--test --rec aster``: JAX's metric dict over the 16 pairs, and a
    frame rate."""
    (jax_test, _), (port_test, _) = textsr["jax"], textsr["port"]
    print("--test --rec aster", port_test)
    _assert_metric_dicts_equal(port_test, jax_test)
    assert port_test["images"] == 16 and port_test["fps"] > 0


def test_go_test_with_moran_matches_jax(textsr):
    """``--go_test --test_model MORAN``: JAX's metric dict for the split."""
    (_, jax_go), (_, port_go) = textsr["jax"], textsr["port"]
    print("--go_test --test_model MORAN", port_go)
    assert list(port_go) == list(jax_go)
    for name, want in jax_go.items():
        _assert_metric_dicts_equal(port_go[name], want)
