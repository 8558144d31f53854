"""``--random_reso`` held to the JAX package on the CPU: ``cal_conf``,
``eval_random_reso`` and ``evaluate_random_reso_loader`` of
``tpgsr_tpu_torch.train.random_reso`` against ``tpgsr_tpu.train.random_reso``
on the same weights, then ``TextSR`` with ``--syn --random_reso --go_test``
(the flagship's flags) against the JAX ``TextSR``, and the JAX package's two
refusals of the mode.

Data: a synthetic single-image LMDB of four words at three native sizes
(100x32, 57x20 with its odd width, 64x16 at the gate's height limit), PNGs,
half of them labelled with what the teacher reads on their HR.
Weights: the port's ``TextSR`` draw at tests/test_torch_train.py's size (2
SRBs, hidden 8, STN, mask) and a CRNN teacher (the students its copies)
whose convolutions are scaled by 4 and output layer by 200, so that its
confidences depend on the image and straddle the cascade's 0.85 threshold
(a draw at torch's default ranges reads every image alike, at 0.03).  They
cross to the JAX package through its importers (``import_tsrn``,
``import_crnn``) and back through ``interop.from_jax``.

Tolerances: confidences at 1e-5; the gate's decision equal wherever the
JAX confidence lies more than that from the threshold (images nearer are
printed, not dropped); SR at 5e-4 (the full TSRN_TL's,
tests/test_torch_eval.py); accuracies and the gate's counts exactly, PSNR
and SSIM averages at 1e-4 relative (tests/test_torch_cli.py's)."""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.torch_modes import make_syn_lmdb
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu import config as jax_config
from tpgsr_tpu.interop import torch_import as ti
from tpgsr_tpu.train import random_reso as jax_rr
from tpgsr_tpu.train.priors import parse_crnn_data as jax_parse_crnn_data
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.trainer import TextSR as JaxTextSR
from tpgsr_tpu_torch import cli, config
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.data import collate, datasets
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.train import random_reso, trainer
from tpgsr_tpu_torch.train.priors import parse_crnn_data

SIZES = [(100, 32), (57, 20), (64, 16), (100, 32)]
ARGS = dict(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True, sr_share=True, stu_iter=1,
            srb=2, hd_u=8)
THRESHOLD = 0.85  # the cascade's (random_reso.conf_threshold_of)
CONF_ATOL = 1e-5
SR_ATOL = 5e-4
PSNR_SSIM_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sharpened_crnn(seed: int) -> CRNN:
    model = init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("cnn") and p.dim() == 4:
                p.mul_(4.0)
            elif name.startswith("rnn.1.embedding"):
                p.mul_(200.0)
    return model.eval()


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The LMDB, both packages' configs and ``TextSR``s with ``--syn
    --random_reso --go_test``, the port's drawn state and the JAX state on
    the same weights."""
    root = tmp_path_factory.mktemp("random_reso")
    crnn = _sharpened_crnn(7)
    crnn_path = str(root / "crnn.pth")
    torch.save(crnn.state_dict(), crnn_path)
    # images 0 and 2 labelled with what the teacher reads on their HR, so
    # that no accuracy is 0 by construction
    db = make_syn_lmdb(str(root / "syn"), SIZES, keys=("image", "image_hr"), png=True)
    items = [datasets.SingleImageLMDB(db, "all")[i] for i in range(len(SIZES))]
    with torch.no_grad():
        reads = [decode_crnn(crnn(parse_crnn_data(torch.from_numpy(hr)).permute(0, 3, 1, 2)))[0]
                 for hr in collate.collate_syn_random_reso(items, collate.CollateConfig(mask=True))["hr_list"]]
    labels = [r if i % 2 == 0 else w for i, (r, (_, w)) in enumerate(zip(reads, items))]
    db = make_syn_lmdb(str(root / "syn_labelled"), SIZES, keys=("image", "image_hr"), png=True, labels=labels)
    cfgs = []
    for pkg in (config, jax_config):
        cfg = pkg.load_config()
        t = cfg.TRAIN
        t.train_data_dir, t.VAL.val_data_dir = [db], [db]
        t.width, t.height, t.batch_size, t.workers, t.compute_dtype, t.n_devices = 64, 32, 4, 0, "fp32", 1
        t.VAL.crnn_pretrained, t.ckpt_dir = crnn_path, str(root / "ckpt")
        cfgs.append(cfg)
    args = dict(ARGS, syn=True, random_reso=True, go_test=True, vis_dir="rr")
    port = trainer.TextSR(cfgs[0], config.default_args(**args), device="cpu")
    state = port.init_state()
    sr_vars = _numpy_tree(ti.import_tsrn({k: v.numpy() for k, v in state.sr[0].state_dict().items()}, srb_nums=2))
    state.sr[0].load_state_dict(from_jax.tsrn_tl_state_dict(sr_vars, srb_nums=2))
    jax_mission = JaxTextSR(cfgs[1], jax_config.default_args(**args))
    teacher = ti.import_crnn(ti.load_torch_state_dict(crnn_path))
    jax_mission._state = jax_create_train_state(
        jax.random.PRNGKey(0), jax_mission.sr_model, (), sr_init_variables=sr_vars, stu_model=jax_mission.stu_model,
        n_stu=1, teacher_variables=teacher)
    return {"root": root, "db": db, "port": port, "jax": jax_mission}


def _port_applies(port):
    st = port._state

    def crnn(m):
        return lambda x: m(parse_crnn_data(x).permute(0, 3, 1, 2))

    def sr(lr, prior):
        return st.sr[0](lr.permute(0, 3, 1, 2), prior.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    for m in (*st.sr, *st.stu, st.teacher):
        m.eval()
    return crnn(st.stu[0]), sr, crnn(st.teacher)


def _jax_applies(jax_mission):
    """The JAX ``TextSR``'s closures (tpgsr_tpu/train/trainer.py:672-688):
    the student's and the teacher's CRNN, the SR model; each CRNN jitted
    once for its fixed 32x100 input (run eagerly, its LSTMs' scans compile
    again at every call)."""
    st, m = jax_mission._state, jax_mission

    def crnn(params, stats):
        net = jax.jit(lambda y: m.stu_model.apply({"params": params, "batch_stats": stats}, y, train=False))
        return lambda x: net(jax_parse_crnn_data(x))

    sr_v = {"params": st.sr_params[0], "batch_stats": st.sr_stats[0]}
    return (crnn(st.stu_params[0], st.stu_stats[0]), lambda lr, prior: m.sr_model.apply(sr_v, lr, prior, train=False),
            crnn(st.teacher_params, st.teacher_stats))


def _lr_list(shared):
    (loader,) = shared["port"].get_val_data()
    lrs = []
    for batch in loader:
        lrs += batch["lr_list"]
    return lrs


def _near_threshold(confs):
    near = [i for i, c in enumerate(confs) if abs(c - THRESHOLD) <= CONF_ATOL]
    if near:
        print(f"images within {CONF_ATOL} of the threshold {THRESHOLD}: {near}, confidences "
              f"{[confs[i] for i in near]}")
    return near


@pytest.fixture(scope="module")
def gated(shared):
    """``cal_conf`` and ``eval_random_reso`` of each package over the four LRs."""
    lrs = _lr_list(shared)
    assert [x.shape[1:3] for x in lrs] == [(h, w) for w, h in SIZES]
    stu, sr, _ = _port_applies(shared["port"])
    jax_stu, jax_sr, _ = _jax_applies(shared["jax"])
    with torch.no_grad():
        got = random_reso.cal_conf(lrs, stu, device="cpu"), random_reso.eval_random_reso(
            lrs, stu, sr, conf_threshold=THRESHOLD, device="cpu")
    want = jax_rr.cal_conf([x[0] for x in lrs], jax_stu), jax_rr.eval_random_reso(
        [x[0] for x in lrs], jax_stu, jax_sr, conf_threshold=THRESHOLD)
    return got, want


def test_cal_conf_matches_jax(gated):
    (confs, _), (want, _) = gated
    print("confidences", confs)
    np.testing.assert_allclose(confs, want, rtol=0, atol=CONF_ATOL)
    # the gate sees both sides of its threshold
    assert min(want) < THRESHOLD < max(c for c, (w, h) in zip(want, SIZES) if h > random_reso.MIN_HEIGHT)


def test_eval_random_reso_matches_jax(gated):
    """Each image's decision where the confidence clears the threshold by
    more than ``CONF_ATOL``, and each output (the kept LR, or the SR at twice
    the LR's size) at ``SR_ATOL``."""
    (_, (outs, stat)), (want_confs, (want_outs, want_stat)) = gated
    near = _near_threshold(want_confs)
    assert "LR" in want_stat and "SR" in want_stat
    for i, (got, want) in enumerate(zip(outs, want_outs)):
        if i in near:
            continue
        assert stat[i] == want_stat[i], i
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=SR_ATOL, err_msg=f"image {i}")


@pytest.fixture(scope="module")
def val_runs(shared):
    """``TextSR.train()`` with ``--syn --random_reso --go_test`` in each
    package: the JAX one's val dict recorded from ``_run_val``, the port's
    returned; then the port's ``evaluate_random_reso_loader`` on its own."""
    root = shared["root"]
    jax_mission, jax_vals = shared["jax"], []
    run_val = jax_mission._run_val
    jax_mission._run_val = lambda *a, **k: jax_vals.append(run_val(*a, **k)) or jax_vals[-1]
    for pkg in ("jax", "port"):
        (root / pkg).mkdir()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.chdir(root / "jax")
        jax_mission.train()
        mp.chdir(root / "port")
        port_go = shared["port"].train()
    stu, sr, rec = _port_applies(shared["port"])
    (loader,) = shared["port"].get_val_data()
    direct = random_reso.evaluate_random_reso_loader(loader, [stu], [sr], rec, decode_crnn, conf_threshold=THRESHOLD,
                                                     device="cpu")
    return jax_vals[0], port_go, direct


def _assert_metric_dicts_equal(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if k in ("psnr_avg", "ssim_avg"):
            np.testing.assert_allclose(got[k], v, rtol=PSNR_SSIM_RTOL, err_msg=k)
        else:
            assert got[k] == v, k


def test_evaluate_random_reso_loader_matches_jax(gated, val_runs):
    """The port's evaluator with the port's closures equals the JAX
    ``TextSR``'s ``evaluate_random_reso_loader`` (its counts of kept LRs and
    SRs among them); both gates see the same confidences."""
    (_, _), (want_confs, _) = gated
    jax_go, _, direct = val_runs
    (name, want), = jax_go.items()
    print("--random_reso", name, direct)
    assert not _near_threshold(want_confs)
    _assert_metric_dicts_equal(direct, want)
    assert direct["images"] == len(SIZES) and direct["go_LR"] > 0 and direct["go_SR"] > 0


def test_textsr_syn_random_reso_go_test_matches_jax(val_runs):
    """``TextSR.train()`` under ``--syn --random_reso --go_test`` returns the
    JAX ``TextSR``'s metric dict for the split."""
    jax_go, port_go, _ = val_runs
    assert list(port_go) == list(jax_go)
    for name, want in jax_go.items():
        _assert_metric_dicts_equal(port_go[name], want)


def test_random_reso_refusals_match_jax(shared):
    """``--syn --random_reso`` without ``--go_test``, and ``--random_reso``
    with a ``--test_model`` other than CRNN, raise the JAX package's
    ``ValueError``s: the port's when ``TextSR`` (or the CLI) is built, the JAX
    package's when it trains or validates."""
    cfg = config.load_config()
    cfg.TRAIN.update(train_data_dir=[shared["db"]], workers=0, batch_size=4)
    cfg.TRAIN.VAL.val_data_dir = [shared["db"]]
    for over, message in (({"syn": True}, "--random_reso with --syn is eval-only; run with --go_test"),
                          ({"test_model": "ASTER", "go_test": True},
                           "--random_reso eval supports --test_model=CRNN only")):
        args = dict(ARGS, random_reso=True, **over)
        with pytest.raises(ValueError) as port_err:
            trainer.TextSR(cfg, config.default_args(**args), device="cpu")
        with pytest.raises(ValueError, match="eval-only" if "syn" in over else "CRNN only"):
            cli.main(sum(([f"--{k}"] if v is True else [f"--{k}", str(v)] for k, v in args.items()), []),
                     device="cpu")
        jax_mission = JaxTextSR(jax_config.load_config(), jax_config.default_args(**args))
        with pytest.raises(ValueError) as jax_err:
            if over.get("syn"):
                jax_mission.train()
            else:
                jax_mission._run_val_random_reso(None, [])
        assert str(port_err.value) == str(jax_err.value) == message
