"""How far fp32 lies from fp64 in the zoo's gradients, on the CPU: the
measurements behind two bounds, run as ``python -m tests.torch_fp64_noise``.

* ``prelu_noise``: one SRResNet forward and backward (``srres``, full width,
  batch 16, MSE x 100) in fp32 and in fp64 from the same seeded weights and
  batch: each parameter's gradient error relative to its own norm, and its
  norm relative to the model's.  SRResNet's PReLU slopes after BatchNorm
  cancel to a sliver of the model's gradient, which is why
  ``chip_smoke.py`` phase 13 adds 1e-6 of the model's norm to each
  tensor's bound.
* ``cascade_student_noise``: one ``srresnet_tl`` train step at
  ``--stu_iter=3`` (tests/test_torch_zoo_train.py's sizes and weights) in
  the port's fp32, the port's fp64 and the JAX package's fp32: Adam's first
  moments of the three students, which is why that file holds them at
  ``CASCADE_STUDENT_RTOL``.
* ``srcnn_tl_distill_noise``: the first three iterations of ``TextSR`` for
  ``srcnn_tl`` (tests/test_torch_zoo_trainer.py's run: its LMDB, CRNN,
  flags, sizes and SR weights) in the port's fp32, the port's fp64 and the
  JAX package's fp32: each step's losses, which is why that file holds
  ``loss_distill`` at the late bound from step 3 (``DISTILL_LATE_FROM``).
* ``vdsr_tl_student_update_noise``: one ``vdsr_tl`` train step
  (tests/test_torch_tl_simple.py's sizes, weights and flags) in the port's
  fp32, the port's fp64 and the JAX package's fp32: the student's first
  Adam update (lr times the sign of its gradient, near enough, where that
  gradient is far above Adam's eps) against the fp64 one, which is why that
  file holds it at ``STUDENT_UPDATE_RTOL``.
* ``opt_train_forward_noise``: the ``--tpg OPT`` model's train-mode forward
  (tests/test_torch_zoo_last.py's weights and input) in the port's fp32, the
  port's fp64 and the JAX package's fp32: the logits' largest error, which
  is why that file holds the train-mode logits at ``OPT_TRAIN_ATOL``
  (BatchNorm over 2 x 17 values a channel in the last layers).
* ``opt_flagship_step``: one step of the flagship with ``--tpg OPT`` at
  ``--stu_iter 2`` (tests/test_torch_zoo_last_train.py's sizes, weights and
  batch) in the port's fp32, the port's fp64 and the JAX package's fp32:
  the losses and the first moments of the SR model and the two students,
  which is why that file holds that path at ``OPT_LOSS_RTOL`` and
  ``OPT_MOMENT_RTOL``.
* ``opt_student_full_width_noise``: ``chip_smoke.py`` phase 16(a)'s OPT
  flagship train step (full width, OPT at 512 channels, batch 8, its
  weights and batch) in the port's fp32 and fp64 on the CPU: each model's
  gradient error relative to its norm and the worst tensor's, which is why
  phase 16 holds the OPT student's card-against-CPU gradient at
  ``OPT_STUDENT_GRAD_TOL`` and each SR tensor's at ``OPT_SR_TENSOR_TOL``.

Prints one JSON object a line."""

import tests.conftest  # noqa: F401  (first: JAX on the CPU at the highest matmul precision)

import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import torch

from tests import test_torch_zoo_train as zt
from tpgsr_tpu_torch.losses import mse_loss
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.registry import build_model
from tpgsr_tpu_torch.train import step as port_step


def prelu_noise(batch: int = 16, top: int = 6):
    model, spec = build_model("srres", {"STN": False, "mask": True, "srb": 5, "hd_u": 32},
                              {"scale_factor": 2, "width": 128, "height": 32})
    init_torch_defaults_(model, torch.Generator().manual_seed(0)).train()
    rng = np.random.default_rng(13)
    lr, hr = rng.random((batch, 4, 16, 64), dtype=np.float32), rng.random((batch, 4, 32, 128), dtype=np.float32)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = model.to(dtype)
        m.zero_grad()
        (mse_loss(m(torch.from_numpy(lr).to(dtype)), torch.from_numpy(hr).to(dtype)) * 100).backward()
        grads[dtype] = {k: p.grad.double().clone() for k, p in m.named_parameters()}
    ref = grads[torch.float64]
    total = float(torch.sqrt(sum(g.pow(2).sum() for g in ref.values())))
    rows = sorted(((float((grads[torch.float32][k] - g).norm() / g.norm()), float(g.norm()) / total, k)
                   for k, g in ref.items() if not zt.PRE_BN_BIAS.search(k)), reverse=True)[:top]
    return [{"param": k, "fp32_vs_fp64_rel_err": e, "norm_over_model_norm": n} for e, n, k in rows]


def cascade_student_noise():
    arch = "srresnet_tl"
    _, _, state0 = zt._jax(arch)
    jax_state, _ = zt._jax_step(arch, "fp32")
    ports = {}
    with pytest_free_patch() as patch:
        patch(port_step.COMPUTE_DTYPES, "fp64", torch.float64)
        for name in ("fp32", "fp64"):
            port = zt._port_state(arch, state0)
            if name == "fp64":
                for m in (*port.sr, *port.stu, port.teacher):
                    m.double()
                port.optimizer = torch.optim.Adam([p for m in (*port.sr, *port.stu) for p in m.parameters()],
                                                  lr=zt.LR, betas=(0.5, 0.999))
            port_step.make_train_step(zt._args(arch), width=2 * zt.W, device="cpu", compute_dtype=name)(
                port, zt._batch(0))
            ports[name] = port
    out = []
    for i in range(len(ports["fp32"].stu)):
        moments = {}
        for name, port in ports.items():
            named = dict(port.stu[i].named_parameters())
            moments[name] = {n: port.optimizer.state[p]["exp_avg"].float() for n, p in named.items()
                             if not zt.PRE_BN_BIAS.search(n)}
        jax_mu = zt._to_sd(arch, "stu")(jax_state.opt_state[0].mu["stu"][i], jax_state.stu_stats[i])
        want = moments["fp64"]
        out.append({"student": i,
                    "port_fp32_vs_port_fp64": zt._rel([(moments["fp32"][n], want[n]) for n in want]),
                    "jax_fp32_vs_port_fp64": zt._rel([(jax_mu[n], want[n]) for n in want]),
                    "port_fp32_vs_jax_fp32": zt._rel([(moments["fp32"][n], jax_mu[n]) for n in want])})
    return out


def vdsr_tl_student_update_noise():
    from tests import test_torch_tl_simple as tl

    case = "vdsr_tl"
    _, state0 = tl._jax(case)
    jax_state, _ = tl._jax_step(case, "fp32")
    updates = {}
    with pytest_free_patch() as patch:
        patch(port_step.COMPUTE_DTYPES, "fp64", torch.float64)
        for name in ("fp32", "fp64"):
            port = tl._port_state(case, state0)
            if name == "fp64":
                for m in (*port.sr, *port.stu, port.teacher):
                    m.double()
                port.optimizer = torch.optim.Adam([p for m in (*port.sr, *port.stu) for p in m.parameters()],
                                                  lr=tl.LR, betas=(0.5, 0.999))
            init = {n: p.detach().double().clone() for n, p in port.stu[0].named_parameters()}
            port_step.make_train_step(tl._args(case), width=2 * tl.W, device="cpu", compute_dtype=name)(
                port, tl._batch(0))
            updates[name] = {n: p.detach().double() - init[n] for n, p in port.stu[0].named_parameters()
                             if not zt.PRE_BN_BIAS.search(n)}
    jax_sd = tl._to_sd(case, "stu")(jax_state.stu_params[0], jax_state.stu_stats[0])
    init = tl._to_sd(case, "stu")(state0.stu_params[0], state0.stu_stats[0])
    jax_update = {n: jax_sd[n].double() - init[n].double() for n in updates["fp64"]}
    want = updates["fp64"]
    return {"port_fp32_vs_port_fp64": tl._rel([(updates["fp32"][n], want[n]) for n in want]),
            "jax_fp32_vs_port_fp64": tl._rel([(jax_update[n], want[n]) for n in want]),
            "port_fp32_vs_jax_fp32": tl._rel([(updates["fp32"][n], jax_update[n]) for n in want])}


def _recording(step, log, metrics_of=lambda out: out):
    def recorded(*a, **k):
        out = step(*a, **k)
        log.append({n: float(v) for n, v in metrics_of(out).items()})
        return out

    return recorded


def srcnn_tl_distill_noise(steps: int = 3):
    import tempfile

    import jax
    from flax.core import unfreeze

    from tests import test_torch_zoo_trainer as zt_trainer
    from tests.test_torch_cli import _relabelled_lmdb
    from tpgsr_tpu import config as jax_config
    from tpgsr_tpu.train.trainer import TextSR as JaxTextSR
    from tpgsr_tpu_torch import config
    from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
    from tpgsr_tpu_torch.interop import from_jax
    from tpgsr_tpu_torch.models.crnn import CRNN
    from tpgsr_tpu_torch.train import trainer

    arch = "srcnn_tl"
    args = dict(zt_trainer.ARGS[arch], srb=2, hd_u=8, batch_size=zt_trainer.B, vis_dir="run")
    losses = {}
    with tempfile.TemporaryDirectory() as root, contextlib.redirect_stdout(io.StringIO()):
        teacher_path = os.path.join(root, "crnn.pth")
        torch.save(init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), torch.Generator().manual_seed(7)).state_dict(),
                   teacher_path)
        db = _relabelled_lmdb(Path(root), teacher_path)
        # val and saves after the compared steps
        over = dict(epochs=2, interval=100)
        jax_cfg = zt_trainer._configure(jax_config.load_config(), db, teacher_path, os.path.join(root, "jax"), **over)
        jax_cfg.TRAIN.dispatch_chain, jax_cfg.TRAIN.n_devices = 1, 1
        jax_mission = JaxTextSR(jax_cfg, jax_config.default_args(**args))
        cwd = os.getcwd()
        os.chdir(root)
        try:
            state = jax_mission.init_state()
            sr_vars = jax.tree_util.tree_map(np.asarray, unfreeze({"params": state.sr_params[0],
                                                                    "batch_stats": state.sr_stats[0]}))
            jax_mission._build_steps()
            jax_mission._train_step = _recording(jax_mission._train_step, losses.setdefault("jax_fp32", []),
                                                 lambda out: out[1])
            jax_mission.train()
            with pytest_free_patch() as patch:
                patch(port_step.COMPUTE_DTYPES, "fp64", torch.float64)
                for name in ("fp32", "fp64"):
                    cfg = zt_trainer._configure(config.load_config(), db, teacher_path, os.path.join(root, name), **over)
                    cfg.TRAIN.workers, cfg.TRAIN.compute_dtype = 0, name
                    port = trainer.TextSR(cfg, config.default_args(**args), device="cpu")
                    port_state = port.init_state()
                    port_state.sr[0].load_state_dict(from_jax.sr_state_dict(arch, sr_vars, srb_nums=2))
                    if name == "fp64":
                        for m in (*port_state.sr, *port_state.stu, port_state.teacher):
                            m.double()
                    port._build_steps()
                    port._train_step = _recording(port._train_step, losses.setdefault(f"port_{name}", []))
                    port.train()
        finally:
            os.chdir(cwd)
    out = []
    ref = losses["port_fp64"]
    for k in range(steps):
        row = {"step": k + 1}
        for loss in ("loss_distill", "loss_img", "loss_total"):
            want = ref[k][loss]
            row[loss] = {"port_fp64": want,
                         "port_fp32_vs_port_fp64": abs(losses["port_fp32"][k][loss] - want) / abs(want),
                         "jax_fp32_vs_port_fp64": abs(losses["jax_fp32"][k][loss] - want) / abs(want),
                         "port_fp32_vs_jax_fp32": abs(losses["port_fp32"][k][loss] - losses["jax_fp32"][k][loss])
                         / abs(losses["jax_fp32"][k][loss])}
        out.append(row)
    return out


def opt_train_forward_noise():
    from tests import test_torch_zoo_last as zl
    from tpgsr_tpu_torch.interop import from_jax
    from tpgsr_tpu_torch.models.opt_tpg import OPTModel

    v, x, _, jax_train, _ = zl._opt()
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = OPTModel(37, zl.OPT_CHANNELS)
        model.load_state_dict(from_jax.opt_state_dict(v))
        out[dtype] = model.to(dtype).train()(zl.nchw(x).to(dtype)).detach().double().numpy()
    ref = out[torch.float64]
    return {"port_fp32_vs_port_fp64": float(np.abs(out[torch.float32] - ref).max()),
            "jax_fp32_vs_port_fp64": float(np.abs(jax_train - ref).max()),
            "port_fp32_vs_jax_fp32": float(np.abs(out[torch.float32] - jax_train).max()),
            "max_abs_logit": float(np.abs(ref).max())}


def opt_step_noise():
    from tests import test_torch_zoo_last_train as lt

    from tpgsr_tpu_torch.ops import gru_seq

    path = "opt"
    _, _, state0 = lt._jax(path)
    jax_state, jax_metrics = lt._jax_step(path, "fp32")
    ports, metrics = {}, {}
    check = gru_seq._check
    # K1's plain recurrence on the CPU runs fp64 too; its wrapper's check takes fp32 and bf16
    gru_seq._check = lambda x, fw, bw: None if x.dtype == torch.float64 else check(x, fw, bw)
    with contextlib.ExitStack() as undo, pytest_free_patch() as patch:
        undo.callback(setattr, gru_seq, "_check", check)
        patch(port_step.COMPUTE_DTYPES, "fp64", torch.float64)
        for name in ("fp32", "fp64"):
            port = lt._port_state(path, state0)
            if name == "fp64":
                for m in (*port.sr, *port.stu, port.teacher):
                    m.double()
                port.optimizer = torch.optim.Adam([p for m in (*port.sr, *port.stu) for p in m.parameters()],
                                                  lr=lt.LR, betas=(0.5, 0.999))
            out = port_step.make_train_step(lt._args(path), width=2 * lt.W, device="cpu", compute_dtype=name)(
                port, lt._batch(0))
            ports[name], metrics[name] = port, {k: float(v) for k, v in out.items()}
    row = {"losses": {k: {"port_fp32_vs_port_fp64": abs(metrics["fp32"][k] - v) / abs(v),
                          "jax_fp32_vs_port_fp64": abs(float(jax_metrics[k]) - v) / abs(v)}
                      for k, v in metrics["fp64"].items()}}
    for kind, i in [("sr", 0)] + [("stu", i) for i in range(len(ports["fp32"].stu))]:
        moments = {}
        for name, port in ports.items():
            m = port.sr[i] if kind == "sr" else port.stu[i]
            moments[name] = {n: port.optimizer.state[p]["exp_avg"].float() for n, p in m.named_parameters()
                             if not zt.PRE_BN_BIAS.search(n)}
        stats = jax_state.sr_stats[i] if kind == "sr" else jax_state.stu_stats[i]
        jax_mu = lt._to_sd(path, kind)(jax_state.opt_state[0].mu[kind][i], stats)
        want = moments["fp64"]
        row[f"{kind}{i}_first_moment"] = {
            "port_fp32_vs_port_fp64": zt._rel([(moments["fp32"][n], want[n]) for n in want]),
            "jax_fp32_vs_port_fp64": zt._rel([(jax_mu[n], want[n]) for n in want]),
            "port_fp32_vs_jax_fp32": zt._rel([(moments["fp32"][n], jax_mu[n]) for n in want])}
    return row


def opt_student_full_width_noise():
    import chip_smoke
    from tpgsr_tpu_torch.ops import gru_seq
    from tpgsr_tpu_torch.profile_zoo import mission

    batch = chip_smoke.with_aux(chip_smoke.synthetic_batch(np.random.default_rng(16),
                                                           chip_smoke.CARD_VS_CPU_TRAIN_BATCH, labels=False))
    grads = {}
    check = gru_seq._check
    gru_seq._check = lambda x, fw, bw: None if x.dtype == torch.float64 else check(x, fw, bw)
    with contextlib.ExitStack() as undo, pytest_free_patch() as patch:
        undo.callback(setattr, gru_seq, "_check", check)
        patch(port_step.COMPUTE_DTYPES, "fp64", torch.float64)
        for name in ("fp32", "fp64"):
            m, state, _ = mission(chip_smoke.LAST_PATHS["opt"], "fp32", device="cpu")
            if name == "fp64":
                for mod in (*state.sr, *state.stu, state.teacher):
                    mod.double()
                state.optimizer = torch.optim.Adam([p for mm in (*state.sr, *state.stu) for p in mm.parameters()])
            port_step.make_train_step(m.args, 128, device="cpu", compute_dtype=name)(state, batch)
            grads[name] = {f"{kind}{i}": {k: p.grad.double().clone() for k, p in mm.named_parameters()}
                           for kind, models in (("sr", state.sr), ("stu", state.stu)) for i, mm in enumerate(models)}
    out = {}
    for model, want in grads["fp64"].items():
        got = grads["fp32"][model]
        keys = [k for k in want if not zt.PRE_BN_BIAS.search(k) and not chip_smoke.PRE_BN_BIAS.search(k)]
        total = float(torch.sqrt(sum(want[k].pow(2).sum() for k in keys)))
        out[model] = {"fp32_vs_fp64_rel_err": float(torch.sqrt(sum((got[k] - want[k]).pow(2).sum() for k in keys)))
                      / total,
                      "worst_tensor_rel_err": max(float((got[k] - want[k]).norm() / want[k].norm()) for k in keys)}
    return out


@contextlib.contextmanager
def pytest_free_patch():
    """Set dict entries for the block, with the step's autocast context off
    for fp64 (autocast takes no fp64); everything restored after."""
    undo = []
    real_context = port_step.compute_context

    def patch(mapping, key, value):
        undo.append((mapping, key, mapping.get(key)))
        mapping[key] = value

    port_step.compute_context = (lambda dev, dtype: contextlib.nullcontext() if dtype == torch.float64
                                 else real_context(dev, dtype))
    try:
        yield patch
    finally:
        port_step.compute_context = real_context
        for mapping, key, value in reversed(undo):
            if value is None:
                mapping.pop(key, None)
            else:
                mapping[key] = value


if __name__ == "__main__":
    torch.set_num_threads(8)
    for row in prelu_noise():
        print(json.dumps({"srres_fp32_vs_fp64": row}), flush=True)
    for row in cascade_student_noise():
        print(json.dumps({"srresnet_tl_students": row}), flush=True)
    for row in srcnn_tl_distill_noise():
        print(json.dumps({"srcnn_tl_trainer": row}), flush=True)
    print(json.dumps({"vdsr_tl_student_update": vdsr_tl_student_update_noise()}), flush=True)
    print(json.dumps({"opt_train_forward": opt_train_forward_noise()}), flush=True)
    print(json.dumps({"opt_flagship_step": opt_step_noise()}), flush=True)
    print(json.dumps({"opt_student_full_width": opt_student_full_width_noise()}), flush=True)
