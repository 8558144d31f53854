"""What the data-parallel tests run on each spawned rank
(``tpgsr_tpu_torch.parallel.spawn``): functions of plain arguments that
import the port alone, so that a rank starts without JAX.  Each returns rank
0's results as numpy arrays and plain numbers; each checks first that the
ranks agree where data parallelism makes them equal."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpgsr_tpu_torch import parallel
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.tsrn import TSRN_TL
from tpgsr_tpu_torch.train.evaluate import evaluate
from tpgsr_tpu_torch.train.state import create_train_state
from tpgsr_tpu_torch.train.step import EvalModels, make_eval_step, make_train_step

# tests/test_torch_train.py's sizes: 2 SRBs, hidden 8, LR 16x32 -> HR 32x64
H, W = 16, 32
FLAGSHIP_ARGS = {"arch": "tsrn_tl_cascade", "STN": True, "mask": True, "use_distill": True, "gradient": True,
                 "sr_share": True, "stu_iter": 1, "srb": 2, "hd_u": 8}


def small_tsrn() -> TSRN_TL:
    return TSRN_TL(scale_factor=2, width=W * 2, height=H * 2, stn=True, mask=True, srb_nums=2, hidden_units=8)


def _numpy(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def same_on_every_rank(tensors, what: str) -> None:
    """Raise unless every rank holds ``tensors`` bit for bit."""
    if parallel.rank_and_world()[1] == 1:
        return
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(parallel.rank_and_world()[1])]
    dist.all_gather(parts, flat)
    if not all(torch.equal(p, parts[0]) for p in parts):
        raise RuntimeError(f"{what} differ between the ranks")


def batchnorm_case(x: np.ndarray, cot: np.ndarray, dtype: str, device=None):
    """A ``GlobalBatchNorm`` (weight, bias and running statistics away from
    their defaults) over this rank's rows of ``x``, loss sum(y * cot) on the
    rank's rows, parameter gradients averaged over the ranks: the whole
    output and input gradient (gathered), the parameter gradients, running
    statistics and count."""
    rank, world = parallel.rank_and_world()
    c = x.shape[1]
    bn = parallel.GlobalBatchNorm(c).to(device)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
        bn.running_mean.fill_(0.1)
        bn.running_var.fill_(2.0)
    bn.train()
    xt = torch.from_numpy(parallel.local_rows(x, rank, world)).to(device, getattr(torch, dtype)).requires_grad_(True)
    y = bn(xt)
    (y.float() * torch.from_numpy(parallel.local_rows(cot, rank, world)).to(device)).sum().backward()
    parallel.average_gradients(bn.parameters())
    n = x.shape[0]
    return {"y": parallel.gather_rows(y.detach().float(), n).cpu().numpy(),
            "x_grad": parallel.gather_rows(xt.grad.float(), n).cpu().numpy(),
            "weight_grad": bn.weight.grad.cpu().numpy(), "bias_grad": bn.bias.grad.cpu().numpy(),
            **_numpy({k: v for k, v in bn.state_dict().items() if k.startswith(("running", "num_batches"))}),
            "dtype": str(y.dtype)}


def batchnorm_cases(cases, device=None):
    """``batchnorm_case`` for each (name, x, cot, dtype)."""
    return {name: batchnorm_case(x, cot, dtype, device=device) for name, x, cot, dtype in cases}


def flagship_step(sr_sd, teacher_sd, batch, device=None):
    """The reduced flagship's train step from ``sr_sd`` / ``teacher_sd``
    (numpy) on
    this rank's slice of the global ``batch``: the global metrics, the
    models' ``state_dict`` and Adam's moments by parameter name
    ('sr.<name>', 'stu.<name>'), after checking that every rank holds the
    same parameters, statistics and moments."""
    rank, world = parallel.rank_and_world()
    sr = small_tsrn()
    sr.load_state_dict({k: torch.from_numpy(v) for k, v in sr_sd.items()})
    teacher = CRNN(nclass=CTC_NUM_CLASSES)
    teacher.load_state_dict({k: torch.from_numpy(v) for k, v in teacher_sd.items()})
    state = create_train_state([sr.to(device)], teacher.to(device), n_stu=1)
    parallel.replicate([*state.sr, *state.stu], [state.teacher], state.optimizer)
    step = make_train_step(FLAGSHIP_ARGS, width=W * 2, device=device)
    metrics = step(state, {k: parallel.local_rows(v, rank, world) for k, v in batch.items()})
    models = {"sr": state.sr[0], "stu": state.stu[0]}
    moments = {f"{kind}.{name}": [state.optimizer.state[p][k] for k in ("exp_avg", "exp_avg_sq")]
               for kind, m in models.items() for name, p in m.named_parameters()}
    same_on_every_rank([t for m in models.values() for t in m.state_dict().values()], "parameters and statistics")
    same_on_every_rank([t for pair in moments.values() for t in pair], "Adam's moments")
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "sr": _numpy(state.sr[0].state_dict()), "stu": _numpy(state.stu[0].state_dict()),
            "moments": {k: [t.cpu().numpy() for t in pair] for k, pair in moments.items()}, "step": state.step}


def eval_models(seed: int, device=None) -> EvalModels:
    """The reduced flagship's eval models drawn from ``seed``."""
    from tpgsr_tpu_torch.models.layers import init_torch_defaults_

    gen = torch.Generator().manual_seed(seed)
    sr, stu, teacher = (init_torch_defaults_(m, gen).to(device)
                        for m in (small_tsrn(), CRNN(nclass=CTC_NUM_CLASSES), CRNN(nclass=CTC_NUM_CLASSES)))
    return EvalModels(sr=[sr], stu=[stu], teacher=teacher).eval()


def evaluate_batches(seed: int, batches, device=None):
    """``evaluate`` of ``eval_models(seed)`` over ``batches``: its metric
    dict, after checking that every rank computed the same one."""
    md = evaluate(make_eval_step(FLAGSHIP_ARGS, W * 2, device=device), eval_models(seed, device), batches)
    keys = sorted(md)
    same_on_every_rank([torch.tensor([float(md[k]) for k in keys], dtype=torch.float64, device=device)],
                       "metric dicts")
    return md


def lapsrn_step(sd, batch, device=None):
    """``lapsrn``'s train step (its Charbonnier loss sums over the batch)
    from ``sd`` on this rank's slice of ``batch``: the metrics and the
    parameters after it."""
    rank, world = parallel.rank_and_world()
    from tpgsr_tpu_torch.models.lapsrn import LapSRN

    model = LapSRN(2, 3, False, W * 2, H * 2)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = create_train_state([model.to(device)], None, n_stu=0)
    metrics = make_train_step({"arch": "lapsrn"}, width=W * 2, device=device)(
        state, {k: parallel.local_rows(v, rank, world) for k, v in batch.items()})
    same_on_every_rank(list(model.state_dict().values()), "lapsrn's parameters")
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "sd": _numpy(model.state_dict())}


def gradient_reduction(device=None):
    """``average_gradients`` of a gradient of rank + 1 everywhere: the mean
    and the sum over the ranks."""
    rank = parallel.rank_and_world()[0]
    out = {}
    for average in (True, False):
        p = torch.nn.Parameter(torch.zeros(3, device=device))
        p.grad = torch.full((3,), float(rank + 1), device=device)
        parallel.average_gradients([p], average=average)
        out["mean" if average else "sum"] = p.grad.cpu().tolist()
    return out


def suite(bn_cases, sr_sd, teacher_sd, batch, eval_seed, eval_batches, lapsrn_sd, device=None):
    """One group's share of the tests, by name: ``batchnorm_cases``,
    ``flagship_step``, ``evaluate_batches``, ``lapsrn_step`` (on ``batch``'s
    RGB) and ``gradient_reduction``."""
    return {"batchnorm": batchnorm_cases(bn_cases, device=device),
            "step": flagship_step(sr_sd, teacher_sd, batch, device=device),
            "evaluate": evaluate_batches(eval_seed, eval_batches, device=device),
            "lapsrn": lapsrn_step(lapsrn_sd, {k: v[..., :3] for k, v in batch.items()}, device=device),
            "reduction": gradient_reduction(device=device)}


def fail_on_rank_one(device=None):
    """Rank 1 raises; rank 0 waits at a barrier for it."""
    if parallel.rank_and_world()[0] == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def torchrun_rank(rank: int, world: int, port: int, workdir: str, argv, results) -> None:
    """One process as torchrun starts it (``torchrun_env``), in its own
    working directory, running ``cli.main(argv, device="cpu")``; reports
    (rank, True, its result) or (rank, False, traceback).  TensorBoard stays
    out, as in the test process."""
    import os
    import sys
    import traceback

    sys.modules["torch.utils.tensorboard"] = None
    os.environ.update(torchrun_env(rank, world, port))
    try:
        from tpgsr_tpu_torch import cli

        os.chdir(workdir)
        results.put((rank, True, cli.main(argv, device="cpu")))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def torchrun_env(rank: int, world: int, port: int) -> dict:
    """What torchrun sets for the process of ``rank`` on one host, whose
    agent holds the group's store at ``port`` (TORCHELASTIC_USE_AGENT_STORE:
    every rank joins that store as a client)."""
    return dict(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), TORCHELASTIC_USE_AGENT_STORE="True", OMP_NUM_THREADS="1")
