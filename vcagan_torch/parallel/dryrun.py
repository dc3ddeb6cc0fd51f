"""The parallel equivalence gate: D x M ranks against one process.

Port of ``vcagan/parallel/dryrun.py:51-233``.  One train step on a world
of D data x M model ranks (``--model_parallel M``; by default the JAX
gate's choice, ``vcagan/parallel/dryrun.py:64``: 2 where the world is at
least 4 and even, else 1), each data rank on its rows of the global batch
and each model rank holding its columns of the four split attention
projections (``vcagan_torch/parallel/shard.py``), must reproduce one step
of a single process on the whole batch, up to reassociation: the same
problem (the JAX gate's shapes: 20 frames of 24 x 24, the default
``TrainConfig``, the batch made with numpy from the seed, 2 clips a data
rank unless ``--batch`` says otherwise), the same weights
(``VCAGANModules.create(seed=...)``, split after the init) and the same
step generator.

    python -m vcagan_torch.parallel.dryrun --world 2 --device cpu --backend gloo
    python -m vcagan_torch.parallel.dryrun --world 4 --model_parallel 2 --device cpu --backend gloo

runs the single process in a process of its own (on the card first, so
that its memory is given back before the ranks start; on the CPU beside
them), and the N ranks (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` set as
``torchrun`` sets them), each with a wall-clock limit that kills every
process when it runs out or when one fails.  It prints one JSON line with
the deltas and exits 0 when ``compare`` passes:

- the metrics to ``METRIC_RTOL`` relative and the per-leaf mean|p| of the
  updated generator-side parameters within 2.5 x lr, the JAX gate's
  tolerances unchanged (an Adam update is about lr x sign(g); a gradient
  within reassociation noise of 0 may flip its sign: at most 2 lr an
  element);
- the reduced gradients of the step, read through the optimizers' first
  moments ((1 - b1)(g + wd p) after one step from the same p): each
  module's to ``MODULE_GRAD_RTOL`` relative L2, and in the float64 step
  each leaf's to ``GRAD_RTOL`` (relative to at least ``LEAF_FLOOR`` of its
  module's norm);
- the split leaves: each rank's columns, concatenated in model-rank
  order, are the leaf held to the bounds above (its mean|p| and its first
  moment);
- the replicated parameters, BatchNorm statistics and optimizer states of
  all ranks equal bit for bit, and the split leaves and their moments of
  the ranks of one model index equal bit for bit;
- the attention: 2 calls a rank at the rank's batch (B / D).

``--profile`` times one more step on each rank under ``torch.profiler``:
the wall ms of the step and the host and device ms of the collectives'
``model_axis.*`` and ``data_axis.*`` ranges (``collectives.py``).

Nothing compiles here, so the comparison runs live each time: the JAX
gate's XLA machinery (``canonical_hash`` of the lowered program, the golden
JSON, the seeded compile cache) has nothing to port.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vcagan_torch import tracing
from vcagan_torch.configs import ModelConfig, TrainConfig
from vcagan_torch.nn.attention import AVAttention
from vcagan_torch.nn.generator import Decoder
from vcagan_torch.parallel.shard import ModelSplit
from vcagan_torch.train import Batch, VCAGANModules, create_train_state, make_train_step
from vcagan_torch.train.models import DISCRIMINATOR_SIDE, GENERATOR_SIDE

AXIS_RANGES = ("model_axis.gather_columns", "model_axis.input_gradient_sum",
               "model_axis.norm_sum", "data_axis.all_reduce_sum", "data_axis.gradient_mean")

METRIC_RTOL = 5e-4
LEAF_LR_BOUND = 2.5  # x lr, per leaf of mean|p|
GRAD_RTOL = 1e-5
# A leaf's relative L2 is taken against at least LEAF_FLOOR of its module's
# norm.  A leaf whose exact gradient is 0 (a convolution's bias ahead of a
# train-mode BatchNorm; the attention's key bias, which shifts all the
# scores of a row alike) holds nothing but rounding noise: at most 3.1e-17
# of its module's norm in the float64 gates at the narrow widths, 2 x 1
# and 2 x 2.  Under the JAX package's initialisation its first
# moment (1 - b1)(g + wd p) is that noise alone, the biases starting at 0,
# so no relative bound holds it; the floor holds it to GRAD_RTOL x
# LEAF_FLOOR = 1e-16 of its module, float64's rounding.  Every leaf with a
# gradient lies far above the floor (the smallest, gen.att2.q.bias, at
# 1e-5 of its module), where the floor changes nothing.
LEAF_FLOOR = 1e-11
# Each module's gradient, relative L2: the bound of the fp32 step card
# against CPU (chip_smoke.py STEP_GRAD_REL; the train-mode BatchNorm stack
# leaves fp32 gradients about 3e-3 a leaf from float64).  A module's sum
# dilutes the leaves that hold nothing but that noise (a convolution's bias
# ahead of a train-mode BatchNorm), which a leaf's bound cannot in fp32.
MODULE_GRAD_RTOL = 2e-2
FRAMES, IMAGE = 20, 24
CLIPS_PER_RANK = 2  # a data rank
STEP_SEED = 1  # the step generator's seed (the JAX gate's PRNGKey(1))
# The narrow widths of the port's CPU tests (tests/test_torch_train_step.py).
NARROW = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
              attention_inner=160, postnet_channels=32, disc_base_channels=8,
              disc_max_channels=32)


def to_float64(modules: VCAGANModules) -> VCAGANModules:
    """Every parameter, statistic and compute dtype in float64 (the exact
    check; the optimizer states follow at ``create_train_state``)."""
    for _, module in modules.named():
        module.double()
        for sub in module.modules():
            if hasattr(sub, "compute_dtype"):
                sub.compute_dtype = torch.float64
            if isinstance(sub, Decoder):
                sub.dtype = torch.float64
    return modules


def build_problem(world: int, seed: int = 0, batch: Optional[int] = None,
                  frames: int = FRAMES, image: int = IMAGE, model: Optional[dict] = None,
                  device="cpu", float64: bool = False, model_parallel: int = 1,
                  layout=None) -> dict:
    """Modules, train state, optimizers and the global batch (numpy) of the
    gate; the same arguments give the same problem in every process.
    ``batch`` defaults to ``CLIPS_PER_RANK`` clips a data rank.  Under
    ``layout`` the modules keep this rank's columns of the split leaves,
    cut after the seeded init (``problem["split"]``)."""
    cfg = TrainConfig()
    data = world // model_parallel
    b = batch or CLIPS_PER_RANK * data
    if b % data:
        raise ValueError(f"batch {b} is not divisible by {data} data ranks")
    modules = VCAGANModules.create(ModelConfig(**(model or {})), seed=seed)
    if float64:
        to_float64(modules)
    split = None
    if layout is not None:
        split = ModelSplit(modules, layout)
        split.split_()
    state, g_tx, d_tx = create_train_state(modules, cfg, steps_per_epoch=10, device=device)
    rng = np.random.default_rng(seed)
    real = np.float64 if float64 else np.float32
    arrays = dict(
        video=rng.standard_normal((b, frames, image, image, 1)).astype(real),
        mel=np.clip(rng.standard_normal((b, 80, 4 * frames)), -1, 1).astype(real),
        spec=np.abs(rng.standard_normal((b, 321, 4 * frames))).astype(real),
        vid_len=np.full((b,), frames, np.int32),
        mel_len=np.full((b,), 4 * frames, np.int32),
    )
    return dict(modules=modules, cfg=cfg, state=state, g_tx=g_tx, d_tx=d_tx, arrays=arrays,
                device=torch.device(device), split=split)


def problem_batch(problem: dict, rows: slice = slice(None)) -> Batch:
    a, dev = problem["arrays"], problem["device"]
    return Batch(*(torch.from_numpy(a[k][rows]).to(dev)
                   for k in ("video", "mel", "spec", "vid_len", "mel_len")))


def g_param_leaf_stats(modules: VCAGANModules) -> Dict[str, float]:
    """Per-leaf mean(|p|) of the generator-side parameters, float64."""
    return {f"{name}.{key}": float(p.detach().double().abs().mean())
            for name, module in modules.named(GENERATOR_SIDE)
            for key, p in module.named_parameters()}


def state_tensors(state, split: Optional[ModelSplit] = None) -> List[torch.Tensor]:
    """Every tensor of the train state (parameters, BatchNorm statistics and
    both optimizers' moments) but ``split``'s leaves and their moments."""
    names = {f"{leaf.module}.{leaf.key}" for leaf in split.leaves} if split else set()
    index = set(split.index) if split else set()
    tensors = [t for m, sd in sorted(state.modules.state_dicts().items())
               for k, t in sorted(sd.items()) if f"{m}.{k}" not in names]
    for opt, skip in ((state.g_opt_state, index), (state.d_opt_state, set())):
        for moments in (opt.mu, opt.nu, opt.nu_max or []):
            tensors += [t for i, t in enumerate(moments) if i not in skip]
    return tensors


def split_tensors(state, split: Optional[ModelSplit]) -> List[torch.Tensor]:
    """The split leaves of the train state and their moments."""
    if split is None:
        return []
    g = state.g_opt_state
    return [t for leaf, i in zip(split.leaves, split.index)
            for t in (leaf.linear.weight, g.mu[i], g.nu[i], *([g.nu_max[i]] if g.nu_max else []))]


def digest(tensors: Sequence[torch.Tensor], *extra) -> str:
    """sha256 over the tensors' bytes and ``extra``'s strings."""
    h = hashlib.sha256()
    for x in extra:
        h.update(str(x).encode())
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_digest(state, split: Optional[ModelSplit] = None) -> str:
    """sha256 over ``state_tensors(state, split)`` and the counts."""
    counts = (state.g_opt_state.count, state.d_opt_state.count, state.step)
    return digest(state_tensors(state, split), *counts)


def profile_step(step, state, batch, generator, device) -> dict:
    """One more step under ``torch.profiler``, tracing's ranges on: its wall
    ms, and the host and device ms of each of ``AXIS_RANGES``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with tracing.enabled(device_events=False), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, batch, generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    out = {"step_ms": wall * 1e3, **{name: None for name in AXIS_RANGES}}
    for e in prof.key_averages():  # a range is a host entry and, on the card, a device one
        name = e.key[len(tracing.PREFIX):]
        if not e.key.startswith(tracing.PREFIX) or name not in AXIS_RANGES:
            continue
        r = out[name] or dict(calls=0, host_ms=0.0, device_ms=0.0)
        if e.device_type == torch.autograd.DeviceType.CPU:
            r["calls"] += e.count
            r["host_ms"] += e.cpu_time_total / 1e3
        r["device_ms"] = max(r["device_ms"], getattr(e, "device_time_total", 0.0) / 1e3)
        out[name] = r
    return out


def run_step(problem: dict, rows: slice = slice(None), layout=None,
             profile: bool = False, knobs: Optional[dict] = None) -> dict:
    """One step of the problem on ``rows`` of its batch (under ``layout``
    where given, with ``make_train_step``'s ``knobs``, e.g. ``remat`` and
    ``d_phase``); its metrics, leaf statistics, first moments (on the
    host), the split leaves' columns (``split``), the digests of the
    replicated state and of the split leaves with their moments, the
    attention's calls (kernel shape (B, T, S, D) each), the calls that
    launched its kernel (``attention_calls``) and,
    on the card, the peak of allocated memory; with ``profile``,
    ``profile_step``'s readings of one more step."""
    modules, split = problem["modules"], problem["split"]
    calls: List[list] = []

    def count(module, inputs, _):
        sent, g = inputs[0], inputs[1]
        calls.append([g.shape[0], g.shape[3], sent.shape[1], module.k.out_features])

    hooks = [m.register_forward_hook(count) for m in modules.gen.modules()
             if isinstance(m, AVAttention)]
    step = make_train_step(modules, problem["g_tx"], problem["d_tx"], problem["cfg"],
                           mesh=layout, **(knobs or {}))
    generator = torch.Generator(problem["device"]).manual_seed(STEP_SEED)
    before = tracing.counters().get("attention.calls", 0)
    try:
        state, metrics = step(problem["state"], problem_batch(problem, rows), generator)
        metrics = {k: float(v) for k, v in metrics.items()}
    finally:
        for hook in hooks:
            hook.remove()
    kernel_calls = tracing.counters().get("attention.calls", 0) - before
    moments = [t.detach().to("cpu", copy=True)
               for t in state.g_opt_state.mu + state.d_opt_state.mu]
    names = [f"{n}.{k}" for side in (GENERATOR_SIDE, DISCRIMINATOR_SIDE)
             for n, module in modules.named(side) for k, _ in module.named_parameters()]
    split_names = [f"{leaf.module}.{leaf.key}" for leaf in split.leaves] if split else []
    sliced = split_tensors(state, split)
    out = dict(metrics=metrics, g_stats=g_param_leaf_stats(modules),
               moments=dict(zip(names, moments)),
               split={n: getattr(modules, n.split(".", 1)[0]).get_parameter(
                   n.split(".", 1)[1]).detach().to("cpu", copy=True) for n in split_names},
               digest=state_digest(state, split), split_digest=digest(sliced),
               attention=calls, attention_calls=kernel_calls, lr=problem["cfg"].lr,
               model=1 if layout is None else layout.model,
               peak_bytes=(torch.cuda.max_memory_allocated(problem["device"])
                           if problem["device"].type == "cuda" else None))
    if profile:
        out["profile"] = profile_step(step, state, problem_batch(problem, rows), generator,
                                      problem["device"])
    return out


class GateFailed(AssertionError):
    """The ranks' step is not the single process's."""


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise GateFailed(msg)


def _rel_l2(got: List[torch.Tensor], want: List[torch.Tensor], floor: float = 0.0) -> float:
    """Relative L2 of ``got`` from ``want``, against at least ``floor``."""
    num = sum(float((g.double() - w.double()).square().sum()) for g, w in zip(got, want))
    den = sum(float(w.double().square().sum()) for w in want)
    return (num / max(den, floor ** 2, 1e-60)) ** 0.5


def compare(reference: dict, ranks: List[dict], grad_rtol: Optional[float] = None) -> dict:
    """Check that the ranks' step is the reference's (raises ``GateFailed``);
    returns the deltas.  Each module's gradient is held to
    ``MODULE_GRAD_RTOL``; each leaf's to ``grad_rtol`` where it is given
    (the float64 step): in fp32 reassociation alone moves this network's
    gradients by up to 3e-2 of a leaf (the single-process step on 1 and on
    3 CPU threads, at the narrow widths; a convolution's bias before a
    train-mode BatchNorm has no gradient but that noise), so there a leaf's
    is only reported."""
    lr, world, first = reference["lr"], len(ranks), ranks[0]
    model = first["model"]
    data = world // model
    for r, res in enumerate(ranks):
        _require(res["metrics"] == first["metrics"], f"rank {r}'s metrics differ from rank 0's")
        _require(res["digest"] == first["digest"],
                 f"rank {r}'s replicated state differs from rank 0's")
        _require(res["split_digest"] == ranks[r % model]["split_digest"],
                 f"rank {r}'s split leaves differ from rank {r % model}'s")
    # each split leaf whole: the columns of data index 0's model ranks, in order
    stats, moments = dict(first["g_stats"]), dict(first["moments"])
    for name in first["split"]:
        stats[name] = float(torch.cat([ranks[m]["split"][name] for m in range(model)])
                            .double().abs().mean())
        moments[name] = torch.cat([ranks[m]["moments"][name] for m in range(model)])
    metric_delta = 0.0
    for k, rv in reference["metrics"].items():
        v = first["metrics"][k]
        d = abs(v - rv) / max(abs(rv), 1e-6)
        _require(np.isfinite(v) and d < METRIC_RTOL,
                 f"{data} x {model} ranks' {k}={v} vs single process {rv} (rel {d:.2e})")
        metric_delta = max(metric_delta, d)
    _require(set(reference["g_stats"]) == set(stats), "g_param leaves differ")
    stat_delta = max(abs(stats[k] - rv) for k, rv in reference["g_stats"].items())
    _require(stat_delta <= LEAF_LR_BOUND * lr,
             f"g_param leaf mean|p| {stat_delta:.3e} apart, bound {LEAF_LR_BOUND * lr:.3e}")
    want = [[b // data, *rest] for b, *rest in reference["attention"]]
    _require(len(want) == 2, f"single process: attention calls {reference['attention']}")
    for r, res in enumerate(ranks):
        _require(res["attention"] == want,
                 f"rank {r}: attention calls {res['attention']}, want {want}")
    _require(set(reference["moments"]) == set(moments)
             and all(moments[k].shape == t.shape for k, t in reference["moments"].items()),
             "gradient leaves differ")
    modules: Dict[str, List[str]] = {}
    for k in reference["moments"]:
        modules.setdefault(k.split(".", 1)[0], []).append(k)
    module_rel = {m: _rel_l2([moments[k] for k in keys],
                             [reference["moments"][k] for k in keys])
                  for m, keys in modules.items()}
    module_norm = {m: sum(float(reference["moments"][k].double().square().sum())
                          for k in keys) ** 0.5 for m, keys in modules.items()}
    grad_rel = {k: _rel_l2([moments[k]], [ref], LEAF_FLOOR * module_norm[k.split(".", 1)[0]])
                for k, ref in reference["moments"].items()}
    worst_module = max(module_rel, key=module_rel.get)
    _require(module_rel[worst_module] <= MODULE_GRAD_RTOL,
             f"reduced gradient of {worst_module}: {module_rel[worst_module]:.3e} relative "
             f"from the single process's, bound {MODULE_GRAD_RTOL}")
    worst = max(grad_rel, key=grad_rel.get)
    _require(grad_rtol is None or grad_rel[worst] <= grad_rtol,
             f"reduced gradient of {worst}: {grad_rel[worst]:.3e} relative from the single "
             f"process's, bound {grad_rtol}")
    return dict(world=world, data=data, model=model, split_leaves=sorted(first["split"]),
                metric_rel=metric_delta, leaf_stat=stat_delta,
                leaf_stat_bound=LEAF_LR_BOUND * lr, grad_rel=grad_rel[worst],
                grad_rel_leaf=worst, module_grad_rel=module_rel,
                module_grad_bound=MODULE_GRAD_RTOL, digest=first["digest"],
                attention=[res["attention"] for res in ranks],
                attention_calls=[res["attention_calls"] for res in ranks],
                peak_bytes=[res["peak_bytes"] for res in ranks],
                profile=[res.get("profile") for res in ranks])


# ------------------------------------------------------------------ runner


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _problem_args(args) -> dict:
    return dict(world=args.world, batch=args.batch, frames=args.frames, image=args.image,
                model=NARROW if args.narrow else None, float64=args.float64,
                model_parallel=args.model_parallel)


def _device(args, rank: int):
    if args.device == "cpu":
        return "cpu"
    index = rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return f"cuda:{index}"


def _role_reference(args) -> None:
    problem = build_problem(**_problem_args(args), device=_device(args, 0))
    torch.save(run_step(problem), os.path.join(args.out, "reference.pt"))


def _role_rank(args) -> None:
    from vcagan_torch.parallel import initialize_distributed, make_layout

    rank = int(os.environ["RANK"])
    device = _device(args, rank)
    if not initialize_distributed(backend=args.backend):
        raise RuntimeError("the rank found no process group in its environment")
    batch = args.batch or CLIPS_PER_RANK * (args.world // args.model_parallel)
    layout = make_layout(args.model_parallel, batch_size=batch, device=device)
    problem = build_problem(**_problem_args(args), device=device, layout=layout)
    result = run_step(problem, layout.batch_slice(batch), layout, profile=args.profile)
    if rank:  # rank 0's stand for all (the replicated states are equal), but the split
        # leaves' of data index 0's other model ranks
        result["moments"] = {k: result["moments"][k] for k in result["split"]
                             if rank < layout.model}
    torch.save(result, os.path.join(args.out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _wait(procs, deadline: float, what: str) -> List[float]:
    """Wait for every process; on a failure or past ``deadline`` kill them
    all and raise.  Returns the time each one ended."""
    ended = [0.0] * len(procs)
    while True:
        codes = [p.poll() for p in procs]
        ended = [e or (time.time() if c is not None else 0.0) for e, c in zip(ended, codes)]
        if any(c not in (None, 0) for c in codes) or time.time() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            late = time.time() > deadline and all(c in (None, 0) for c in codes)
            raise RuntimeError(f"{what}: {'timed out' if late else 'failed'} "
                               f"(exit codes {[p.returncode for p in procs]})")
        if all(c == 0 for c in codes):
            return ended
        time.sleep(0.1)


def run(args) -> dict:
    """The single process and the ranks, each a child process (on the card
    the single process first); returns ``compare``'s deltas (raises where
    it fails)."""
    out = tempfile.mkdtemp(prefix="vcagan_dryrun_")
    deadline = time.time() + args.timeout
    base = [sys.executable, "-m", "vcagan_torch.parallel.dryrun", "--out", out,
            *args.forward]
    try:
        t_ref = time.time()
        single = [subprocess.Popen(base + ["--role", "reference"])]
        if args.device == "cuda":
            ref_end, = _wait(single, deadline, "single process")
            single = []
        port = str(_free_port())
        procs = []
        for r in range(args.world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(args.world),
                       MASTER_ADDR="localhost", MASTER_PORT=port)
            procs.append(subprocess.Popen(base + ["--role", "rank"], env=env))
        t_ranks = time.time()
        ended = _wait(procs + single, deadline, f"{args.world} ranks")
        if single:
            ref_end = ended.pop()
        ref_s, ranks_s = ref_end - t_ref, max(ended) - t_ranks
        reference = torch.load(os.path.join(out, "reference.pt"), weights_only=False)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(args.world)]
        deltas = compare(reference, ranks, GRAD_RTOL if args.float64 else None)
        deltas.update(single_process_s=ref_s, ranks_s=ranks_s,
                      reference_attention=reference["attention"],
                      reference_attention_calls=reference["attention_calls"],
                      reference_peak_bytes=reference["peak_bytes"])
        return deltas
    finally:
        shutil.rmtree(out, ignore_errors=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--model_parallel", type=int, default=None,
                   help="ranks a model group (default: 2 where the world is at least 4 and "
                        "even, else 1, as the JAX gate)")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="nccl")
    p.add_argument("--batch", type=int, default=None,
                   help=f"global batch (default {CLIPS_PER_RANK} clips a data rank)")
    p.add_argument("--frames", type=int, default=FRAMES)
    p.add_argument("--image", type=int, default=IMAGE)
    p.add_argument("--narrow", action="store_true",
                   help="the CPU tests' narrow widths instead of the full model")
    p.add_argument("--float64", action="store_true",
                   help="the step in float64, where the gradients are held to GRAD_RTOL")
    p.add_argument("--threads", type=int, default=0, help="torch threads a process (0: torch's)")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds for the whole run; every process is killed past it")
    p.add_argument("--profile", action="store_true",
                   help="time one more step on each rank under torch.profiler")
    p.add_argument("--role", choices=("main", "reference", "rank"), default="main")
    p.add_argument("--out", default=None)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.model_parallel is None:
        args.model_parallel = 2 if args.world >= 4 and args.world % 2 == 0 else 1
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.role == "reference":
        _role_reference(args)
        return 0
    if args.role == "rank":
        _role_rank(args)
        return 0
    skip = {"--role", "--out"}
    args.forward = [a for i, a in enumerate(argv)
                    if a not in skip and (i == 0 or argv[i - 1] not in skip)]
    try:
        deltas = run(args)
    except (GateFailed, RuntimeError) as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    print(json.dumps({"ok": True, **deltas}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
