"""BatchNorm over the global batch, and the gradient all-reduce across its
buckets: 2 gloo ranks against one process.

Each rank takes its half of a global batch (numpy, seeded) through the
port's train-mode BatchNorm (1-D, 2-D and 3-D) under a data-parallel
layout, and the loss sum(y * w) with a fixed random w of the global
batch's shape; the same on one process on the whole batch, where the
BatchNorm is today's single-process path (``torch.var_mean`` and
``F.batch_norm``).  Compared: the outputs, the running statistics (equal
on both ranks, bit for bit), and the first-order gradients of the input
(each rank's rows) and of the affine parameters (summed over the ranks,
as the loss is a sum).  The ranks are this file run as a script, killed
at a wall-clock limit.

Tolerances, and why.  fp32: the global statistics are a sum over the ranks
and E[x^2] - E[x]^2 (flax's fast variance) where one process takes
``torch.var_mean``'s two passes; on inputs of mean 0.5 and scale 2 that
moves the normalised outputs, the statistics and the gradients by a few
fp32 roundings (rtol and atol 1e-5; measured below 2e-6).  bf16 input: the
output is rounded to bf16 once on both sides from fp32 values that differ
by those roundings, so an element may sit one bf16 step (2^-8 relative)
apart (rtol and atol 1e-2); the statistics and gradients stay fp32 (1e-5).

The gradient mean (``collectives.all_reduce_mean_``) with its buckets cut
to ``SMALL_BUCKET`` bytes, so that a list of tensors of three dtypes fills
several buckets, one of them shared by three tensors and one taken by a
tensor larger than a bucket: each tensor's mean over the ranks bit for bit
(a sum of two and a halving are exact; a bf16 tensor is rounded once, from
fp32), one all-reduce a bucket, and the bytes reduced.

Also: the three mel discriminators hold no BatchNorm, so no collective
sits under R1's second derivative (``vcagan_torch/nn/losses.py``); the
sync critic and the generator side do hold some.
"""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vcagan_torch.nn.common import batch_norm  # noqa: E402
from vcagan_torch.parallel.collectives import BUCKET_BYTES  # noqa: E402

WORLD = 2
CASES = {  # name: (dims, global input shape, input dtype)
    "bn1d": (1, (8, 6, 10), torch.float32),
    "bn2d": (2, (4, 5, 7, 9), torch.float32),
    "bn3d": (3, (4, 3, 5, 6, 6), torch.float32),
    "bn2d bf16": (2, (4, 5, 7, 9), torch.bfloat16),
}
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_OUT_TOL = dict(rtol=1e-2, atol=1e-2)
LIMIT_S = 120
# all_reduce_mean_'s input: (shape, dtype) in order, and the buckets it
# makes of them at SMALL_BUCKET bytes (fp32 bytes of bf16 tensors): three
# that fill a bucket, one larger than a bucket, two, and a float64 one.
SMALL_BUCKET = 64
REDUCE_CASE = [((3,), torch.float32), ((5,), torch.bfloat16), ((4, 2), torch.float32),
               ((30,), torch.float32), ((1,), torch.float32), ((5,), torch.float32),
               ((2, 3), torch.float64)]
REDUCE_BUCKETS = [64, 120, 24, 48]


def case_inputs(name):
    dims, shape, dtype = CASES[name]
    rng = np.random.default_rng(len(name) * 7 + dims)
    x = torch.from_numpy(0.5 + 2.0 * rng.standard_normal(shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bn = batch_norm(shape[1], dims)
    with torch.no_grad():  # affine away from the identity, statistics away from 0 / 1
        bn.weight.copy_(torch.from_numpy(1.0 + 0.1 * rng.standard_normal(shape[1])))
        bn.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(shape[1])))
        bn.running_mean.fill_(0.2)
        bn.running_var.fill_(1.5)
    return bn.train(), x, w


def run(name, rows=slice(None), group=None):
    """The case through BatchNorm on ``rows``; outputs, statistics and
    gradients (the affine's summed over the group's ranks)."""
    bn, x, w = case_inputs(name)
    x = x[rows].clone().requires_grad_()
    y = bn(x)
    loss = (y.float() * w[rows]).sum()
    gx, gw, gb = torch.autograd.grad(loss, [x, bn.weight, bn.bias])
    if group is not None:
        for g in (gw, gb):
            torch.distributed.all_reduce(g, group=group)
    return dict(y=y.detach(), gx=gx, gw=gw, gb=gb, mean=bn.running_mean.clone(),
                var=bn.running_var.clone())


def reduce_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return [torch.from_numpy(rng.standard_normal(shape)).to(dtype)
            for shape, dtype in REDUCE_CASE]


def reduce_in_small_buckets(group):
    """``all_reduce_mean_`` over this rank's ``reduce_inputs`` in buckets of
    ``SMALL_BUCKET`` bytes; the tensors, the bytes of each all-reduce call
    and the bytes it returns."""
    from vcagan_torch.parallel import collectives

    tensors = reduce_inputs(torch.distributed.get_rank(group))
    calls, all_reduce = [], collectives.dist.all_reduce

    def counted(t, *args, **kwargs):
        calls.append(t.numel() * t.element_size())
        return all_reduce(t, *args, **kwargs)

    collectives.BUCKET_BYTES, collectives.dist.all_reduce = SMALL_BUCKET, counted
    try:
        nbytes = collectives.all_reduce_mean_(tensors, group)
    finally:
        collectives.BUCKET_BYTES, collectives.dist.all_reduce = BUCKET_BYTES, all_reduce
    return dict(tensors=tensors, calls=calls, nbytes=nbytes)


def rank_main(rank, port, out):
    """One rank: join the group, run every case under the layout, then the
    gradient mean in small buckets."""
    from vcagan_torch.parallel import initialize_distributed, make_layout

    torch.set_num_threads(1)
    assert initialize_distributed("gloo", f"tcp://localhost:{port}", WORLD, rank)
    layout = make_layout(device="cpu")
    results = {}
    with layout.active():
        for name in CASES:
            rows = layout.batch_slice(CASES[name][1][0])
            results[name] = run(name, rows, layout.group)
    results["reduce"] = reduce_in_small_buckets(layout.group)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp_bn")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=LIMIT_S)[0] for p in procs]
    finally:
        for p in procs:  # a rank left waiting in a collective fails the test here
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]


@pytest.mark.parametrize("name", list(CASES))
def test_global_batchnorm_equals_one_process(ranks, name):
    want = run(name)
    n = CASES[name][1][0] // WORLD
    for key in ("mean", "var"):
        assert torch.equal(ranks[0][name][key], ranks[1][name][key]), key
        torch.testing.assert_close(ranks[0][name][key], want[key], **TOL)
    for key in ("gw", "gb"):
        torch.testing.assert_close(ranks[0][name][key], want[key], **TOL)
    for r in range(WORLD):
        rows = slice(r * n, (r + 1) * n)
        got = ranks[r][name]
        assert got["y"].dtype == want["y"].dtype == CASES[name][2]
        out_tol = BF16_OUT_TOL if CASES[name][2] == torch.bfloat16 else TOL
        torch.testing.assert_close(got["y"].float(), want["y"][rows].float(), **out_tol)
        torch.testing.assert_close(got["gx"].float(), want["gx"][rows].float(), **TOL)
    print(f"{name}: max |dy| " + ", ".join(
        f"{(ranks[r][name]['y'].float() - want['y'][r * n:(r + 1) * n].float()).abs().max():.2e}"
        for r in range(WORLD)))


def test_gradient_mean_across_buckets(ranks):
    inputs = [reduce_inputs(r) for r in range(WORLD)]
    for r in range(WORLD):
        got = ranks[r]["reduce"]
        assert got["calls"] == REDUCE_BUCKETS and got["nbytes"] == sum(REDUCE_BUCKETS)
        for i, (t, (shape, dtype)) in enumerate(zip(got["tensors"], REDUCE_CASE)):
            wide = torch.promote_types(dtype, torch.float32)
            want = ((inputs[0][i].to(wide) + inputs[1][i].to(wide)) / WORLD).to(dtype)
            assert t.shape == shape and t.dtype == dtype and torch.equal(t, want), i


def test_no_batchnorm_under_the_second_derivative():
    from torch.nn.modules.batchnorm import _BatchNorm

    from vcagan_torch.train import VCAGANModules
    from vcagan_torch.train.models import GENERATOR_SIDE

    modules = VCAGANModules.create()
    for name in ("dis1", "dis2", "dis3"):  # R1 differentiates twice through these alone
        assert not any(isinstance(m, _BatchNorm) for m in getattr(modules, name).modules()), name
    for name in ("s_dis", *GENERATOR_SIDE[:2]):  # the synced ones the step does reach
        assert any(isinstance(m, _BatchNorm) for m in getattr(modules, name).modules()), name


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    print(json.dumps({"rank": int(sys.argv[1]), "ok": True}))
