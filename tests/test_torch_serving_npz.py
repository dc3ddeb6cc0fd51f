"""The port's ``save_serving_npz`` against the JAX package's.

The generator side of a narrow port bundle (the widths of
``tests/test_torch_train_step.py``, BatchNorm statistics drawn at random so
that no mean or variance is a default) written by
``vcagan_torch.io.serving_npz.save_serving_npz``, fp16 and q8:
- the JAX package's ``load_serving_npz`` reads it into the JAX modules'
  template (it raises on a missing or an extra leaf);
- every entry equals, byte for byte, what the JAX package's
  ``save_serving_npz`` writes of the reference converter's trees of the
  same state dicts;
- the port reads its own file back: the same tensors as from the JAX
  writer's file, and the state dicts to fp16's rounding (q8: within half
  a quantisation step of each output channel).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_train_step import NARROW  # noqa: E402
from tools.convert_torch_ckpt import convert_decoder, convert_postnet, convert_visual_front  # noqa: E402
from vcagan.configs import ModelConfig as JaxModelConfig  # noqa: E402
from vcagan.io.serving_npz import load_serving_npz as jax_load_serving_npz  # noqa: E402
from vcagan.io.serving_npz import save_serving_npz as jax_save_serving_npz  # noqa: E402
from vcagan.train import VCAGANModules as JaxModules  # noqa: E402
from vcagan_torch.configs import ModelConfig  # noqa: E402
from vcagan_torch.io.serving_npz import save_serving_npz  # noqa: E402
from vcagan_torch.io.weights import load_serving_npz  # noqa: E402
from vcagan_torch.train import VCAGANModules  # noqa: E402

CONVERTERS = {"v_front": convert_visual_front, "gen": convert_decoder, "post": convert_postnet}


@pytest.fixture(scope="module")
def states():
    modules = VCAGANModules.create(ModelConfig(**NARROW), seed=4)
    rng = np.random.default_rng(4)
    out = {}
    for name in CONVERTERS:
        sd = {k: v.clone() for k, v in getattr(modules, name).state_dict().items()}
        for k, v in sd.items():
            if k.endswith("running_mean"):
                sd[k] = torch.from_numpy(rng.normal(0, 0.5, v.shape).astype(np.float32))
            elif k.endswith("running_var"):
                sd[k] = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        out[name] = sd
    return out


@pytest.fixture(scope="module")
def templates():
    shapes = jax.eval_shape(JaxModules.create(JaxModelConfig(**NARROW)).init_all,
                            jax.random.PRNGKey(0))
    return shapes[0], shapes[1]


@pytest.fixture(scope="module")
def files(states, tmp_path_factory):
    """{quantize: (the port's file, the JAX writer's file of the converter's
    trees)}, each written once."""
    tmp = tmp_path_factory.mktemp("serving_npz")
    trees = {name: CONVERTERS[name](sd) for name, sd in states.items()}
    out = {}
    for quantize in (None, "q8"):
        port, ref = str(tmp / f"port_{quantize}.npz"), str(tmp / f"jax_{quantize}.npz")
        save_serving_npz(states, port, quantize)
        jax_save_serving_npz({k: t["params"] for k, t in trees.items()},
                             {k: t["batch_stats"] for k, t in trees.items()}, ref, quantize)
        out[quantize] = port, ref
    return out


@pytest.mark.parametrize("quantize", [None, "q8"])
def test_the_jax_reader_takes_the_ports_file(files, templates, quantize):
    path = files[quantize][0]
    params, stats = jax_load_serving_npz(path, *templates)
    assert sorted(params) == sorted(stats) == sorted(CONVERTERS)
    with np.load(path) as z:
        if quantize == "q8":
            assert any(k.startswith("q8:") for k in z.files)
        assert all(z[k].dtype == np.float16 for k in z.files if k.startswith("stats/"))


@pytest.mark.parametrize("quantize", [None, "q8"])
def test_each_leaf_equals_the_jax_writer(files, quantize):
    port, ref = files[quantize]
    with np.load(port) as got, np.load(ref) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("quantize", [None, "q8"])
def test_the_port_reads_its_own_file(states, files, quantize):
    port, ref = files[quantize]
    got, from_ref = load_serving_npz(port), load_serving_npz(ref)
    assert sorted(got) == sorted(states)
    for name, sd in states.items():
        assert got[name].keys() == from_ref[name].keys()
        for k, v in got[name].items():
            torch.testing.assert_close(v, from_ref[name][k], rtol=0, atol=0)
            if k.endswith("num_batches_tracked"):
                continue
            want = sd[k].float()
            if quantize == "q8" and want.numel() > 4096:
                # within half a step of the largest |w| / 127 of the tensor, and
                # the fp32 rounding of the scale and of q * scale
                assert (v - want).abs().max() <= 0.5 * want.abs().max() / 127 * (1 + 1e-4), k
            else:
                torch.testing.assert_close(v, want, rtol=1e-3, atol=1e-4, msg=k)
