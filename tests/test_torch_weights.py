"""Weight I/O of the PyTorch port against the JAX package's formats.

``from_jax`` must be the exact inverse of the reference converter
(``tools/convert_torch_ckpt.convert_visual_front/decoder/postnet``), and the
port's serving-npz reader must give the JAX reader's trees leaf for leaf.

``jax_variables`` (also used by the other ``test_torch_*`` files) makes
variable trees with the exact structure of a JAX module's init (from
``jax.eval_shape``, so nothing compiles) and seeded random values: every
conv, BN statistic and PReLU slope differs, so a transposed or swapped
leaf cannot pass.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools.convert_torch_ckpt import (  # noqa: E402
    convert_decoder,
    convert_postnet,
    convert_visual_front,
)
from vcagan.io.serving_npz import load_serving_npz as jax_load_serving_npz  # noqa: E402
from vcagan.nn import Decoder, Postnet, VisualFront  # noqa: E402
from vcagan_torch.io.weights import (  # noqa: E402
    from_jax,
    load_serving_npz,
    read_serving_npz,
)

SERVING_NPZ = os.path.join(os.path.dirname(__file__), "..", "data", "soak_serving_q8.npz")


def _dummy_inputs(name):
    if name == "v_front":
        return VisualFront(), (jnp.zeros((2, 8, 48, 48, 1)),)
    if name == "gen":
        z = jnp.zeros((2, 8, 512))
        return Decoder(), (z, z, jnp.full((2,), 8, jnp.int32))
    return Postnet(), (jnp.zeros((2, 80, 32)),)


def _template(name):
    module, args = _dummy_inputs(name)
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "dropout": key, "noise": key}
    return jax.eval_shape(functools.partial(module.init, train=False), rngs, *args)


def jax_templates(names=("v_front", "gen", "post")):
    """(params, batch_stats) trees of ShapeDtypeStructs keyed by module."""
    params, stats = {}, {}
    for name in names:
        tmpl = _template(name)
        params[name] = tmpl["params"]
        stats[name] = tmpl.get("batch_stats", {})
    return params, stats


def _fill(tree, rng, stats):
    out = {}
    for key, leaf in tree.items():
        if not hasattr(leaf, "shape"):
            out[key] = _fill(leaf, rng, stats)
            continue
        shape = leaf.shape
        normal = rng.standard_normal(shape)
        if stats:
            val = 0.1 * normal if key == "mean" else rng.uniform(0.5, 1.5, shape)
        elif key == "kernel" or key[-4:] in ("_w_i", "_w_h"):
            val = normal / np.sqrt(np.prod(shape[:-1]))
        elif key == "scale":
            val = 1.0 + 0.1 * normal
        elif key == "alpha":
            val = 0.25 + 0.05 * normal
        else:  # biases
            val = 0.1 * normal
        out[key] = val.astype(np.float32)
    return out


def jax_variables(seed=0, names=("v_front", "gen", "post")):
    """(params, batch_stats) numpy trees keyed by module name."""
    rng = np.random.default_rng(seed)
    params, stats = jax_templates(names)
    for name in names:
        params[name] = _fill(params[name], rng, stats=False)
        stats[name] = _fill(stats[name], rng, stats=True)
    return params, stats


def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), f"{path}: keys {sorted(got)} vs {sorted(want)}"
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        else:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.shape == w.shape, f"{path}/{key}: {g.shape} vs {w.shape}"
            assert g.dtype == w.dtype, f"{path}/{key}: {g.dtype} vs {w.dtype}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{key}")


CONVERTERS = {"v_front": convert_visual_front, "gen": convert_decoder, "post": convert_postnet}


@pytest.mark.parametrize("name", ["v_front", "gen", "post"])
def test_from_jax_is_exact_inverse_of_converter(name):
    params, stats = jax_variables(seed=1)
    states = from_jax(params, stats)
    back = CONVERTERS[name](states[name])
    _assert_trees_equal(back["params"], params[name], name)
    _assert_trees_equal(back["batch_stats"], stats[name], name)


def test_state_dicts_load_strictly_into_port_modules():
    from vcagan_torch.serve import Synthesizer

    params, stats = jax_variables(seed=2)
    synth = Synthesizer(device="cpu")
    synth.load_state_dicts(from_jax(params, stats))  # strict: no missing/extra key
    got = synth.gen.state_dict()["att1.mel.weight"].numpy()
    np.testing.assert_array_equal(got, params["gen"]["att1"]["mel"]["kernel"].T)


def test_read_serving_npz_matches_jax_reader_leaf_for_leaf():
    want_p, want_s = jax_load_serving_npz(SERVING_NPZ, *jax_templates())
    got_p, got_s = read_serving_npz(SERVING_NPZ)
    _assert_trees_equal(got_p, want_p, "params")
    _assert_trees_equal(got_s, want_s, "stats")

    states = load_serving_npz(SERVING_NPZ)
    for name, convert in CONVERTERS.items():
        back = convert(states[name])
        _assert_trees_equal(back["params"], want_p[name], name)
        _assert_trees_equal(back["batch_stats"], want_s[name], name)


def test_state_dict_keys_are_the_reference_names():
    params, stats = jax_variables(seed=3)
    states = from_jax(params, stats)
    for key in (
        "frontend.0.weight", "frontend.1.running_var", "frontend.2.weight",
        "resnet.layer1.0.conv1.weight", "resnet.layer2.0.downsample.0.weight",
        "sentence_encoder.weight_ih_l0_reverse", "fc.bias",
    ):
        assert key in states["v_front"], key
    for key in ("decode.0.conv1x1.weight", "g2.0.norm1.weight", "att1.q.weight",
                "att2.mel.bias", "attconv2.weight", "to_mel3.2.weight"):
        assert key in states["gen"], key
    for key in ("postnet.0.weight", "postnet.1.running_mean", "postnet.3.conv1x1.weight",
                "postnet.6.weight"):
        assert key in states["post"], key
    assert all(t.dtype in (torch.float32, torch.int64) for sd in states.values()
               for t in sd.values())
