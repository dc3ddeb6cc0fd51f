"""The PyTorch port's serving path as a whole, and the port's boundaries.

- ``Synthesizer`` against the JAX composition that ``bench.py:52-76``
  times, on the trained weights of ``data/soak_serving_q8.npz`` (each side
  read by its own loader) and the same video, decoder noise and Griffin-Lim
  phase; every output, the waveform included, at 1e-4 (rtol and atol), the
  tolerance of the JAX self-regression goldens.  Trained weights matter
  for the waveform: on the arbitrary spectrogram of random weights, 60
  Griffin-Lim rounds are chaotic (a 6e-7 change of the spectrogram moves
  the JAX package's own waveform by 3e-3), while on a speech-like one they
  are not.
- ``phon``/``sent`` against the goldens of ``tests/fixtures/
  self_regression.npz`` (the JAX init from ``PRNGKey(0)``, the video from
  ``default_rng(99)``, as ``tests/test_self_regression.py``), at 1e-4.
- No file of ``vcagan_torch/`` (``bench.py`` among them) and no line of
  ``chip_smoke.py`` imports JAX, flax or the JAX package.  The scan is static: an interpreter may
  import JAX at start-up, so ``sys.modules`` proves nothing.
- Without CUDA, an entry point that is not told ``device="cpu"`` raises: the
  synthesizer in fp32 and in bf16, ``vcagan_torch.bench``, the GRID
  ``Trainer`` and ``python -m vcagan_torch.cli.train`` without
  ``--platform cpu``.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import jax_templates, jax_variables
from vcagan.configs import AudioConfig as JaxAudioConfig
from vcagan.dsp import MelPipeline as JaxMelPipeline
from vcagan.io.serving_npz import load_serving_npz as jax_load_serving_npz
from vcagan.nn import Decoder as JaxDecoder
from vcagan.nn import Postnet as JaxPostnet
from vcagan.nn import VisualFront as JaxVisualFront
from vcagan.nn import fold_generator_side as jax_fold_generator_side
from vcagan.train import VCAGANModules
from vcagan_torch import bench
from vcagan_torch.cli import train as train_cli
from vcagan_torch.configs import ModelConfig, grid_config
from vcagan_torch.serve import Synthesizer
from vcagan_torch.train.loop import Trainer
from _torch_threads import _one_thread  # noqa: F401  (autouse)


ROOT = os.path.join(os.path.dirname(__file__), "..")
SERVING_NPZ = os.path.join(ROOT, "data", "soak_serving_q8.npz")
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_bench_composition(params, stats, video, lengths, noise, phase, folded=False):
    """bench.py's flagship path, with the noise and phase injected.
    ``folded``: the serving variant, ``VCAGANModules.create(fold_bn=True,
    fused_blocks=True)`` on params folded by ``fold_generator_side``."""
    if folded:
        params, stats = jax_fold_generator_side(params, stats)
        modules = VCAGANModules.create(fold_bn=True, fused_blocks=True)
        v_front, gen, post = modules.v_front, modules.gen, modules.post
    else:
        v_front, gen, post = JaxVisualFront(), JaxDecoder(), JaxPostnet()
    var = lambda m: {"params": params[m], "batch_stats": stats[m]}  # noqa: E731
    phon, sent = v_front.apply(var("v_front"), video, train=False)
    mel1, mel2, mel3 = gen.apply(var("gen"), sent, phon, lengths, train=False, noise=noise)
    gs = post.apply(var("post"), mel3, train=False)
    spec = jnp.swapaxes(gs, 1, 2).astype(jnp.float32)
    wav = JaxMelPipeline(JaxAudioConfig()).inverse_spec(
        spec, jax.random.PRNGKey(0), init_phase=phase
    )
    return dict(phon=phon, sent=sent, mel1=mel1, mel2=mel2, mel3=mel3, spec=spec, wav=wav)


def test_synthesizer_matches_jax_composition():
    b, t = 2, 8
    params, stats = jax_load_serving_npz(SERVING_NPZ, *jax_templates())
    rng = np.random.default_rng(5)
    video = rng.standard_normal((b, t, 48, 48, 1)).astype(np.float32)
    lengths = np.asarray([t, t - 2], np.int32)
    noise = rng.standard_normal((b, 20, t, 128)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (b, 4 * t, 321)).astype(np.float32)

    want = _jax_bench_composition(
        params, stats, *(jnp.asarray(a) for a in (video, lengths, noise, phase))
    )
    got = Synthesizer.from_serving_npz(SERVING_NPZ, device="cpu")(
        video, lengths, noise=noise, init_phase=phase
    )
    assert got["wav"].shape == (b, 160 * (4 * t - 1))
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **TOL)


def test_visual_front_matches_self_regression_goldens():
    golden = np.load(os.path.join(ROOT, "tests", "fixtures", "self_regression.npz"))
    # The v_front slice of VCAGANModules.init_all(PRNGKey(0), 1, 20, 48):
    # the same module, keys and dummy input.
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    rngs = {"params": keys[0], "dropout": keys[7], "noise": keys[7]}
    v_front = VCAGANModules.create().v_front
    variables = jax.jit(functools.partial(v_front.init, train=False))(
        rngs, jnp.zeros((1, 20, 48, 48, 1))
    )
    params = {"v_front": jax.tree_util.tree_map(np.asarray, variables["params"])}
    stats = {"v_front": jax.tree_util.tree_map(np.asarray, variables["batch_stats"])}
    params.update(jax_variables(seed=0, names=("gen", "post"))[0])
    stats.update(jax_variables(seed=0, names=("gen", "post"))[1])

    synth = Synthesizer.from_jax(params, stats, device="cpu")
    video = np.random.default_rng(99).standard_normal((1, 20, 48, 48, 1)).astype(np.float32)
    with torch.inference_mode():
        phon, sent = synth.v_front(torch.from_numpy(video))
    np.testing.assert_allclose(phon.numpy(), golden["phon"], **TOL)
    np.testing.assert_allclose(sent.numpy(), golden["sent"], **TOL)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def _port_sources():
    pkg = os.path.join(ROOT, "vcagan_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 15 and os.path.exists(sources[-1])
    seen = {os.path.relpath(path, os.path.join(ROOT, "vcagan_torch")) for path in sources}
    assert {"nn/fold.py", "kernels/fused_block.py", "kernels/masked_attention.py",
            "bench.py", "train/loop.py", "cli/train.py", "data/grid.py", "eval/stoi.py",
            "cli/test.py", "cli/test_lrs.py", "cli/asr_grid.py", "cli/asr_lrw.py",
            "eval/asr_models.py", "nn/audio_front.py", "cli/preprocess_grid.py"} <= seen
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod in _imports(tree):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "vcagan", "optax", "orbax"), (path, mod)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(ModelConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer.from_jax(*jax_variables(seed=0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(ModelConfig(), device="cuda")
    bf16 = ModelConfig(use_bfloat16=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(bf16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(bf16, fold_bn=True, fused_blocks=True)
    for argv in ([], ["--fold-bn-fused"], ["--fp32"]):  # the bench has no CPU fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(argv)
    config = grid_config(**{"data.data_root": "/nonexistent", "data.synthetic_clips": 2,
                            "train.batch_size": 2, "train.checkpoint_dir": str(tmp_path / "c")})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(config, log_dir=str(tmp_path / "log"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--grid", "/nonexistent", "--checkpoint_dir", str(tmp_path / "c"),
                        "--log_dir", str(tmp_path / "log")])
    assert Synthesizer(ModelConfig(), device="cpu").device.type == "cpu"
    assert Synthesizer(bf16, device="cpu").device.type == "cpu"


def test_noise_and_phase_come_from_the_generator():
    synth = Synthesizer(device="cpu")
    video = np.random.default_rng(0).standard_normal((1, 4, 48, 48, 1)).astype(np.float32)
    run = lambda s: synth(video, [4], generator=torch.Generator().manual_seed(s))["wav"]  # noqa: E731
    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
