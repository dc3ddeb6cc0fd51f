"""The port's test CLIs against the JAX package's: ``python -m
vcagan_torch.cli.test`` (GRID) and ``python -m vcagan_torch.cli.test_lrs``.

- The per-batch functions against the JAX CLIs' lines
  (``vcagan/cli/test.py:116-131``, ``vcagan/cli/test_lrs.py:142-184``) at
  the narrow widths of ``tests/test_torch_loop.py``: the flip-TTA forward
  with the same noise, g3 and spec within rtol = atol = 2e-4 (as
  ``test_eval_step_matches_jax``); then the vocoding with the same
  Griffin-Lim phase, ``audio.griffin_lim_iters`` cut to 4 on both sides
  (60 rounds on random weights are chaotic), both sides given the same
  spectrogram (the JAX forward's; for LRS mapped into the normalised
  range by tanh, since a random postnet's output is not an LRS
  normalised log-spectrogram and its exponent could overflow), waveforms
  within 1e-4: GRID's slice at the first clip's length, LRS's silenced
  frames, per-clip zeroing and trims.
- The scoring on identical waveforms: STOI/ESTOI within the bound of
  ``tests/test_torch_stoi.py`` against the JAX program (5e-4), PESQ equal
  (both packages run the same numpy code).
- Each CLI's ``main`` on the CPU on the synthetic clips with the narrow
  model patched in: the JAX CLIs' artifact paths, npz keys and shapes, the
  ``metric.txt`` format, ``--time_breakdown``'s keys; ``asr_grid`` on
  ``test``'s own ``spec_mel``; the argv equal to the JAX CLIs'; an orbax
  checkpoint (with the exporter's name) refused by name; ``test_lrs
  --model_parallel 2`` parsed and without effect, as in the JAX CLI;
  ``--max_timesteps`` past 512 keys parses.
- bf16 evaluation: the eval step on bf16 modules equals the bf16
  ``Synthesizer`` (the same modules and operations: bit for bit).
"""

import glob
import json
import os
import re
import shutil
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_asr import speechlike  # noqa: E402
from test_torch_discriminator import train_variables  # noqa: E402
from test_torch_loop import NARROW  # noqa: E402
from vcagan.cli import test as jax_cli_test  # noqa: E402
from vcagan.cli import test_lrs as jax_cli_lrs  # noqa: E402
from vcagan.configs import AudioConfig as JaxAudioConfig  # noqa: E402
from vcagan.configs import ModelConfig as JaxModelConfig  # noqa: E402
from vcagan.data.lrs import lrs_denormalize_spec as jax_lrs_denormalize_spec  # noqa: E402
from vcagan.dsp import MelPipeline as JaxMelPipeline  # noqa: E402
from vcagan.eval import stoi_estoi_batch as jax_stoi_estoi_batch  # noqa: E402
from vcagan.eval.pesq_nb import pesq_batch as jax_pesq_batch  # noqa: E402
from vcagan.train import VCAGANModules as JaxModules  # noqa: E402
from vcagan.train import make_eval_step as jax_make_eval_step  # noqa: E402
from vcagan_torch.cli import asr_grid as cli_asr_grid  # noqa: E402
from vcagan_torch.cli import test as cli_test  # noqa: E402
from vcagan_torch.cli import test_lrs as cli_lrs  # noqa: E402
from vcagan_torch.cli import train_lrs as cli_train_lrs  # noqa: E402
from vcagan_torch.configs import AudioConfig, ModelConfig, grid_config, lrs_config  # noqa: E402
from vcagan_torch.dsp import MelPipeline  # noqa: E402
from vcagan_torch.io.checkpoint import CheckpointManager  # noqa: E402
from vcagan_torch.io.weights import from_jax  # noqa: E402
from vcagan_torch.serve import Synthesizer  # noqa: E402
from vcagan_torch.train import VCAGANModules, create_train_state, make_eval_step  # noqa: E402


TOL = dict(rtol=2e-4, atol=2e-4)
WAV_ATOL = 1e-4
STOI_TOL = dict(rtol=0, atol=5e-4)
GL_ITERS = 4
B, T = 2, 8  # clips, video frames (32 x 32)
NARROW_CFG = {**{f"model.{k}": v for k, v in NARROW.items()}, "data.crop_size": 32,
              "audio.griffin_lim_iters": GL_ITERS}
JAX_BREAKDOWN_KEYS = ["clips", "wall_s", "clips_per_s", "vocode_sync_s", "stoi_estoi_s",
                      "pesq_s", "dump_s", "other_s"]  # vcagan/cli/test_lrs.py:206-215
METRIC = re.compile(r"STOI : \S+ESTOI : \S+PESQ : \S+")


@pytest.fixture(scope="module")
def forwards():
    """The flip-TTA eval forward of both packages on the same narrow weights,
    inputs and noise for both passes; the mel lengths and the ground-truth
    waveforms of a batch."""
    jax_modules = JaxModules.create(JaxModelConfig(**NARROW))
    params, stats = train_variables(jax_modules, seed=41)
    rng = np.random.default_rng(5)
    video = rng.standard_normal((B, T, 32, 32, 1)).astype(np.float32)
    vid_len = np.asarray([T, T - 3], np.int32)
    noise = rng.standard_normal((2, B, 20, T, 16)).astype(np.float32)
    want = jax_make_eval_step(jax_modules, True)(
        params, stats, jnp.asarray(video), jnp.asarray(vid_len), jax.random.PRNGKey(0),
        jnp.asarray(noise))
    modules = VCAGANModules.create(ModelConfig(**NARROW)).load_state_dicts(from_jax(params, stats))
    got = make_eval_step(modules, True)(torch.from_numpy(video), torch.from_numpy(vid_len),
                                        torch.Generator(), torch.from_numpy(noise))
    mel_len = np.asarray([4 * T - 2, 4 * T - 13], np.int32)
    wav = np.stack([speechlike(4 * T * 160 / 16_000, seed=s) for s in range(B)])
    phase = rng.uniform(-np.pi, np.pi, (B, 4 * T, 321)).astype(np.float32)
    return SimpleNamespace(got=got, want=[np.asarray(x) for x in want], mel_len=mel_len,
                           wav=wav, phase=phase)


def test_the_flip_tta_forward_matches_jax(forwards):
    for name, g, w in zip(("g3", "spec"), forwards.got, forwards.want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


def test_vocode_grid_matches_the_jax_cli(forwards):
    """``vcagan/cli/test.py:118-123``: the batch sliced to the first clip's
    ``mel_len``, vocoded; ``wav_gt`` trimmed to the prediction."""
    gs, ml0 = forwards.want[1], int(forwards.mel_len[0])
    spec = jnp.swapaxes(jnp.asarray(gs), 1, 2)[:, :ml0]
    pipe = JaxMelPipeline(JaxAudioConfig(griffin_lim_iters=GL_ITERS))
    want_pred = np.asarray(pipe.inverse_spec(spec, jax.random.PRNGKey(0),
                                             jnp.asarray(forwards.phase[:, :ml0])))
    want_gt = forwards.wav[:, : want_pred.shape[1]]
    got_pred, got_gt = cli_test.vocode_grid(
        MelPipeline(AudioConfig(griffin_lim_iters=GL_ITERS)), torch.from_numpy(gs.copy()),
        forwards.wav, ml0, init_phase=torch.from_numpy(forwards.phase[:, :ml0]))
    assert got_pred.shape == want_pred.shape == (B, 160 * (ml0 - 1))
    np.testing.assert_allclose(got_pred.numpy(), want_pred, rtol=0, atol=WAV_ATOL)
    np.testing.assert_array_equal(got_gt.numpy(), want_gt)


def test_vocode_lrs_matches_the_jax_cli(forwards):
    """``vcagan/cli/test_lrs.py:147-168``: frames at or past each clip's
    ``mel_len`` silenced, one Griffin-Lim for the bucket, both waveforms
    zeroed past n_wav = min(mel_len * hop, L)."""
    gs = np.tanh(forwards.want[1])
    mel_len = forwards.mel_len
    spec = jax_lrs_denormalize_spec(jnp.swapaxes(jnp.asarray(gs), 1, 2))
    frame_valid = jnp.arange(spec.shape[1])[None, :] < jnp.asarray(mel_len)[:, None]
    spec = jnp.where(frame_valid[:, :, None], spec, 0.0)
    pipe = JaxMelPipeline(JaxAudioConfig(griffin_lim_iters=GL_ITERS))
    wav_pred = np.asarray(pipe.inverse_spec(spec, jax.random.PRNGKey(0),
                                            jnp.asarray(forwards.phase)))
    wav_gt = forwards.wav[:, : wav_pred.shape[1]]
    n_wav = np.minimum(mel_len * 160, wav_pred.shape[1])
    valid = np.arange(wav_pred.shape[1])[None, :] < n_wav[:, None]
    got_pred, got_gt, got_n = cli_lrs.vocode_lrs(
        MelPipeline(AudioConfig(griffin_lim_iters=GL_ITERS)), torch.from_numpy(gs.copy()),
        forwards.wav, torch.from_numpy(mel_len), 160,
        init_phase=torch.from_numpy(forwards.phase))
    np.testing.assert_array_equal(got_n.numpy(), n_wav)
    assert n_wav[1] < wav_pred.shape[1]  # the second clip is zeroed past its length
    np.testing.assert_allclose(got_pred.numpy(), np.where(valid, wav_pred, 0.0), rtol=0,
                               atol=WAV_ATOL)
    np.testing.assert_array_equal(got_gt.numpy(), np.where(valid, wav_gt, 0.0))


@pytest.mark.parametrize("lengths", [None, [24_000, 17_000]], ids=["full", "lengths"])
def test_score_matches_the_jax_cli(lengths):
    """STOI/ESTOI and PESQ of the same waveform pairs, the first clip only
    counted (``n_valid`` 1), as the JAX CLIs score them."""
    clean = np.stack([speechlike(1.5, seed=20 + s) for s in range(2)])
    noisy = (clean + 0.05 * np.random.default_rng(7).standard_normal(clean.shape)).astype(
        np.float32)
    if lengths is not None:
        ok = np.arange(clean.shape[1])[None, :] < np.asarray(lengths)[:, None]
        clean, noisy = np.where(ok, clean, 0.0), np.where(ok, noisy, 0.0)
    times = {}
    got = cli_test.score(torch.from_numpy(clean), torch.from_numpy(noisy), 1,
                         None if lengths is None else torch.tensor(lengths), times)
    s, e = jax_stoi_estoi_batch(jnp.asarray(clean), jnp.asarray(noisy),
                                lengths=None if lengths is None else jnp.asarray(lengths))
    for name, g, w in zip(("stoi", "estoi"), got, (s, e)):
        assert g.shape == (1,)
        np.testing.assert_allclose(g, np.asarray(w)[:1], **STOI_TOL, err_msg=name)
    np.testing.assert_array_equal(got[2], np.asarray(jax_pesq_batch(clean, noisy, fs=16_000))[:1])
    assert set(times) == {"stoi_estoi_s", "pesq_s"}


@pytest.fixture
def narrow_clis(monkeypatch):
    """Both CLIs' recipes with the narrow model and 4 Griffin-Lim rounds."""
    monkeypatch.setattr(cli_test, "grid_config",
                        lambda **kw: grid_config(**{**kw, **NARROW_CFG, "data.synthetic_clips": 3}))
    narrow = {k: v for k, v in NARROW_CFG.items() if k != "data.crop_size"}
    monkeypatch.setattr(cli_train_lrs, "lrs_config",
                        lambda dataset, **kw: lrs_config(dataset, **{**kw, **narrow}))


def test_test_cli_main_on_the_cpu(tmp_path, narrow_clis, capsys):
    """GRID: 3 synthetic clips in batches of 2 (the second padded); the JAX
    CLI's tree (``spec_mel/<sub>/<file>.npz``, ``wav/<sub>/<file>.wav``,
    ``metric.txt``), then ``asr_grid`` on its ``spec_mel``."""
    out = tmp_path / "test"
    with pytest.warns(UserWarning, match="not found under /nonexistent"):
        cli_test.main(["--grid", "/nonexistent", "--batch_size", "2", "--out_dir", str(out),
                       "--platform", "cpu"])
    npz = sorted(glob.glob(str(out / "spec_mel" / "*" / "*.npz")))
    wavs = sorted(glob.glob(str(out / "wav" / "*" / "*.wav")))
    assert [os.path.relpath(p, out) for p in npz] == [
        f"spec_mel/synthetic/clip_{i:05d}.npz" for i in range(3)]
    assert [os.path.relpath(p, out) for p in wavs] == [
        f"wav/synthetic/clip_{i:05d}.wav" for i in range(3)]
    with np.load(npz[0]) as z:
        assert sorted(z.files) == ["mel", "spec"]
        assert z["mel"].shape == (1, 80, 300) and z["spec"].shape == (1, 321, 300)
        assert z["mel"].dtype == np.float32
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == ["STOI", "ESTOI", "PESQ"]
    text = (out / "metric.txt").read_text()
    assert METRIC.fullmatch(text) and text.startswith(f"STOI : {float(lines[0].split()[1])}")

    cli_asr_grid.main(["--data", str(out / "spec_mel"), "--gtpath", "/nonexistent",
                       "--batch_size", "2", "--platform", "cpu"])
    cer, wer = capsys.readouterr().out.splitlines()
    assert cer.startswith("test_cer: ") and wer == "test_wer: 1.0"  # no transcripts


def test_test_lrs_cli_main_on_the_cpu(tmp_path, narrow_clis, capsys):
    """LRS2: 3 synthetic clips (30-90 frames) length-sorted into batches of
    2 at buckets of up to 40 frames; ``<out>/LRS2/{mel,wav}`` named by the
    clip with ``/`` as ``_``, each wav trimmed to its n_wav;
    ``--time_breakdown``'s JSON keys are the JAX CLI's."""
    out = tmp_path / "test"
    with pytest.warns(UserWarning, match="not found under /nonexistent"):
        cli_lrs.main(["--data", "/nonexistent", "--synthetic_clips", "3", "--batch_size", "2",
                      "--max_timesteps", "40", "--time_breakdown", "--out_dir", str(out),
                      "--platform", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    breakdown = json.loads(lines[0])
    assert list(breakdown) == JAX_BREAKDOWN_KEYS and breakdown["clips"] == 3
    assert [line.split(":")[0] for line in lines[1:]] == ["STOI", "ESTOI", "PESQ"]
    base = out / "LRS2"
    assert METRIC.fullmatch((base / "metric.txt").read_text())
    names = [f"synthetic_{i:05d}" for i in range(3)]
    assert sorted(os.listdir(base / "mel")) == [f"{n}.npz" for n in names]
    assert sorted(os.listdir(base / "wav")) == [f"{n}.wav" for n in names]
    import scipy.io.wavfile as wavfile
    for name in names:
        with np.load(base / "mel" / f"{name}.npz") as z:
            n_mel = z["mel"].shape[2]
            assert z["mel"].shape == (1, 80, n_mel) and z["spec"].shape == (1, 321, n_mel)
        _, wav = wavfile.read(base / "wav" / f"{name}.wav")
        # the 40-frame bucket vocodes to 160 * (4 * 40 - 1) samples
        assert wav.shape == (min(n_mel * 160, 160 * (4 * 40 - 1)),)


@pytest.mark.parametrize("argv", [
    [],
    ["--grid", "/data/GRID", "--checkpoint", "ck", "--batch_size", "16", "--subject", "s1",
     "--max_timesteps", "60", "--seed", "5", "--temp", "0.5", "--out_dir", "o",
     "--max_batches", "3", "--bf16", "--platform", "cpu", "--synthetic", "--save_mel"],
])
def test_test_cli_argv_equals_the_jax_cli(argv):
    args = cli_test.parse_args(argv)
    assert vars(args) == vars(jax_cli_test.parse_args(argv))
    cfg = cli_test.build_config(args)  # the overrides of vcagan/cli/test.py:70-80
    assert (cfg.data.data_root, cfg.data.subject, cfg.data.window_size, cfg.data.max_v_timesteps,
            cfg.data.augmentations, cfg.model.sync_temp, cfg.model.use_bfloat16) == (
        args.grid, args.subject, args.window_size, args.max_timesteps, False, args.temp,
        args.bf16)


@pytest.mark.parametrize("argv", [
    [],
    ["--data", "/data/LRS3", "--data_name", "LRS3", "--checkpoint", "ck", "--batch_size", "4",
     "--max_timesteps", "120", "--f_min", "40", "--f_max", "8000", "--synthetic_clips", "9",
     "--no_sort_by_length", "--time_breakdown", "--bf16", "--platform", "cpu", "--max_batches",
     "2", "--out_dir", "o", "--seed", "3"],
])
def test_test_lrs_cli_argv_equals_the_jax_cli(argv):
    got, want = cli_lrs.parse_args(argv), jax_cli_lrs.parse_args(argv)
    assert vars(got) == vars(want)
    cfg, jcfg = cli_lrs.build_config(got), jax_cli_lrs.build_config(want)
    for part in ("audio", "data", "model"):
        mine, theirs = getattr(cfg, part), getattr(jcfg, part)
        for field in mine.__dataclass_fields__:
            assert getattr(mine, field) == getattr(theirs, field), f"{part}.{field}"


@pytest.mark.parametrize("cli,argv,words", [
    # ported since (the case keeps its id): parsed and without effect, as the
    # JAX CLI's (vcagan/cli/test_lrs.py:56), the evaluation on one device
    (cli_lrs, ["--model_parallel", "2"], None),
], ids=["test_lrs model_parallel"])
def test_what_the_port_does_not_run_stops_the_parse(cli, argv, words, capsys, tmp_path,
                                                     narrow_clis):
    args = cli.parse_args(argv)
    assert vars(args) == vars(jax_cli_lrs.parse_args(argv)) and args.model_parallel == 2
    out = tmp_path / "test"
    with pytest.warns(UserWarning, match="not found under /nonexistent"):
        cli.main(["--data", "/nonexistent", "--synthetic_clips", "2", "--batch_size", "2",
                  "--max_timesteps", "40", "--max_batches", "1", "--out_dir", str(out),
                  "--platform", "cpu", *argv])
    assert not torch.distributed.is_initialized()
    assert METRIC.fullmatch((out / "LRS2" / "metric.txt").read_text())
    assert len(os.listdir(out / "LRS2" / "wav")) == 2


@pytest.mark.parametrize("cli", [cli_test, cli_lrs], ids=["test max_timesteps",
                                                          "test_lrs max_timesteps"])
def test_max_timesteps_past_512_keys_parses(cli):
    """The attention takes any number of keys (the key-blocked plan past
    512), so a bucket of 640 frames is the JAX CLI's config."""
    for n in (512, 513, 640):
        args = cli.parse_args(["--max_timesteps", str(n)])
        assert args.max_timesteps == n and cli.build_config(args).data.max_v_timesteps == n


def test_checkpoints_load_and_orbax_is_refused(tmp_path):
    """``--checkpoint``: one of the port's checkpoints gives the modules its
    weights (not those of ``--seed``); an orbax directory is refused before
    anything is built, naming the exporter that turns it into an ``.npz``
    the CLI takes; without CUDA the CLI raises unless ``--platform cpu``."""
    cfg = grid_config(**NARROW_CFG)
    saved, _, _ = create_train_state(VCAGANModules.create(cfg.model, seed=5), cfg.train, 1,
                                     device="cpu")
    path = CheckpointManager(str(tmp_path / "ckpt")).save(saved, 0)
    args = SimpleNamespace(seed=1, checkpoint=path)
    modules = cli_test.load_modules(cfg, args, torch.device("cpu"))
    for name, sd in saved.modules.state_dicts().items():
        for key, value in getattr(modules, name).state_dict().items():
            assert torch.equal(value, sd[key]), f"{name}.{key}"
    shutil.rmtree(tmp_path / "ckpt")

    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for cli in (cli_test, cli_lrs):
        with pytest.raises(NotImplementedError, match="export_jax_train_state.py"):
            cli.main(["--checkpoint", str(orbax), "--platform", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_test.main(["--grid", "/nonexistent"])


def test_bf16_eval_step_equals_the_bf16_synthesizer():
    """The eval step (no flip) on bf16 modules against the bf16 serving
    path on the same narrow weights and noise: the same modules and
    operations in the same order, so equal to the last bit."""
    config = ModelConfig(**NARROW, use_bfloat16=True)
    modules = VCAGANModules.create(config, seed=3)
    synth = Synthesizer(config, device="cpu").load_state_dicts(
        {name: getattr(modules, name).state_dict() for name in ("v_front", "gen", "post")})
    rng = np.random.default_rng(8)
    video = torch.from_numpy(rng.standard_normal((B, T, 32, 32, 1)).astype(np.float32))
    lengths = torch.tensor([T, T - 2], dtype=torch.int32)
    noise = torch.from_numpy(rng.standard_normal((1, B, 20, T, 16)).astype(np.float32))
    g3, gs = make_eval_step(modules, flip_tta=False)(video, lengths, None, noise)
    out = synth(video, lengths, noise=noise[0])
    assert g3.dtype == out["mel3"].dtype == torch.bfloat16
    assert torch.equal(g3, out["mel3"])
    assert torch.equal(gs.float().transpose(1, 2), out["spec"])
