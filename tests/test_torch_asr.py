"""The port's ASR scorers against the JAX package: ``AudioFront``, ``GridASR``,
``LRWClassifier``, their weight converters, ``text``, ``evaluate`` on
fixture directories and the two ASR CLIs.

Weights: flax trees with the structure of the JAX models' ``init`` (from
``jax.eval_shape``) filled with seeded random values, handed to the port
through ``asr_from_jax`` (its front through ``audio_front_state``).  Inputs
are made with numpy from a seed.  Outputs are held to rtol = atol = 2e-4,
the bound of ``tests/test_lrw_convert.py`` (fp32 on both sides,
convolutions and GRU sums in other orders).  Mels from wavs: 1e-4 (the
port's forward DSP chain against the JAX package's, the bound of
``tests/test_torch_dsp_forward.py``).  Decoded tokens: equal wherever the
JAX logits' top two differ by more than 2e-3 (ten times the logits'
bound).  With these seeds 3 (npz) and 2 (wav) of the 225 GRID steps fall
within that margin and no LRW clip does (printed with ``-s``); their
tokens agree too, which the tests assert, so WER/CER and accuracy must
equal the JAX package's exactly.
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
sys.path.insert(0, os.path.dirname(__file__))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_weights import _fill  # noqa: E402
from tools.convert_torch_ckpt import convert_grid_asr, convert_lrw_asr  # noqa: E402
from vcagan.cli import asr_grid as jax_cli_grid  # noqa: E402
from vcagan.cli import asr_lrw as jax_cli_lrw  # noqa: E402
from vcagan.dsp import MelPipeline as JaxMelPipeline  # noqa: E402
from vcagan.eval import asr_grid as jax_asr_grid  # noqa: E402
from vcagan.eval import asr_lrw as jax_asr_lrw  # noqa: E402
from vcagan.eval import text as jax_text  # noqa: E402
from vcagan.eval.asr_models import GridASR as JaxGridASR  # noqa: E402
from vcagan.eval.asr_models import LRWClassifier as JaxLRWClassifier  # noqa: E402
from vcagan.nn.audio_front import AudioFront as JaxAudioFront  # noqa: E402
from vcagan_torch.cli import asr_grid as cli_grid  # noqa: E402
from vcagan_torch.cli import asr_lrw as cli_lrw  # noqa: E402
from vcagan_torch.dsp import MelPipeline  # noqa: E402
from vcagan_torch.eval import asr_grid, asr_lrw, text  # noqa: E402
from vcagan_torch.eval.asr_models import GridASR, LRWClassifier, load_asr  # noqa: E402
from vcagan_torch.io.wav import write_wav  # noqa: E402
from vcagan_torch.io.weights import as_tensors, asr_from_jax, audio_front_state  # noqa: E402
from vcagan_torch.nn import AudioFront  # noqa: E402


TOL = dict(rtol=2e-4, atol=2e-4)
MARGIN = 2e-3
# kind -> (JAX model, port model, mel frames, converter, AudioFront arguments)
KINDS = {
    "grid": (JaxGridASR, GridASR, 300, convert_grid_asr,
             dict(ch1=32, ch2=64, out_dim=256, kernel=5, res_relu_type="prelu")),
    "lrw": (JaxLRWClassifier, LRWClassifier, 116, convert_lrw_asr,
            dict(ch1=128, ch2=256, out_dim=512, kernel=3, res_relu_type="relu")),
}
CLASSES = ["ABOUT", "ABSOLUTELY", "ACCESS"]


def jax_model(kind, classes=500):
    cls = KINDS[kind][0]
    return cls() if kind == "grid" else cls(num_classes=classes)


def port_model(kind, classes=500):
    cls = KINDS[kind][1]
    return cls() if kind == "grid" else cls(num_classes=classes)


@functools.lru_cache(maxsize=None)
def jax_variables(kind, seed=0, classes=500):
    """Seeded random flax variables of the JAX model (nothing compiles)."""
    frames = KINDS[kind][2]
    shapes = jax.eval_shape(functools.partial(jax_model(kind, classes).init, train=False),
                            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 80, frames, 1)))
    rng = np.random.default_rng(seed)
    return {"params": _fill(shapes["params"], rng, stats=False),
            "batch_stats": _fill(shapes["batch_stats"], rng, stats=True)}


def loaded(kind, seed=0, classes=500):
    return port_model(kind, classes).load_state_dicts(
        *asr_from_jax(jax_variables(kind, seed, classes), kind))


def mels(b, frames, seed):
    """Log-mels in the range the models see (log 1e-5 .. 0)."""
    return np.random.default_rng(seed).uniform(-11.5, 0.0, (b, 80, frames)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_audio_front_matches_jax(kind):
    args = KINDS[kind][4]
    variables = jax_variables(kind)
    p, s = variables["params"]["audio_front"], variables["batch_stats"]["audio_front"]
    mel = mels(2, KINDS[kind][2], seed=1)
    want = JaxAudioFront(**args).apply({"params": p, "batch_stats": s},
                                       jnp.asarray(mel[..., None]), train=False)
    front = AudioFront(**args).eval()
    front.load_state_dict(as_tensors(audio_front_state(p, s, kind == "grid")), strict=True)
    with torch.no_grad():
        got = front(torch.from_numpy(mel))
    assert got.shape == want.shape == (2, KINDS[kind][2] // 4, args["out_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_asr_logits_match_jax(kind):
    mel = mels(2, KINDS[kind][2], seed=2)
    want = jax_model(kind).apply(jax_variables(kind), jnp.asarray(mel[..., None]), train=False)
    got = loaded(kind)(torch.from_numpy(mel))
    assert got.shape == want.shape == ((2, 75, 28) if kind == "grid" else (2, 500))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_converters_round_trip_exactly(kind):
    """Port state dicts -> the converter -> ``asr_from_jax`` gives them back
    bit for bit (the front's projection rows permuted with its own C: 64
    for GRID, 256 for LRW)."""
    torch.manual_seed(3)
    model = port_model(kind)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.randn_like(t))
    front, back = model.front.state_dict(), model.back.state_dict()
    got_front, got_back = asr_from_jax(KINDS[kind][3](front, back), kind)
    for want, got in ((front, got_front), (back, got_back)):
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def test_asr_from_jax_refuses_unmatched_leaves():
    variables = jax_variables("grid")
    extra = {"params": {**variables["params"], "head2": {"kernel": np.zeros((2, 2))}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="params/head2/kernel"):
        asr_from_jax(extra, "grid")
    # the GRID front's PReLU block slopes have no place in the LRW model
    with pytest.raises(KeyError, match="params/audio_front/res/act1/alpha"):
        asr_from_jax(variables, "lrw")
    with pytest.raises(ValueError, match="kind"):
        asr_from_jax(variables, "lrs")


def test_text_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 75, 28)).astype(np.float32)
    words = ["PLACE", "BLUE", "AT", "A", "ZERO", "NOW", "BIN", "RED"]
    labels = [" ".join(rng.choice(words, 6)) for _ in range(6)]
    assert text.greedy_decode_batch(logits, labels) == jax_text.greedy_decode_batch(
        jnp.asarray(logits), labels)
    for _ in range(20):
        a = "".join(rng.choice(list(text.GRID_VOCAB), rng.integers(0, 30)))
        b = "".join(rng.choice(list(text.GRID_VOCAB), rng.integers(0, 30)))
        assert text.levenshtein(a, b) == jax_text.levenshtein(a, b)
        assert text.wer_cer(a, b) == jax_text.wer_cer(a, b)
        assert text.collapse_prediction(b) == jax_text.collapse_prediction(b)
    assert text.GRID_VOCAB == jax_text.GRID_VOCAB


def speechlike(seconds, seed):
    """A waveform with a moving spectrum: modulated harmonics and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t)
    wav = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16_000) / k for k in range(1, 8))
    wav *= 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2
    return (0.3 * wav / np.abs(wav).max() + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The JAX ASR tests' layouts (``tests/test_asr.py``): GRID
    ``spec_mel/s1/<name>.npz`` (and ``wav/s1/<name>.wav``) with
    ``gt/s1/align/<name>.align``; LRW ``<CLASS>/test/<CLASS>_<n>.npz`` (and
    ``.wav``)."""
    root = tmp_path_factory.mktemp("asr")
    rng = np.random.default_rng(5)
    names = ("bbaf2n", "bgwi8a", "lrae3s")
    for sub in ("spec_mel/s1", "wav/s1", "gt/s1/align"):
        (root / sub).mkdir(parents=True)
    for i, name in enumerate(names):
        mel = np.clip(rng.standard_normal((1, 80, 280)), -1, 1).astype(np.float32)
        np.savez(root / "spec_mel/s1" / f"{name}.npz", mel=mel, spec=mel)
        write_wav(str(root / "wav/s1" / f"{name}.wav"), speechlike(3.0, seed=i))
        with open(root / "gt/s1/align" / f"{name}.align", "w") as f:
            f.write("0 100 SIL\n100 200 place\n200 300 blue\n300 350 sp\n350 400 at\n")
    for i, word in enumerate(CLASSES):
        (root / "lrw" / word / "test").mkdir(parents=True)
        mel = np.clip(rng.standard_normal((1, 80, 110 + 5 * i)), -1, 1).astype(np.float32)
        np.savez(root / "lrw" / word / "test" / f"{word}_00001.npz", mel=mel)
        write_wav(str(root / "lrw" / word / "test" / f"{word}_00002.wav"),
                  speechlike(1.16, seed=10 + i))
    return root


def test_mels_from_wavs_match_jax(fixtures):
    path = str(fixtures / "wav/s1/bbaf2n.wav")
    want, n_want = jax_asr_grid.load_mel_from_wav(path, JaxMelPipeline(), 300)
    got, n_got = asr_grid.load_mel_from_wav(path, MelPipeline(), 300)
    assert n_got == n_want == 300 and got.shape == want.shape == (80, 300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    npz = str(fixtures / "spec_mel/s1/bbaf2n.npz")
    for frames in (300, 200):  # padded, cropped
        want, n_want = jax_asr_grid.load_mel_from_npz(npz, frames)
        got, n_got = asr_grid.load_mel_from_npz(npz, frames)
        assert n_got == n_want and got.shape == want.shape == (80, frames)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def token_readings(got_logits, want_logits):
    """(steps whose JAX top-two margin is at most MARGIN, steps whose token
    differs); the tokens must be equal wherever the margin is larger."""
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) <= MARGIN
    differ = got_logits.argmax(-1) != want_logits.argmax(-1)
    assert not differ[~close].any()
    return int(close.sum()), int(differ.sum())


@pytest.mark.parametrize("wav", [False, True], ids=["npz", "wav"])
def test_grid_evaluate_matches_jax(fixtures, wav):
    data = str(fixtures / ("wav" if wav else "spec_mel"))
    files = asr_grid.list_generated(data, wav)
    assert len(files) == 3
    load_j = (functools.partial(jax_asr_grid.load_mel_from_wav, pipeline=JaxMelPipeline())
              if wav else jax_asr_grid.load_mel_from_npz)
    load_p = (functools.partial(asr_grid.load_mel_from_wav, pipeline=MelPipeline())
              if wav else asr_grid.load_mel_from_npz)
    mel_j = np.stack([load_j(f, max_mel_frames=300)[0] for f in files])
    mel_p = np.stack([load_p(f, max_mel_frames=300)[0] for f in files])
    want = np.asarray(jax_model("grid").apply(jax_variables("grid"),
                                              jnp.asarray(mel_j[..., None]), train=False))
    got = loaded("grid")(torch.from_numpy(mel_p)).numpy()
    close, differ = token_readings(got, want)
    print(f"GRID {'wav' if wav else 'npz'}: {close} of {got.shape[0] * got.shape[1]} steps "
          f"within the margin, {differ} tokens differ")
    assert differ == 0  # so the decoded strings, WER and CER are the JAX package's
    kw = dict(wav=wav, batch_size=2)
    assert asr_grid.evaluate(data, str(fixtures / "gt"), loaded("grid"), **kw) == \
        jax_asr_grid.evaluate(data, str(fixtures / "gt"), jax_variables("grid"), **kw)


@pytest.mark.parametrize("wav", [False, True], ids=["npz", "wav"])
def test_lrw_evaluate_matches_jax(fixtures, wav):
    data = str(fixtures / "lrw")
    variables = jax_variables("lrw", seed=6, classes=len(CLASSES))
    model = loaded("lrw", seed=6, classes=len(CLASSES))
    acc = asr_lrw.evaluate(data, CLASSES, model, wav=wav, batch_size=2)
    assert acc == jax_asr_lrw.evaluate(data, CLASSES, variables, wav=wav, batch_size=2)
    assert 0.0 <= acc[0] <= 1.0 and acc[0] + acc[1] == 1.0
    # the logits of the same mels, and the margins that decide the argmax
    paths = sorted(str(p) for p in (fixtures / "lrw").glob("*/test/*." + ("wav" if wav else "npz")))
    if wav:
        mel = np.stack([asr_lrw.pad_or_crop(asr_lrw.mel_from_wav(p, MelPipeline()), 116)[0]
                        for p in paths])
    else:
        mel = np.stack([asr_grid.load_mel_from_npz(p, 116)[0] for p in paths])
    want = np.asarray(jax_model("lrw", len(CLASSES)).apply(variables, jnp.asarray(mel[..., None]),
                                                           train=False))
    got = model(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    close, differ = token_readings(got, want)
    print(f"LRW {'wav' if wav else 'npz'}: {close} of {got.shape[0]} clips within the margin, "
          f"{differ} predictions differ")
    assert differ == 0


@pytest.mark.parametrize("argv", [
    [],
    ["--data", "d", "--wav", "--gtpath", "g", "--checkpoint", "c.npz", "--batch_size", "8",
     "--max_timesteps", "60", "--platform", "cpu", "--dataparallel", "--gpu", "1"],
])
@pytest.mark.parametrize("clis", [(cli_grid, jax_cli_grid), (cli_lrw, jax_cli_lrw)],
                         ids=["asr_grid", "asr_lrw"])
def test_asr_cli_argv_equals_the_jax_clis(clis, argv):
    if clis[0] is cli_lrw:
        argv = [a for a in argv if a not in ("--gtpath", "g", "--max_timesteps", "60")]
        argv = [a if a != "d" else "lrw" for a in argv] + ["--class_list", "k.txt"]
    assert vars(clis[0].parse_args(argv)) == vars(clis[1].parse_args(argv))


def test_asr_clis_run_on_the_cpu(fixtures, tmp_path, capsys):
    """Both CLIs on the CPU: GRID from an ``.npz`` of variables (the JAX
    CLI's format), LRW from the reference torch checkpoint's two state
    dicts and from an ``.npz``; both equal ``evaluate`` on the same model.
    Without ``--platform cpu`` they need CUDA; an orbax directory is
    refused by name."""
    grid_npz = tmp_path / "grid.npz"
    np.savez(grid_npz, variables=np.asarray(jax_variables("grid"), dtype=object))
    data, gt = str(fixtures / "spec_mel"), str(fixtures / "gt")
    cli_grid.main(["--data", data, "--gtpath", gt, "--checkpoint", str(grid_npz),
                   "--batch_size", "2", "--platform", "cpu"])
    wer, cer = asr_grid.evaluate(data, gt, loaded("grid"), batch_size=2)
    assert capsys.readouterr().out.splitlines() == [f"test_cer: {cer}", f"test_wer: {wer}"]

    classes = tmp_path / "classes.txt"
    classes.write_text("\n".join(w.lower() for w in CLASSES) + "\n")
    model = loaded("lrw", seed=6, classes=len(CLASSES))
    ref = tmp_path / "lrw.ckpt"
    torch.save({"a_front_state_dict": model.front.state_dict(),
                "a_back_state_dict": model.back.state_dict()}, ref)
    lrw_npz = tmp_path / "lrw.npz"
    np.savez(lrw_npz, variables=np.asarray(jax_variables("lrw", 6, len(CLASSES)), dtype=object))
    acc, wer = asr_lrw.evaluate(str(fixtures / "lrw"), CLASSES, model, batch_size=2)
    for ckpt in (ref, lrw_npz):
        cli_lrw.main(["--data", str(fixtures / "lrw"), "--class_list", str(classes),
                      "--checkpoint", str(ckpt), "--batch_size", "2", "--platform", "cpu"])
        assert capsys.readouterr().out.strip() == f"test_ACC: {acc} WER: {wer}"
    # no checkpoint: random init from seed 0, the smoke mode
    cli_lrw.main(["--data", str(fixtures / "lrw"), "--class_list", str(classes),
                  "--platform", "cpu"])
    assert capsys.readouterr().out.startswith("test_ACC: ")

    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for kind in ("grid", "lrw"):
        with pytest.raises(NotImplementedError, match="export_jax_train_state.py --asr"):
            load_asr(kind, str(orbax), device="cpu")
    if not torch.cuda.is_available():
        # CUDA is the default of the library call and of the CLI alike
        for kind in ("grid", "lrw"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                load_asr(kind)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_grid.main(["--data", data, "--gtpath", gt])


def test_asr_models_are_eval_only():
    model = GridASR()
    assert not model.training and not model.back.gru.training
    with pytest.raises(NotImplementedError, match="evaluation only"):
        model.train()
