"""The port's copies of the jax-free preprocessing CLIs against the JAX
package's: the same argv, and the same results on the same inputs (the
same numpy, scipy and OpenCV calls: equal to the last bit)."""

import importlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

NAMES = ("extract_frames", "preprocess_grid", "extract_audio_lrs")


def modules(name):
    return (importlib.import_module(f"vcagan_torch.cli.{name}"),
            importlib.import_module(f"vcagan.cli.{name}"))


@pytest.mark.parametrize("argv", [[], ["--jobs", "5", "--out", "o"]])
@pytest.mark.parametrize("name", NAMES)
def test_argv_equals_the_jax_clis(name, argv):
    mine, theirs = modules(name)
    assert vars(mine.parse_args(argv)) == vars(theirs.parse_args(argv))


def test_preprocess_grid_equals_the_jax_cli(tmp_path):
    """Alignment and audio conditioning, then one clip end to end
    (``process_clip``): the same mp4 frames and wav bytes."""
    cv2 = pytest.importorskip("cv2")
    mine, theirs = modules("preprocess_grid")
    assert mine.default_ref_face() == theirs.default_ref_face()
    ref = mine.load_ref_face(mine.default_ref_face())
    np.testing.assert_array_equal(ref, theirs.load_ref_face(theirs.default_ref_face()))
    rng = np.random.default_rng(0)
    src = ref * 1.1 + rng.standard_normal(ref.shape) + [5.0, -3.0]
    np.testing.assert_array_equal(mine.umeyama_similarity(src, ref),
                                  theirs.umeyama_similarity(src, ref))
    wav = rng.standard_normal(16_000).astype(np.float32)
    np.testing.assert_array_equal(mine.highpass_audio(wav), theirs.highpass_audio(wav))

    clip = tmp_path / "grid" / "s1" / "video" / "bbaf2n"
    clip.mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(clip / f"{i:03d}.png"), rng.integers(0, 255, (96, 120, 3), np.uint8))
    from vcagan_torch.io.wav import write_wav
    write_wav(str(clip / "audio.wav"), 0.3 * wav)
    landmarks = tmp_path / "lm" / "s1" / "video"
    landmarks.mkdir(parents=True)
    np.save(landmarks / "bbaf2n.npy", np.stack([ref * 0.4 + [10 * i, 5] for i in range(3)]))
    outs = []
    for module, out in ((mine, "port"), (theirs, "jax")):
        args = module.parse_args(["--grid", str(tmp_path / "grid"), "--landmarks",
                                  str(tmp_path / "lm"), "--out", str(tmp_path / out)])
        assert module.process_clip(str(clip), args, ref).startswith("done")
        cap = cv2.VideoCapture(str(tmp_path / out / "s1" / "video" / "video" / "bbaf2n.mp4"))
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        with open(tmp_path / out / "s1" / "video" / "audio" / "bbaf2n.wav", "rb") as f:
            outs.append((np.stack(frames), f.read()))
    assert outs[0][0].shape == (3, 256, 256, 3)
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
