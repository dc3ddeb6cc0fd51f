"""The LRS2/LRS3 data of the PyTorch port against the JAX package's.

- The split lists (``lrs_file_list``) and the crop-table parser
  (``load_crop_table``) against the JAX package's.
- The spec chain: ``lrs_normalize_spec`` (min/max over the valid frames
  only, or over all) and ``lrs_denormalize_spec``.
- The dynamic lip crops: the port's batched ``crop_resize_dynamic`` and
  ``crop_resize_dynamic_sup`` against the JAX package's per-clip functions,
  with no jitter and with fixed jitters, centres on and past the frame's
  edges; the superset path equals the full-frame path (as
  ``tests/test_lrs.py:149`` holds the JAX package's), and
  ``precrop_superset`` gives the same bytes.
- ``LRSDataset``: raw batches byte-identical to the JAX package's over the
  same synthetic clips, in 50-frame train windows (clips shorter than the
  window among them) and in eval buckets (``drop_last=False``, ``n_valid``),
  and ``sort_by_length`` keeps each clip's identity in ``idx``.
- ``make_lrs_device_pipeline`` against the JAX pipeline on the same raw
  batch, without augmentation and with the JAX package's own jitter and
  flip draws replayed from its key.
- ``ParallelEpoch`` carries an LRS batch's extra keys (``centers``,
  ``centers_m``, ``vid_hw``, ``idx``) as tensors; without the corpus
  ``make_lrs_dataset`` warns, naming the root.

Tolerances: normalised video within 2e-5 (pixels / 255 through two fp32
resize products and (x - 0.4136) / 0.17, values up to 3.5; the resize
weights are ``jax.image.resize``'s, computed apart, 5.4e-7 from them); the
normalised mel within 1e-4 (fp32 FFTs, then a log scaled by 2 / 11.5: 1e-4
is about 6e-4 in the log; measured 1.7e-6); the normalised spec of the
pipeline within 1e-3, and at most 0.1% of its elements more than 2e-5 off:
the per-clip min-max puts each clip's quietest bin at a unit value near 0,
where the log multiplies the FFTs' absolute fp32 difference by 1 / unit
(measured 1.5e-4 at one bin of -0.9955, 0.007% of the elements past 2e-5);
``lrs_normalize_spec`` alone on the same input within 1e-4; the
denormalised spec rtol 1e-5 (one exp of an fp32 value); crops between the
port's own two paths, the raw batches and the supersets exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.configs import AudioConfig as JaxAudioConfig
from vcagan.configs import DataConfig as JaxDataConfig
from vcagan.data import lrs as jax_lrs
from vcagan.data import splits as jax_splits
from vcagan_torch.configs import AudioConfig, DataConfig
from vcagan_torch.data import lrs
from vcagan_torch.data import splits
from vcagan_torch.data.prefetch import ParallelEpoch
from _torch_threads import _one_thread  # noqa: F401  (autouse)

LENGTHS = [30, 64, 41, 80, 35, 52]  # three clips shorter than the 50-frame window
BATCH = 4
AUDIO = AudioConfig(f_max=7600.0)
DATA = DataConfig(dataset="LRS2", window_size=50, max_v_timesteps=160)
VIDEO_TOL = dict(atol=2e-5, rtol=0)
NORM_TOL = dict(atol=1e-4, rtol=0)
SPEC_TOL, SPEC_CLOSE, SPEC_FAR_SHARE = dict(atol=1e-3, rtol=0), 2e-5, 1e-3
KEYS = ("video_raw", "centers", "aud_cond", "wav", "vid_len", "mel_len", "n_valid", "idx",
        "centers_m", "vid_hw")


def jax_config(cfg):
    cls = JaxAudioConfig if isinstance(cfg, AudioConfig) else JaxDataConfig
    return cls(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def datasets(mode, seed=0, data=DATA):
    port = lrs.LRSDataset(lrs.SyntheticLRSSource(lengths=LENGTHS), AUDIO, data, mode, seed)
    ref = jax_lrs.LRSDataset(jax_lrs.SyntheticLRSSource(lengths=LENGTHS), jax_config(AUDIO),
                             jax_config(data), mode, seed)
    return port, ref


def assert_same_batches(got, want, keys=KEYS):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(keys)
        for k in keys:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


def test_split_lists_and_crop_table_match_jax(tmp_path):
    lrs2 = tmp_path / "LRS2"
    lrs2.mkdir()
    (lrs2 / "train.txt").write_text("6330311066473698535/00011 NF\n\n6331559613336179781/00004\n")
    (lrs2 / "val.txt").write_text("6331559613336179781/00010\n")
    (lrs2 / "pretrain.txt").write_text("5535415699068794046/00001\n")
    for dataset, root in (("LRS2", str(tmp_path)), ("LRS3", "./data")):
        for mode in ("train", "val", "test") if dataset == "LRS3" else ("train", "val"):
            got = splits.lrs_file_list("root", dataset, mode, root)
            assert got == jax_splits.lrs_file_list("root", dataset, mode, root) and got
    table = tmp_path / "preprocess_main.txt"
    table.write_text("6330311066473698535/00011.mp4 85/118/85/117/86.0/117/\nbroken\n")
    got = splits.load_crop_table(str(table), "main")
    assert got == jax_splits.load_crop_table(str(table), "main")
    assert got == {"main/6330311066473698535/00011": [85, 118, 85, 117, 86, 117]}


def test_normalize_and_denormalize_spec():
    rng = np.random.default_rng(0)
    spec = np.abs(rng.standard_normal((3, 40, 321))).astype(np.float32) * 30
    valid = np.arange(40)[None, :] < np.asarray([40, 17, 0])[:, None]
    spec[1, 17:] = 1e4  # padding outside the valid frames must not enter the min/max
    for v in (valid, None):
        want = jax_lrs.lrs_normalize_spec(jnp.asarray(spec), None if v is None else jnp.asarray(v))
        got = lrs.lrs_normalize_spec(torch.from_numpy(spec),
                                     None if v is None else torch.from_numpy(v))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **NORM_TOL)
    norm = np.clip(rng.standard_normal((2, 50, 321)), -1, 1).astype(np.float32)
    np.testing.assert_allclose(lrs.lrs_denormalize_spec(torch.from_numpy(norm)).numpy(),
                               np.asarray(jax_lrs.lrs_denormalize_spec(jnp.asarray(norm))),
                               rtol=1e-5, atol=0)


def edge_frames(channels):
    """Three clips of 5 frames, 100 x 120, with centres in the frame, on its
    edges and past them (the jitter's clip bounds bite)."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (3, 5, 100, 120, channels), dtype=np.uint8)
    centers = np.asarray([
        [[60, 50], [61, 49], [62, 50], [60, 52], [59, 50]],
        [[2, 2], [118, 98], [-12, 50], [132, -7], [0, 99]],
        [[40, 95], [100, 5], [60, 110], [-3, -3], [125, 104]],
    ], np.int32)
    return frames, centers


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("jitter", [[0, 0, 0], [5, -5, 3]])
def test_dynamic_crops_match_jax(jitter, channels):
    frames, centers = edge_frames(channels)
    j = np.asarray(jitter, np.int32)
    want = np.stack([np.asarray(jax_lrs.crop_resize_dynamic(
        jnp.asarray(f), jnp.asarray(c), jnp.int32(s))) for f, c, s in zip(frames, centers, j)])
    got = lrs.crop_resize_dynamic(torch.from_numpy(frames), torch.from_numpy(centers),
                                  torch.from_numpy(j))
    assert got.shape == (3, 5, 112, 112, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **VIDEO_TOL)

    sups, cms = zip(*(lrs.precrop_superset(f, c) for f, c in zip(frames, centers)))
    for sup, cm, f, c in zip(sups, cms, frames, centers):
        want_sup, want_cm = jax_lrs.precrop_superset(f, c)
        assert sup.tobytes() == want_sup.tobytes() and cm.tobytes() == want_cm.tobytes()
    hw = np.asarray([frames.shape[2:4]] * 3, np.int32)
    want_sup = np.stack([np.asarray(jax_lrs.crop_resize_dynamic_sup(
        jnp.asarray(s), jnp.asarray(c), jnp.asarray(m), jnp.asarray(h), jnp.int32(x)))
        for s, c, m, h, x in zip(sups, centers, cms, hw, j)])
    got_sup = lrs.crop_resize_dynamic_sup(
        torch.from_numpy(np.stack(sups)), torch.from_numpy(centers),
        torch.from_numpy(np.stack(cms)), torch.from_numpy(hw), torch.from_numpy(j))
    np.testing.assert_allclose(got_sup.numpy(), want_sup, **VIDEO_TOL)
    # the superset reads the full frame's pixels and zero padding exactly
    assert torch.equal(got_sup, got)


@pytest.mark.parametrize("seed", [0, 3])
def test_train_windows_are_byte_identical(seed):
    port, ref = datasets("train", seed)
    got, want = list(port.epoch(BATCH)), list(ref.epoch(BATCH))
    assert_same_batches(got, want)
    vid_len = np.concatenate([b["vid_len"] for b in got])
    assert got[0]["video_raw"].shape[1] == DATA.window_size
    assert (vid_len < DATA.window_size).any()  # short clips are padded
    short = got[0]["vid_len"].argmin()
    n = int(got[0]["vid_len"][short])
    if n < DATA.window_size:  # frames padded with zeros, centres with the last one
        assert not got[0]["video_raw"][short, n:].any()
        assert (got[0]["centers"][short, n:] == got[0]["centers"][short, n - 1]).all()


@pytest.mark.parametrize("sort_by_length", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_eval_buckets_are_byte_identical(shuffle, sort_by_length):
    port, ref = datasets("val")
    kw = dict(shuffle=shuffle, drop_last=False, sort_by_length=sort_by_length)
    got, want = list(port.epoch(BATCH, **kw)), list(ref.epoch(BATCH, **kw))
    assert_same_batches(got, want)
    assert [int(b["n_valid"]) for b in got] == [BATCH, len(LENGTHS) - BATCH]
    for b in got:
        longest = max(LENGTHS[i] for i in b["idx"])
        assert b["video_raw"].shape[1] == min(w for w in port.BUCKETS if w >= longest)
        np.testing.assert_array_equal(b["vid_len"], [LENGTHS[i] for i in b["idx"]])
    if sort_by_length and not shuffle:  # length-homogeneous batches, identity kept
        assert [b["video_raw"].shape[1] for b in got] == [80, 80]
        assert sorted(np.concatenate([b["idx"][:int(b["n_valid"])] for b in got])) == list(
            range(len(LENGTHS)))


def jax_draws(key, b):
    """The JAX pipeline's own per-clip jitter and flip for ``key``
    (``vcagan/data/lrs.py:565-576``)."""
    jitter, flip = [], []
    for k in jax.random.split(key, b):
        k_j, k_f = jax.random.split(k)
        jitter.append(int(jax.random.randint(k_j, (), -5, 6)))
        flip.append(bool(jax.random.bernoulli(k_f, 0.5)))
    return lrs.LRSDraws(torch.tensor(jitter), torch.tensor(flip))


@pytest.mark.parametrize("host_crop,augment", [(True, False), (False, False), (True, True)])
def test_device_pipeline_matches_jax(host_crop, augment):
    data = dataclasses.replace(DATA, host_crop=host_crop)
    port, _ = datasets("train", data=data)
    raw = next(port.epoch(BATCH))
    key = jax.random.PRNGKey(11)
    want = jax_lrs.make_lrs_device_pipeline(jax_config(AUDIO), augment=augment,
                                            host_crop=host_crop)(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    process = lrs.make_lrs_device_pipeline(AUDIO, augment=augment, device="cpu")
    got = process(raw, draws=jax_draws(key, BATCH) if augment else None)
    w = DATA.window_size
    assert got.video.shape == (BATCH, w, 112, 112, 1)
    assert got.mel.shape == (BATCH, 80, 4 * w) and got.spec.shape == (BATCH, 321, 4 * w)
    np.testing.assert_allclose(got.video.numpy(), np.asarray(want.video), **VIDEO_TOL)
    np.testing.assert_allclose(got.mel.numpy(), np.asarray(want.mel), **NORM_TOL)
    np.testing.assert_allclose(got.spec.numpy(), np.asarray(want.spec), **SPEC_TOL)
    assert (np.abs(got.spec.numpy() - np.asarray(want.spec)) > SPEC_CLOSE).mean() <= SPEC_FAR_SHARE
    for k in ("vid_len", "mel_len"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    for i, n in enumerate(raw["mel_len"]):  # -1.0 past each clip's frames
        assert (got.mel[i, :, n:] == -1).all() and (got.spec[i, :, n:] == -1).all()


def test_parallel_epoch_carries_the_lrs_keys():
    port, _ = datasets("val")
    want = list(port.epoch(BATCH, shuffle=True))
    port.rng = np.random.default_rng(0)
    feed = ParallelEpoch(port, BATCH, depth=2, device="cpu")
    got = list(feed)  # ParallelEpoch's epoch: shuffled, drop_last
    assert len(got) == 1 and len(feed.collate_s) == 1
    for k in KEYS:
        if k == "n_valid":
            assert int(got[0][k]) == int(want[0][k])
        else:
            assert torch.is_tensor(got[0][k]) and np.array_equal(got[0][k].numpy(), want[0][k]), k


@pytest.mark.parametrize("dataset", ["LRS2", "LRS3"])
def test_missing_corpus_falls_back_to_synthetic_clips_with_a_warning(tmp_path, dataset):
    data = dataclasses.replace(DATA, dataset=dataset, data_root=str(tmp_path / "no_corpus"),
                               synthetic_clips=5)
    with pytest.warns(UserWarning, match=f"not found under {tmp_path / 'no_corpus'}"):
        ds = lrs.make_lrs_dataset(data, AUDIO, "train")
    assert isinstance(ds.source, lrs.SyntheticLRSSource) and len(ds) == 5
