"""Seeded traffic repeats exactly: the same seed writes the same bytes, the
same corpus order and the same crops; another seed does not."""

import hashlib

import numpy as np
import torch

from h100bench.reference.training import Corpus
from h100bench.traffic import wavgen

CLASSES = ["KCHI", "OCH", "MAL", "FEM"]


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_write_bursts_repeats(tmp_path, monkeypatch):
    monkeypatch.setattr(wavgen, "BLOCK", 4096)  # several blocks
    paths = []
    for k, seed in enumerate((7, 7, 8)):
        p = tmp_path / f"{k}.wav"
        wavgen.write_bursts(p, 40_000, torch.Generator().manual_seed(seed), [0.3, 1.0],
                            [0.2, 0.5], [100.0, 4000.0], [0.05, 0.5])
        paths.append(p)
    assert digest(paths[0]) == digest(paths[1]) != digest(paths[2])
    pcm = np.frombuffer(paths[0].read_bytes()[44:], "<i2")
    assert pcm.shape == (40_000,)
    on = pcm != 0
    assert 0.2 < on.mean() < 0.9 and np.abs(pcm).max() <= 0.5 * 32767 + 1
    # silence between bursts, bursts that start after a gap
    assert not on[:3000].all() and on.any()


def test_write_bursts_noise_floor(tmp_path):
    """The same bursts with a noise floor under them: no digital silence
    left, and each sample within a few rms of the silent version's."""
    pcm = []
    for noise in (0.0, 0.01):
        p = tmp_path / f"{noise}.wav"
        wavgen.write_bursts(p, 40_000, torch.Generator().manual_seed(7), [0.3, 1.0],
                            [0.2, 0.5], [100.0, 4000.0], [0.05, 0.5], noise=noise)
        pcm.append(np.frombuffer(p.read_bytes()[44:], "<i2").astype(np.int64))
    silent, noisy = pcm
    gaps = silent == 0
    assert gaps.mean() > 0.1 and (noisy[gaps] != 0).mean() > 0.9
    assert 0.005 * 32767 < noisy[gaps].std() < 0.02 * 32767
    assert np.abs(noisy - silent).max() <= 0.08 * 32767


def test_dataset_repeats(tmp_path):
    roots = [tmp_path / str(k) for k in range(3)]
    for root, seed in zip(roots, (3, 3, 4)):
        wavgen.write_dataset(root, CLASSES, {"train": (2, 6.0), "val": (1, 5.0)}, 30, seed,
                             torch.device("cpu"))
    files = sorted(p.relative_to(roots[0]) for p in roots[0].rglob("*") if p.is_file())
    assert [digest(roots[0] / f) for f in files] == [digest(roots[1] / f) for f in files]
    assert digest(roots[0] / "wav" / "0000.wav") != digest(roots[2] / "wav" / "0000.wav")
    for line in (roots[0] / "aa" / "0000.aa").read_text().splitlines():
        _, start, dur, label = line.split()
        assert float(start) * 64 == int(float(start) * 64) and label in CLASSES
        assert float(start) * 16_000 == int(float(start) * 16_000)


def test_crops_repeat(tmp_path):
    wavgen.write_dataset(tmp_path, CLASSES, {"train": (3, 8.0)}, 30, 5, torch.device("cpu"))
    corpus = Corpus(tmp_path, CLASSES)
    a = corpus.batches(11, 0, 2, 4, 3, 199)
    b = corpus.batches(11, 0, 2, 4, 3, 199)
    c = corpus.batches(12, 0, 2, 4, 3, 199)
    assert all(np.array_equal(x1, x2) and np.array_equal(y1, y2)
               for (x1, y1), (x2, y2) in zip(a, b))
    assert not np.array_equal(a[0][0], c[0][0])
    assert a[0][0].shape == (4, 64_000) and a[0][1].shape == (4, 199, 4)
