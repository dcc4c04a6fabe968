"""Segma's training steps worked out again in plain PyTorch and NumPy, for a
model of ``reference/<family>.py`` (``forward(wav, keep)``, ``trainable``,
``device``, ``dropout_keep(gen, crops, frames)``): the crops and labels the
loader's seed gives, per-label BCE, AdamW.

The steps (segma's trainer and loader): ``workers`` samplers, sampler w
seeded with (seed + 1000 w, epoch), whose batches are taken in turn; a
sample draws a file with probability proportional to its length, then a
start in [0, length - 64000); the labels of frame i of a crop at s are the
events that overlap samples [s + 320 i, s + 320 i + 399] (the 320-sample
hop and 400-sample field of the wav2vec2-style front end); the dropout
masks come from a generator on the card seeded with seed * 100003 +
epoch, one draw per step. The loss is each label's mean BCE over crops and
frames, summed over labels. AdamW: betas (0.9, 0.999), eps 1e-8, decoupled
weight decay 1e-4, on the trainable weights.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from h100bench.reference.common import bce_with_logits, ieee_f32, read_wav_int16, wav_frames

CHUNK = 64_000
SR = 16_000
FRAME = 320
RF = 400  # samples seen by one frame
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


class Corpus:
    """The training split as the loader sees it: files in ``train.txt``
    order, their lengths from the WAV headers, their events in samples."""

    def __init__(self, root: Path, classes: list[str]) -> None:
        self.root = Path(root)
        self.uris = [u.strip() for u in (self.root / "train.txt").read_text().splitlines()
                     if u.strip()]
        self.lengths = np.array([wav_frames(self.root / "wav" / f"{u}.wav") for u in self.uris])
        self.events = []
        for u in self.uris:
            rows = []
            for line in (self.root / "aa" / f"{u}.aa").read_text().splitlines():
                if not line.strip():
                    continue
                _, start, dur, label = line.split()
                if label in classes:
                    s, d = float(start), float(dur)
                    rows.append((int(s * SR), int((s + d) * SR), classes.index(label)))
            self.events.append(np.array(rows, np.int64).reshape(-1, 3))
        self.n_labels = len(classes)
        self._audio: dict[int, np.ndarray] = {}

    def audio(self, i: int) -> np.ndarray:
        if i not in self._audio:
            self._audio[i] = read_wav_int16(self.root / "wav" / f"{self.uris[i]}.wav")
        return self._audio[i]

    def targets(self, i: int, start: int, n_frames: int) -> np.ndarray:
        """(frames, labels) multi-hot: an event [a, b] covers frame f when it
        overlaps samples [start + 320 f, start + 320 f + 399]."""
        lo = start + FRAME * np.arange(n_frames)
        hi = lo + RF - 1
        ev = self.events[i]
        y = np.zeros((n_frames, self.n_labels), np.float32)
        for a, b, c in ev:
            y[(a <= hi) & (b >= lo), c] = 1.0
        return y

    def batches(self, seed: int, epoch: int, workers: int, batch: int, steps: int,
                n_frames: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """The first ``steps`` batches of ``epoch``: (crops int16 (B, 64000),
        targets (B, frames, labels))."""
        p = self.lengths.astype(np.float64) / self.lengths.sum()
        rngs = [np.random.default_rng((seed + 1000 * w, epoch)) for w in range(workers)]
        out = []
        for step in range(steps):
            rng = rngs[step % workers]
            xs, ys = [], []
            for _ in range(batch):
                i = int(rng.choice(len(self.uris), p=p))
                start = int(rng.integers(low=0, high=max(1, int(self.lengths[i]) - CHUNK)))
                xs.append(self.audio(i)[start: start + CHUNK])
                ys.append(self.targets(i, start, n_frames))
            out.append((np.stack(xs), np.stack(ys)))
        return out


def loss_fn(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    elt = bce_with_logits(logits, y)
    return elt.reshape(-1, elt.shape[-1]).mean(0).sum()


def train_steps(model, batches, lr: float, mask_seed: int) -> dict:
    """len(batches) AdamW steps in IEEE f32; returns the losses, the first
    step's gradients and the weights after the last step (trainable
    leaves)."""
    with ieee_f32():
        return _train_steps(model, batches, lr, mask_seed)


def _train_steps(model, batches, lr: float, mask_seed: int) -> dict:
    gen = torch.Generator(device=model.device).manual_seed(mask_seed)
    m = {k: torch.zeros_like(v) for k, v in model.trainable.items()}
    v2 = {k: torch.zeros_like(v) for k, v in model.trainable.items()}
    losses, first = [], None
    for t, (x, y) in enumerate(batches, start=1):
        wav = torch.from_numpy(x).to(model.device).float() * (1.0 / 32768.0)
        target = torch.from_numpy(y).to(model.device)
        n_frames = target.shape[1]
        keep = model.dropout_keep(gen, x.shape[0], n_frames)
        loss = loss_fn(model.forward(wav, keep), target)
        grads = torch.autograd.grad(loss, list(model.trainable.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(model.trainable, grads)}
        with torch.no_grad():
            for (k, p), g in zip(model.trainable.items(), grads):
                p.mul_(1 - lr * WEIGHT_DECAY)
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mhat = m[k] / (1 - BETAS[0] ** t)
                vhat = v2[k] / (1 - BETAS[1] ** t)
                p.sub_(lr * mhat / (vhat.sqrt() + EPS))
    return {"losses": losses, "grads": first,
            "params": {k: p.detach().clone() for k, p in model.trainable.items()}}
