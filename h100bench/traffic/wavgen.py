"""Seeded audio for the traffic mixes, made on the card in blocks and
written as 16 kHz int16 mono WAVs.

``write_bursts`` is the serving corpus's signal: tone bursts of seeded
lengths, gaps, pitches and levels, as speech comes in turns, over digital
silence or a white-noise floor, drawn on the card in blocks. Its ranges
are the traffic file's and come from no measured corpus. It replaces
``chip_smoke.write_wav``'s 440 Hz tone over white noise (``chip_smoke.py``
lines 1062-1075): over white noise a randomly initialised model's
decisions flip from frame to frame, its RTTMs hold tens of thousands of
intervals an hour, and the host's work on them varies with the weights'
seed far more than with the program.

``write_dataset`` is ``chip_smoke.write_dataset``'s tree (lines 1257-1300):
``wav/``, ``aa/``, ``rttm/``, ``uem/`` and the split lists; per file,
labelled events, label i a 440 (i + 1) Hz tone over a noise floor at 0.01
(a randomly initialised HuBERT needs one: silence makes its post-norm
gradients overflow). Event starts and lengths are multiples of 1/64 s, so
that seconds convert to samples exactly.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np
import torch

SAMPLE_RATE = 16_000
BLOCK = 1 << 23  # samples generated and written at once
EVENT_STEP_S = 1 / 64


def _open(path: Path) -> wave.Wave_write:
    w = wave.open(str(path), "wb")
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(SAMPLE_RATE)
    return w


def _pcm16(sig: torch.Tensor) -> bytes:
    """f32 in [-1, 1] -> little-endian int16 bytes, as numpy's astype
    truncates."""
    return (sig.clamp(-1, 1) * 32767).to(torch.int16).cpu().numpy().astype("<i2").tobytes()


def write_bursts(path: Path, n_samples: int, gen: torch.Generator, burst_s: list[float],
                 gap_s: list[float], tone_hz: list[float], level: list[float],
                 noise: float = 0.0) -> None:
    """Tone bursts over silence, or over white noise of rms ``noise``: each
    burst's length, the gap before it, its pitch (log-uniform) and its level
    drawn from ``gen`` in the traffic's [low, high] ranges."""
    dev = gen.device
    # enough bursts to cover the file at the shortest burst and gap
    k = int(n_samples / (SAMPLE_RATE * (burst_s[0] + gap_s[0]))) + 1
    u = torch.rand((4, k), generator=gen, device=dev, dtype=torch.float64)
    span = lambda lo_hi, x: lo_hi[0] + (lo_hi[1] - lo_hi[0]) * x  # noqa: E731
    length = (span(burst_s, u[0]) * SAMPLE_RATE).long()
    start = torch.cumsum((span(gap_s, u[1]) * SAMPLE_RATE).long() + length, 0) - length
    hz = tone_hz[0] * (tone_hz[1] / tone_hz[0]) ** u[2]
    amp = span(level, u[3]).float()
    with _open(path) as w:
        for lo in range(0, n_samples, BLOCK):
            n = torch.arange(lo, min(n_samples, lo + BLOCK), device=dev, dtype=torch.int64)
            b = (torch.searchsorted(start, n, right=True) - 1).clamp(min=0)
            t = (n - start[b]).double() / SAMPLE_RATE
            on = (n >= start[b]) & (n < start[b] + length[b])
            sig = torch.where(on, amp[b] * torch.sin(2 * np.pi * hz[b] * t).float(),
                              torch.zeros((), device=dev))
            if noise:
                sig += noise * torch.randn(sig.shape, generator=gen, device=dev)
            w.writeframes(_pcm16(sig))


def events_for(rng: np.random.Generator, duration_s: float, per_minute: float,
               classes: list[str]) -> list[tuple[float, float, str]]:
    """(start s, length s, label) events of 0.25 to 3 s, about ``per_minute``
    a minute, on the 1/64 s grid."""
    k = max(1, int(round(per_minute * duration_s / 60)))
    steps = int(duration_s / EVENT_STEP_S)
    starts = np.sort(rng.integers(0, steps - 3 * 64, size=k))
    lengths = rng.integers(16, 3 * 64 + 1, size=k)
    which = rng.integers(len(classes), size=k)
    return [(float(s * EVENT_STEP_S), float(n * EVENT_STEP_S), classes[c])
            for s, n, c in zip(starts, lengths, which)]


def write_labelled_wav(path: Path, n_samples: int, events: list[tuple[float, float, str]],
                       classes: list[str], gen: torch.Generator) -> None:
    """The dataset's audio: noise at 0.01, each event's label a tone."""
    dev = gen.device
    spans = [(int(s * SAMPLE_RATE), int((s + d) * SAMPLE_RATE), classes.index(c))
             for s, d, c in events]
    with _open(path) as w:
        for lo in range(0, n_samples, BLOCK):
            hi = min(n_samples, lo + BLOCK)
            sig = 0.01 * torch.randn(hi - lo, generator=gen, device=dev)
            n = torch.arange(lo, hi, device=dev, dtype=torch.int64)
            for a, b, c in spans:
                if b <= lo or a >= hi:
                    continue
                i, j = max(a, lo) - lo, min(b, hi) - lo
                phase = (n[i:j] - a) % SAMPLE_RATE  # whole periods a second
                sig[i:j] = torch.sin((2 * np.pi * 440 * (c + 1) / SAMPLE_RATE) * phase.float())
            w.writeframes(_pcm16(sig))


def write_dataset(root: Path, classes: list[str], splits: dict[str, tuple[int, float]],
                  per_minute: float, seed: int, device: torch.device) -> None:
    """A SegmaFileDataset tree under ``root``: ``splits`` maps a split name
    to (files, seconds a file). File ids run over the splits in order."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    for sub in ("wav", "aa", "rttm", "uem"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    uid = 0
    for split, (count, duration_s) in splits.items():
        uids = [f"{uid + i:04d}" for i in range(count)]
        uid += count
        (root / f"{split}.txt").write_text("".join(u + "\n" for u in uids))
        for u in uids:
            events = events_for(rng, duration_s, per_minute, classes)
            write_labelled_wav(root / "wav" / f"{u}.wav", int(duration_s * SAMPLE_RATE), events,
                               classes, gen)
            (root / "aa" / f"{u}.aa").write_text(
                "".join(f"{u} {s} {d} {c}\n" for s, d, c in events))
            (root / "rttm" / f"{u}.rttm").write_text("".join(
                f"SPEAKER {u} 1 {s} {d} <NA> <NA> {c} <NA> <NA>\n" for s, d, c in events))
            (root / "uem" / f"{u}.uem").write_text(f"{u} NA 0.000 {duration_s}")
