"""Driver ``serve_files``: batch segmentation of a corpus of WAV files, as the
predict CLI runs it, through ``segma_tpu_torch.inference.run_inference_on_audios``.

Set-up: the model with seeded weights (``models/<family>.py`` of the
configuration); the corpus (the traffic's file
lengths, in its order, the same for every seed; their audio drawn from the
seed) written to a temporary directory; one warm-up pass over every file, which runs every
shape the window will (each file's segments and tail bucket), in two calls:
the first file alone, which pays the first use of everything, then the rest,
whose wall gives the rate. Window: one call over a list of visits (the
corpus again and again, links to its files) long enough for ``--seconds``
at that rate; its metric is the audio seconds of the visits whose RTTM was
written over the window's wall seconds. Under ``--trace 1`` the window is
the device slice, and the first visit is served once more after it as the
operator slice. Check: a sample of the visits, drawn from the seed
with the longest file in it, against the logits of the configuration's
plain reference (``reference/<family>.py``: ``model``, ``chunks``).

The compared number, ``rttm_diff``: the % of the sampled visits'
label-frames (20 ms frames x labels) where the served RTTM and the f32
reference's decision at 0.5 differ (a missing RTTM, or one off the frame
grid, differs everywhere). The widest gap among them (the reference logit
over the file's rms) is logged beside it.

Traffic keys: ``files_s`` (seconds of each file), ``signal`` (the ranges of
``wavgen.write_bursts``), ``inner_batch``,
``mesh`` ("off": one card; "auto": a replica on every card), ``transport``,
``pack_files``, ``reference_files`` (visits compared), ``checks``
(``rttm_diff``: the limit).
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from h100bench.harness import manifest as mf
from h100bench.harness.core import Check, Outcome, Run, release
from h100bench.reference.common import read_wav_int16
from h100bench.traffic.wavgen import SAMPLE_RATE, write_bursts

FRAME_S = 0.02


def write_corpus(run: Run, root: Path, device: torch.device) -> list[tuple[Path, int]]:
    """The traffic's files, in its order, their audio drawn from the seed
    (``wavgen.write_bursts`` with the traffic's ``signal``):
    [(path, samples)]."""
    lengths = [int(s * SAMPLE_RATE) for s in run.traffic["files_s"]]
    gen = torch.Generator(device=device).manual_seed(run.seed)
    root.mkdir(parents=True)
    files = []
    for k, n in enumerate(lengths):
        path = root / f"rec{k}.wav"
        write_bursts(path, n, gen, **run.traffic["signal"])
        files.append((path, n))
    return files


def links(files: list[tuple[Path, int]], root: Path) -> Path:
    """A directory ``root`` of links to ``files``, under their names."""
    root.mkdir(parents=True)
    for path, _ in files:
        (root / path.name).symlink_to(path.resolve())
    return root


def link_visits(files: list[tuple[Path, int]], audio_s: float,
                root: Path) -> list[tuple[Path, int]]:
    """Links to the corpus's files, in turn, until they hold ``audio_s``;
    their names sort in visit order."""
    root.mkdir(parents=True)
    visits, total, k = [], 0.0, 0
    while total < audio_s or not visits:
        path, n = files[k % len(files)]
        link = root / f"v{k:05d}_{path.stem}.wav"
        link.symlink_to(path.resolve())
        visits.append((link, n))
        total += n / SAMPLE_RATE
        k += 1
    return visits


def sample(items: list[tuple[Path, int]], seed: int, count: int) -> list[tuple[Path, int]]:
    """``count`` of the (path, samples) served, drawn from the seed: one of
    the longest, then others, of other lengths where there are."""
    rng = np.random.default_rng(seed + 1)
    longest = max(n for _, n in items)
    of_longest = [v for v in items if v[1] == longest]
    picks = [of_longest[int(rng.integers(len(of_longest)))]]
    others = [v for v in items if v[1] != longest] or [v for v in items if v not in picks]
    return picks + [others[int(k)] for k in rng.permutation(len(others))[: count - 1]]


def rttm_mask(path: Path, labels: list[str], frames: int) -> np.ndarray | None:
    """An RTTM's frames (20 ms) per label; None when it is missing, or an
    interval lies past the file's frames or off the frame grid."""
    if not path.exists():
        return None
    mask = np.zeros((frames, len(labels)), bool)
    for line in path.read_text().splitlines():
        f = line.split()
        if not f:
            continue
        start, n = float(f[3]) / FRAME_S, float(f[4]) / FRAME_S
        s, e = round(start), round(start) + round(n)
        if abs(start - round(start)) > 1e-3 or abs(n - round(n)) > 1e-3 or e > frames:
            return None
        mask[s:e, labels.index(f[7])] = True
    return mask


def disagreement(logits: np.ndarray, mask: np.ndarray | None) -> tuple[int, int, float]:
    """(label-frames where the served RTTM and the reference's decision at
    the threshold 0.5 (logit 0) differ, label-frames, the widest |reference
    logit| among those that differ over the root mean square of the file's
    reference logits). A missing RTTM, or one off the frame grid, differs
    everywhere."""
    total = logits.size
    if mask is None:
        return total, total, float("inf")
    differ = mask != (logits > 0)
    if not differ.any():
        return 0, total, 0.0
    rms = float(np.sqrt(np.mean(np.square(logits, dtype=np.float64))))
    return int(differ.sum()), total, float(np.abs(logits[differ]).max()) / rms


def summary(parts: list[tuple[int, int, float]]) -> dict[str, float]:
    """``rttm_diff``: the % of the sampled label-frames that differ;
    ``rttm_gap``: the widest gap among them."""
    return {"rttm_diff": 100.0 * sum(p[0] for p in parts) / sum(p[1] for p in parts),
            "rttm_gap": max(p[2] for p in parts)}


def serve(run: Run, cfg, model, wavs: Path, out: Path, device: torch.device) -> list[Path]:
    from segma_tpu_torch.inference import run_inference_on_audios

    tr = run.traffic
    return run_inference_on_audios(
        cfg, wavs, None, out, model=model, batch_size=tr["inner_batch"],
        transport=tr["transport"], pack_files=tr["pack_files"], mesh=tr["mesh"], device=device)


def run(run: Run) -> Outcome:
    tr = run.traffic
    device = torch.device("cuda:0" if run.device == "cuda" else run.device)
    cfg = run.program_config()
    labels = list(cfg.data.classes)
    ref = mf.reference_module(run.config)
    t_model = time.perf_counter()
    model, sd = mf.family_module(run.config).build(run, cfg, device)
    notes = [f"set-up: imports {t_model - run.t_process:.1f} s, model "
             f"{time.perf_counter() - t_model:.1f} s"]
    with tempfile.TemporaryDirectory(prefix="h100bench-serve-") as tmp:
        tmp = Path(tmp)
        t_corpus = time.perf_counter()
        files = write_corpus(run, tmp / "corpus", device)
        corpus_s = sum(n for _, n in files) / SAMPLE_RATE
        notes.append(f"set-up: corpus of {corpus_s:.1f} s written in "
                     f"{time.perf_counter() - t_corpus:.1f} s")
        # the warm-up pass, in two calls: the first file alone (kernels built
        # and loaded, first-use costs), then the others, which give the rate
        t_first = time.perf_counter()
        serve(run, cfg, model, links(files[:1], tmp / "warm_first"), tmp / "warm", device)
        run.sync()
        t0 = time.perf_counter()
        serve(run, cfg, model, links(files[1:], tmp / "warm_rest"), tmp / "warm", device)
        run.sync()
        rate = sum(n for _, n in files[1:]) / SAMPLE_RATE / (time.perf_counter() - t0)
        visits = link_visits(files, run.seconds * rate, tmp / "visits")
        notes.append(f"set-up: warm-up pass, first file {t0 - t_first:.1f} s, the others at "
                     f"{rate:.1f} x real time; window: {len(visits)} visits")

        run.open_window()
        done = set(serve(run, cfg, model, tmp / "visits", tmp / "out", device))
        run.close_window(chunks=sum(ref.chunks(n) for _, n in visits))
        # under --trace 1, the operator slice: the first visit served again
        run.trace_operators(lambda: serve(run, cfg, model, links(visits[:1], tmp / "again"),
                                          tmp / "again_out", device))

        rttms = tmp / "out" / "raw_rttm"
        served = [(p, n) for p, n in visits
                  if p in done and (rttms / f"{p.stem}.rttm").exists()]
        audio_s = sum(n for _, n in served) / SAMPLE_RATE
        peak = run.memory_peak()
        del model
        release(device)

        intervals = sum(len(f.read_text().splitlines()) for f in rttms.glob("*.rttm"))
        notes.append(f"window: {intervals} RTTM intervals for {audio_s:.1f} s of audio "
                     f"({intervals * 3600 / max(audio_s, 1e-9):.1f} an hour)")
        picks = sample(visits, run.seed, tr["reference_files"])
        reference = ref.model(sd, run.config, device)
        parts = []
        t_ref = time.perf_counter()
        for path, n in picks:
            logits = reference.file_logits(read_wav_int16(path)).cpu().numpy()
            parts.append(disagreement(logits, rttm_mask(rttms / f"{path.stem}.rttm", labels,
                                                        len(logits))))
            notes.append(f"compared {path.name} ({n / SAMPLE_RATE:.1f} s, {len(logits)} "
                         f"frames): {parts[-1][0]} of {parts[-1][1]} label-frames differ, the "
                         f"widest at {parts[-1][2]!r} of the logits' rms")
        notes.append(f"reference: {time.perf_counter() - t_ref:.1f} s for {len(picks)} visits")
        compared = summary(parts)
    return Outcome(
        measured={"serve_xrt": audio_s / run.window_s},
        attempted=len(visits), failed=len(visits) - len(served),
        checks=[Check("rttm_diff", compared["rttm_diff"], tr["checks"]["rttm_diff"])],
        memory_peak_bytes=peak, notes=notes, readings=compared)


def calibrate(run: Run) -> dict:
    """This seed's readings of ``rttm_diff`` (and of the widest gap), over the
    longest file and more drawn from the seed, served through the window's
    own call: the program's, and the precision control's (the reference in
    fp8 put in the program's place, its decisions at 0.5), each against the
    f32 reference."""
    device = torch.device("cuda:0" if run.device == "cuda" else run.device)
    cfg = run.program_config()
    labels = list(cfg.data.classes)
    ref = mf.reference_module(run.config)
    model, sd = mf.family_module(run.config).build(run, cfg, device)
    with tempfile.TemporaryDirectory(prefix="h100bench-control-") as tmp:
        tmp = Path(tmp)
        files = write_corpus(run, tmp / "corpus", device)
        picks = sample(files, run.seed, run.traffic["reference_files"])
        serve(run, cfg, model, links(picks, tmp / "sample"), tmp / "out", device)
        del model
        release(device)
        exact = ref.model(sd, run.config, device)
        fp8 = ref.model(sd, run.config, device, precision="fp8")
        parts: dict[str, list] = {"program": [], "control": []}
        for path, _ in picks:
            pcm = read_wav_int16(path)
            ref_logits = exact.file_logits(pcm).cpu().numpy()
            rttm = tmp / "out" / "raw_rttm" / f"{path.stem}.rttm"
            parts["program"].append(disagreement(ref_logits,
                                                 rttm_mask(rttm, labels, len(ref_logits))))
            parts["control"].append(disagreement(ref_logits,
                                                 fp8.file_logits(pcm).cpu().numpy() > 0))
    return {who: summary(p) for who, p in parts.items()}
