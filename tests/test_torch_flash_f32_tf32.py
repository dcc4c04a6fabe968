"""The f32 flash kernels' arithmetic (csrc/flash_attn_f32.cu, the forward, and
csrc/flash_attn_bwd_f32.cu, the backward), emulated in numpy and held against
``attention_plain`` and ``attention_bwd_plain`` in float64.

Both kernels run every product in 3xTF32 on ``wgmma``: each f32 operand is
split into hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna.tf32.f32``), and a
product is lo·B_hi + hi·B_lo + hi·B_hi. A tensor-core sum truncates: each
``wgmma`` k-step of 8 adds its products to the accumulator and rounds toward
zero (``_rz32``). What the kernel does about it, and what this file emulates:

- The score products (S = Q Kᵀ, dP = dO Vᵀ and their transposes) reduce over
  the 64 head dims in 8 k-steps, each the head dims 16 j + 4 q + 2 t + h
  (q < 4, h < 2) of k-step 2 j + t: a permutation that lets a thread's
  float4 of the resident row feed two k-steps (``SCORE_KSTEPS``). The large
  terms go to one accumulator, the small ones to another, both fresh per
  tile, added in IEEE f32.
- The products over the rows of a streamed tile of 32 (dQ = dS K, dV = Pᵀ
  dO, dK = dSᵀ Q) take a fresh accumulator per tile, per k-step of 8 rows
  the two small terms then the large one, added into the running sum in
  IEEE f32 on the CUDA cores: no truncating chain spans more than one tile.
- P = exp2(S scale log2(e) - lse log2(e)) with one rounding (``fmaf``);
  dS = P (dP - D); keys past S masked in the dQ pass, queries past S given
  lse = +inf in the dK/dV pass.
- The forward (``emulate_fwd``) streams keys in the same tiles of 32: the
  score product as above, keys past S at -inf, the exp2-domain online
  softmax (with c = scale log2(e): the running max m of the raw scores and
  its scaled value ms = m c rounded to f32, ``alpha = exp2(ms_old -
  ms)``, ``P = exp2(fmaf(s, c, -ms))``, each thread's row sum over its 8
  columns of the tile, ``l = fmaf(l, alpha, sum)``), then P V as a product
  over the tile's rows into a fresh accumulator, added as ``O = fmaf(O,
  alpha, O_tile)`` in IEEE f32; at the end the four threads' row sums, O /
  l, and the LSE (ms + log2 l) ln 2. Taking alpha and the LSE from the
  rounded ms, the value P was taken against, keeps the LSE within 1.2e-6
  of float64 at S = 1500; from the exact m c (an ``fmaf``) each change of
  the max would leave up to half an ulp of ms in l, 5e-6 in all.

The kernel's B tiles are written with their k index permuted so that the f32
accumulator's columns (2 q, 2 q + 1 of each 8) are the TF32 A fragment's k
(q, q + 4) without shuffles; that permutes terms within one k-step, whose
sum the emulation takes exactly, so it changes no value here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flash_f32_ablations
from segma_tpu_torch.ops import attention, logmel

FLASH_F32_ATOL = 2e-5  # chip_smoke.py, tests/test_torch_kernels_gpu.py
LSE_F32_ATOL = 1e-5
FLASH_F32_BWD_REL = 5e-5
SM = 64**-0.5
LOG2E = np.float32(1.4426950408889634)
BT = 32  # streamed rows per tile (csrc/flash_attn_bwd_f32.cu)
BR = 128  # resident rows per work item

# head dims of each of the 8 k-steps of a score product: k-step 2 j + t,
# slot q + 4 h holds head dim 16 j + 4 q + 2 t + h
SCORE_KSTEPS = [
    np.array([16 * j + 4 * q + 2 * t + h for h in range(2) for q in range(4)])
    for j in range(4) for t in range(2)
]


def _rz32(a: np.ndarray) -> np.ndarray:
    """float64 to f32 rounded toward zero, as a tensor-core f32 sum is taken."""
    f = np.asarray(a, dtype=np.float64).astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).astype(np.float32).astype(np.float64)


def _split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi, lo = logmel.split_tf32(np.asarray(a, dtype=np.float32))
    return hi.astype(np.float64), lo.astype(np.float64)


def _score(a: np.ndarray, b: np.ndarray, fresh: bool = True, three: bool = True) -> np.ndarray:
    """a bᵀ over the 64 head dims: a (..., M, 64), b (..., N, 64). With
    ``fresh`` (the kernel) the large and the small terms in two accumulators
    added in IEEE f32; without, all three in one. Without ``three``, one
    TF32 product (the small terms are zero)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if not three:
        al, bl = 0 * al, 0 * bl
    lg = sm = 0.0
    for idx in SCORE_KSTEPS:
        bht, blt = bh[..., idx].swapaxes(-1, -2), bl[..., idx].swapaxes(-1, -2)
        sm = _rz32(sm + al[..., idx] @ bht)
        sm = _rz32(sm + ah[..., idx] @ blt)
        if fresh:
            lg = _rz32(lg + ah[..., idx] @ bht)
        else:
            sm = _rz32(sm + ah[..., idx] @ bht)
    return _f32(lg + sm) if fresh else sm


def _rows(acc, a: np.ndarray, b: np.ndarray, fresh: bool = True,
          three: bool = True) -> np.ndarray:
    """acc + a b over one streamed tile's rows: a (..., M, BT), b (..., BT,
    N). With ``fresh`` (the kernel) a new accumulator for the tile, added to
    acc in IEEE f32; without, the tensor-core sum runs on in acc. Without
    ``three``, one TF32 product."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if not three:
        al, bl = 0 * al, 0 * bl
    blk = 0.0 if fresh else acc
    for kk in range(BT // 8):
        s = slice(8 * kk, 8 * kk + 8)
        blk = _rz32(blk + al[..., s] @ bh[..., s, :])
        blk = _rz32(blk + ah[..., s] @ bl[..., s, :])
        blk = _rz32(blk + ah[..., s] @ bh[..., s, :])
    return _f32(acc + blk) if fresh else blk


def _exp2_rows(s: np.ndarray, l2: np.ndarray, scale_log2: np.float32) -> np.ndarray:
    """exp2(fmaf(s, scale_log2, -l2)) in f32: the product of two f32 is exact
    in float64, so one rounding after the subtraction."""
    with np.errstate(invalid="ignore"):
        x = (s * np.float64(scale_log2) - l2).astype(np.float32)
    return np.exp2(x).astype(np.float64)


def emulate_bwd(q, k, v, o, lse, do, sm: float, fresh: bool = True, three: bool = True):
    """(dq, dk, dv), (B, S, H, 64) float64 holding f32 values, as the kernel
    computes them from f32 (B, S, H, 64) q, k, v, o, dO and (B, H, S) lse."""
    b, s, h, d = q.shape
    sp = -(-s // BR) * BR  # resident rows padded to whole items (TMA zero fill)
    n_tiles = -(-s // BT)

    def bhsd(x):
        out = np.zeros((b, h, sp, d), np.float32)
        out[:, :, :s] = np.asarray(x, np.float32).transpose(0, 2, 1, 3)
        return out.astype(np.float64)

    q, k, v, o, do = map(bhsd, (q, k, v, o, do))
    scale_log2 = np.float32(sm * np.log2(np.e))
    l2 = np.full((b, h, sp), np.inf)
    l2[:, :, :s] = (np.asarray(lse, np.float32) * LOG2E).astype(np.float64)
    dd = np.einsum("bhsd,bhsd->bhs", do.astype(np.float32), o.astype(np.float32),
                   dtype=np.float32).astype(np.float64)

    dq = np.zeros((b, h, sp, d))
    for j in range(n_tiles):  # dQ pass: streamed keys
        t = slice(BT * j, BT * j + BT)
        p = _exp2_rows(_score(q, k[:, :, t], fresh, three), l2[..., None], scale_log2)
        dp = _score(do, v[:, :, t], fresh, three)
        ds = _f32(p * _f32(dp - dd[..., None]))
        ds[..., np.arange(BT * j, BT * j + BT) >= s] = 0.0
        dq = _rows(dq, ds, k[:, :, t], fresh, three)
    dk = np.zeros((b, h, sp, d))
    dv = np.zeros((b, h, sp, d))
    for j in range(n_tiles):  # dK/dV pass: streamed queries
        t = slice(BT * j, BT * j + BT)
        pt = _exp2_rows(_score(k, q[:, :, t], fresh, three), l2[:, :, None, t], scale_log2)
        dpt = _score(v, do[:, :, t], fresh, three)
        dst = _f32(pt * _f32(dpt - dd[:, :, None, t]))
        dv = _rows(dv, pt, do[:, :, t], fresh, three)
        dk = _rows(dk, dst, q[:, :, t], fresh, three)
    scale = np.float32(sm)
    return tuple(
        _f32(x * scale if m else x)[:, :, :s].transpose(0, 2, 1, 3)
        for x, m in ((dq, True), (dk, True), (dv, False))
    )


def emulate_fwd(q, k, v, sm: float, three: bool = True, running_o: bool = False):
    """(out (B, S, H, 64), lse (B, H, S)), float64 holding f32 values, as the
    forward kernel computes them from f32 (B, S, H, 64) q, k and v. Without
    ``three``, one TF32 product in both products; with ``running_o``, O in
    one tensor-core accumulator across the tiles (scaled by alpha on the CUDA
    cores, then P V summed into it, truncating) instead of a fresh one per
    tile."""
    b, s, h, d = q.shape
    n_tiles = -(-s // BT)

    def bhsd(x, rows):
        out = np.zeros((b, h, rows, d), np.float32)  # keys past S: TMA's zero rows
        out[:, :, :s] = np.asarray(x, np.float32).transpose(0, 2, 1, 3)
        return out.astype(np.float64)

    q = bhsd(q, s)
    k, v = bhsd(k, n_tiles * BT), bhsd(v, n_tiles * BT)
    c = np.float32(sm * np.log2(np.e))
    m = np.full((b, h, s), -np.inf)  # the running max of the raw scores
    ms = np.full((b, h, s), -np.inf)  # m c in f32
    part = np.zeros((b, h, s, 4))  # the row sum of each of the 4 threads of a row
    o = np.zeros((b, h, s, d))
    for j in range(n_tiles):
        t = slice(BT * j, BT * j + BT)
        sc = _score(q, k[:, :, t], three=three)
        sc[..., np.arange(BT * j, BT * j + BT) >= s] = -np.inf
        m = np.maximum(m, sc.max(-1))
        ms_old, ms = ms, _f32(m * np.float64(c))
        alpha = np.exp2(_f32(ms_old - ms))
        p = _exp2_rows(sc, ms[..., None], c)
        # thread quad holds columns 8 n + 2 quad + e, summed n, then e, ascending
        p4 = p.reshape(b, h, s, 4, 4, 2)
        tile_sum = np.zeros((b, h, s, 4))
        for n in range(4):
            for e in range(2):
                tile_sum = _f32(tile_sum + p4[..., n, :, e])
        part = _f32(part * alpha[..., None] + tile_sum)
        if running_o:
            o = _rows(_f32(o * alpha[..., None]), p, v[:, :, t], fresh=False, three=three)
        else:
            o = _f32(o * alpha[..., None] + _rows(0.0, p, v[:, :, t], three=three))
    total = _f32(_f32(part[..., 0] + part[..., 1]) + _f32(part[..., 2] + part[..., 3]))
    out = _f32(o * _f32(1.0 / total)[..., None])
    lse = _f32(_f32(ms + _f32(np.log2(total))) * np.float64(np.float32(np.log(2))))
    return out.transpose(0, 2, 1, 3), lse


def _case(s: int, seed: int):
    """f32 q, k, v, dO ~ N(0, 1) at (2, s, 3, 64), out and lse from the f32
    plain forward (the kernel's inputs come from the f32 forward kernel)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, s, 3, 64)).astype(np.float32))
                   for _ in range(4))
    out = attention.attention_plain(q, k, v, SM, torch.float32)
    lse = attention.attention_lse_plain(q, k, SM)
    return q, k, v, out, lse, do


def _errors(got, ref) -> list[float]:
    """Each tensor's max |got - ref| over FLASH_F32_BWD_REL max(1, max|ref|):
    at most 1 meets the bar."""
    return [float(np.abs(g - r).max()) / (FLASH_F32_BWD_REL * max(1.0, float(np.abs(r).max())))
            for g, r in zip(got, ref)]


# one row; one short of, at and one past a streamed tile of 32, a
# consumer's 64 resident rows and a work item of 128; HuBERT's 199 (6 tiles
# of 32 and 7 rows)
EDGE_S = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 199)


@pytest.mark.parametrize("s", EDGE_S)
def test_3xtf32_emulation_meets_the_f32_bar_against_float64(s):
    ins = _case(s, seed=100 + s)
    got = emulate_bwd(*(x.numpy() for x in ins), SM)
    ref64 = attention.attention_bwd_plain(*(x.double() for x in ins), SM)
    ref32 = attention.attention_bwd_plain(*ins, SM)
    for name, e64, e32 in zip(("dq", "dk", "dv"), _errors(got, [r.numpy() for r in ref64]),
                              _errors(got, [r.numpy() for r in ref32])):
        assert e64 <= 1.0, f"{name}: {e64:.3f} of the bar against float64"
        assert e32 <= 1.0, f"{name}: {e32:.3f} of the bar against the f32 plain version"


@pytest.mark.parametrize("s", [64, 199])
def test_fresh_tile_accumulators_beat_one_running_tensor_core_sum(s):
    """The emulated kernel against the same arithmetic with every sum on the
    tensor cores, truncating all the way (one accumulator per score product
    and one per gradient across all tiles): the kernel's IEEE adds take out
    most of the truncation's bias, by at least 2x in the worst tensor."""
    ins = _case(s, seed=200 + s)
    ref64 = [r.numpy() for r in attention.attention_bwd_plain(*(x.double() for x in ins), SM)]
    kernel = _errors(emulate_bwd(*(x.numpy() for x in ins), SM), ref64)
    running = _errors(emulate_bwd(*(x.numpy() for x in ins), SM, fresh=False), ref64)
    print(f"S={s}: share of the bar, fresh tiles {kernel}, one running sum {running}")
    assert max(kernel) <= 1.0
    assert max(running) >= 2 * max(kernel)


def test_score_ksteps_are_a_permutation_of_the_head_dims():
    """Each k-step's 8 slots: slot q + 4 h of k-step 2 j + t is head dim 16 j +
    4 q + 2 t + h, so thread q's float4 at 16 j + 4 q holds its A fragment's
    k = q and q + 4 of k-steps 2 j and 2 j + 1."""
    flat = np.concatenate(SCORE_KSTEPS)
    assert sorted(flat.tolist()) == list(range(64))
    for j in range(4):
        for q in range(4):
            f4 = [16 * j + 4 * q + i for i in range(4)]
            assert f4 == [SCORE_KSTEPS[2 * j + t][q + 4 * h] for t in range(2) for h in range(2)]


def test_one_tf32_product_misses_the_f32_bar():
    """Why three products: the same schedule with one TF32 product each
    (the operands rounded to 10 mantissa bits) misses 5e-5 x max(1,
    max|ref|) against float64 at the training length."""
    ins = _case(199, seed=7)
    ref64 = [r.numpy() for r in attention.attention_bwd_plain(*(x.double() for x in ins), SM)]
    one = _errors(emulate_bwd(*(x.numpy() for x in ins), SM, three=False), ref64)
    print(f"S=199: share of the bar, one TF32 product {one}")
    assert max(one) > 1.0


def _fwd_case(s: int, seed: int):
    """f32 q, k, v ~ N(0, 1): (2, s, 3, 64), or (1, 1500, 2, 64) at the
    serving length, where numpy takes seconds."""
    shape = (1, s, 2, 64) if s == 1500 else (2, s, 3, 64)
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(3)]


def _fwd_errors(ins, **kwargs) -> tuple[float, float, float, float]:
    """The emulated forward's max |error| against the float64 and the f32
    plain output, then its LSE's against the float64 and the f32 plain LSE."""
    out, lse = emulate_fwd(*(x.numpy() for x in ins), SM, **kwargs)
    q64, k64, v64 = (x.double() for x in ins)
    refs = (attention.attention_plain(q64, k64, v64, SM, torch.float64),
            attention.attention_plain(*ins, SM, torch.float32),
            attention.attention_lse_plain(q64, k64, SM),
            attention.attention_lse_plain(*ins[:2], SM))
    return tuple(float(np.abs(got - ref.numpy()).max())
                 for got, ref in zip((out, out, lse, lse), refs))


# the forward's tiling: one row; one short of, at and one past a key tile of
# 32, a consumer's 64 query rows and a work item of 128 (chip_smoke's
# FLASH_F32_EDGE_S); HuBERT's 199 and Whisper's 1500
FWD_S = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 199, 1500)


@pytest.mark.parametrize("s", FWD_S)
def test_forward_emulation_meets_the_f32_bar_against_float64(s):
    """The emulated forward within FLASH_F32_ATOL of float64 and of the f32
    plain version, its LSE within LSE_F32_ATOL of both."""
    e64, e32, l64, l32 = _fwd_errors(_fwd_case(s, seed=400 + s))
    print(f"S={s}: out {e64:.3e} from float64, {e32:.3e} from f32; lse {l64:.3e}, {l32:.3e}")
    assert max(e64, e32) <= FLASH_F32_ATOL
    assert max(l64, l32) <= LSE_F32_ATOL


def test_forward_one_tf32_product_misses_the_f32_bar():
    """Why three products in the forward too: one TF32 product each (the
    scores and P V) misses 2e-5 against float64 at the training length."""
    e64, _, l64, _ = _fwd_errors(_fwd_case(199, seed=8), three=False)
    print(f"S=199, one TF32 product: out {e64:.3e}, lse {l64:.3e} from float64")
    assert e64 > FLASH_F32_ATOL


@pytest.mark.parametrize("s", [199, 1500])
def test_forward_fresh_o_tiles_beat_one_running_tensor_core_sum(s):
    """O in one tensor-core accumulator across the key tiles (scaled by
    alpha, then P V summed into it, truncating at every k-step) lands at
    least twice as far from float64 as the kernel's fresh accumulator per
    tile, added to O in IEEE f32."""
    ins = _fwd_case(s, seed=500 + s)
    kernel = _fwd_errors(ins)[0]
    running = _fwd_errors(ins, running_o=True)[0]
    print(f"S={s}: out from float64, fresh O tiles {kernel:.3e}, one running sum {running:.3e}")
    assert kernel <= FLASH_F32_ATOL
    assert running >= 2 * kernel


def test_f32_bounds_cuda_cores_and_3xtf32():
    """chip_smoke.py's two bounds for the f32 rows (bound_ms the 3xTF32 one):
    the f32 backward at the training shape (five products, eight tensors)
    0.1453 ms at the f32 CUDA-core peak and 0.0590 ms as 3xTF32 at the TF32
    peak, both above the bytes' 0.0235 ms; the forward (two products, four
    tensors) 4.4017 and 1.7873 ms at the serving shape, 0.0581 and 0.0236 ms
    at the training one."""
    import chip_smoke

    bwd = chip_smoke.f32_attention_bounds(32, 199, 12, 64, products=5, tensors=8)
    assert bwd["bound_by"] == bwd["bound_3xtf32_by"] == "operations"
    assert bwd["bound_ms"] == pytest.approx(0.14525, abs=1e-4)
    assert bwd["bound_3xtf32_ms"] == pytest.approx(0.05898, abs=1e-4)
    serve = chip_smoke.f32_attention_bounds(64, 1500, 8, 64, products=2, tensors=4)
    assert serve["bound_ms"] == pytest.approx(4.4017, abs=1e-4)
    assert serve["bound_3xtf32_ms"] == pytest.approx(1.7873, abs=1e-4)
    train = chip_smoke.f32_attention_bounds(32, 199, 12, 64, products=2, tensors=4)
    assert train["bound_ms"] == pytest.approx(0.0581, abs=1e-4)
    assert train["bound_3xtf32_ms"] == pytest.approx(0.0236, abs=1e-4)
    # the kernels' rows: bound_ms is the 3xTF32 bound, the products' form on the card
    row = chip_smoke.row_bounds(serve)
    assert row == {"bound_ms": serve["bound_3xtf32_ms"], "bound_by": "operations",
                   "bound_cuda_cores_ms": serve["bound_ms"]}


@pytest.mark.parametrize("kernel,name", [(k, n) for k in flash_f32_ablations.KERNELS
                                         for n in flash_f32_ablations.entries(k)])
def test_ablation_patches_find_their_text(kernel, name):
    """Every variant and ablation of flash_f32_ablations.py finds the text it
    patches in the kernel's source and in sm90.cuh (on the card the script
    would stop at the first that does not), and changes it."""
    sources = flash_f32_ablations.read_sources(kernel)
    assert flash_f32_ablations.patched(sources, kernel, name) != sources
