"""Numpy models of the level-1 kernels K1 and K4 (csrc/l1_kernels.cu) on
the CPU, lane by lane, against the plain-torch twins and the JAX package.

K1 hash_keys_winmin_sync_kernel: a warp per tile of kK1Rows rows of 128
positions, lane l at positions 4l..4l+3 of each row, words from shuffles,
the second pair's window from the next lane's h8 (lane 31: the next row's
lane 0, the halo row after the tile), the samples by a segmented xor
shuffle, the plane by B6's block scans, and above stride 128 the
stride-128 samples or plane reduced by a second kernel. K4
compact_slots_sync_kernel: kSyncSlots slots a thread, a sample slot a
thread's first, and _ldm_est of each sample (common.cuh ldm_estimate) on
crafted LDM rows. All values are integers: the tolerance is 0.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu_torch.ops import _build
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk

torch.set_num_threads(2)  # six test workers share a few cores

M32 = 0xFFFFFFFF
F = 0x80000000
LANES = np.arange(32)
C1, C2, C3 = 2654435761, 2246822519, 3266489917
U = np.uint64


def _constant(name: str, source: str = "l1_kernels.cu") -> int:
    with open(os.path.join(_build.CSRC, source)) as f:
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             f.read()).group(1))


K1_ROWS = _constant("kK1Rows")
K1_WARPS = _constant("kK1Warps")
ROW_SPAN = _constant("kRowSpan", "common.cuh")
SYNC_SLOTS = _constant("kSyncSlots")
LDM_REACH = _constant("kLdmReach", "common.cuh")


# --- warp primitives on (..., 32) arrays of u32 values in uint64 -----------

def _shfl(v, src):
    return v[..., src]


def _shfl_up(v, d: int, width: int):
    return v[..., np.where(LANES % width >= d, LANES - d, LANES)]


def _shfl_down(v, d: int, width: int):
    return v[..., np.where(LANES % width + d < width, LANES + d, LANES)]


def _be_at(lo, hi, k: int):
    """__byte_perm(lo, hi, 0x0123 + 0x1111 k)."""
    sel = 0x0123 + 0x1111 * k
    out = np.zeros_like(lo)
    for j in range(4):
        s = (sel >> (4 * j)) & 7
        byte = ((lo if s < 4 else hi) >> U(8 * (s & 3))) & U(0xFF)
        out |= byte << U(8 * j)
    return out


def _hash_words(a, b, width: int):
    def mul(x, c):
        return (x * U(c)) & U(M32)
    h = mul(a, C1)
    if width == 4:
        return h
    if width == 5:
        return h ^ ((mul(b >> U(24), C2) << U(11)) & U(M32))
    if width == 6:
        return h ^ mul(b >> U(16), C2)
    return h ^ mul(mul(b, C2), C3)


def _block_scans(h, L: int):
    pre = np.minimum.accumulate(h, axis=0)
    suf = np.minimum.accumulate(h[::-1], axis=0)[::-1]
    ip, is_ = pre[3], suf[0]
    d = 1
    while d < L:
        ip = np.minimum(ip, _shfl_up(ip, d, L))
        is_ = np.minimum(is_, _shfl_down(is_, d, L))
        d *= 2
    ep = np.where(LANES % L == 0, U(M32), _shfl_up(ip, 1, L))
    es = np.where(LANES % L == L - 1, U(M32), _shfl_down(is_, 1, L))
    return np.minimum(pre, ep), np.minimum(suf, es)


def _window_min(h, pre, suf, hn, pn, stride: int):
    if stride >= 4:
        L = stride // 4
        up = (LANES + L) & 31
        q = [_shfl(np.where(LANES >= L, pre[k], pn[k]), up) for k in range(3)]
        q3 = _shfl(np.where(LANES >= L - 1, pre[3], pn[3]),
                   (LANES + L - 1) & 31)
        return np.stack([np.minimum(suf[0], q3)] +
                        [np.minimum(suf[k], q[k - 1]) for k in (1, 2, 3)])
    if stride == 2:
        h4 = _shfl(np.where(LANES >= 1, h[0], hn[0]), (LANES + 1) & 31)
        return np.minimum(h, np.concatenate([h[1:], h4[None]]))
    return h


# --- K1 ----------------------------------------------------------------------

def _k1_model(x, width, stride, flip, samples, window=32768, rows=K1_ROWS,
              warps=K1_WARPS):
    """hash_keys_winmin_sync_kernel<!samples, n % 4 == 0> and, above
    stride 128, sync_samples_kernel or winmin_stretch_kernel, lane by lane
    (all warps of all rows at once): (B, n) uint8 -> the u32 keys (B,
    n/2), the samples or the plane (uint64, None at stride 0), and how
    often each word of each was written."""
    B, n = x.shape
    w = min(window, n)
    pbits, pmask = (w - 1).bit_length(), w - 1
    plane = not samples and stride > 0
    wide = stride > ROW_SPAN
    S = ROW_SPAN if wide else stride
    span = rows * ROW_SPAN
    tiles = -(-n // (span * warps)) * warps  # the grid's warps
    t0 = np.arange(tiles) * span
    t0 = t0[t0 < n]  # the others return at once
    nw = -(-n // 4)  # words holding a byte of the row; 0 past n
    xp = np.zeros((B, 4 * nw + 4), np.uint8)
    xp[:, :n] = x
    words = xp.view("<u4").astype(U)
    q = t0[:, None, None] // 4 + 32 * np.arange(rows + 2)[:, None] + LANES
    wv = np.moveaxis(np.where(q < nw, words[:, np.minimum(q, nw)], U(0)),
                     2, 0)  # (row of words, B, tile, lane)
    keys = np.zeros((B, n // 2), U)
    kc = np.zeros((B, n // 2), np.int64)
    ns = n if plane else (-(-n // S) if S else 0)
    out = np.zeros((B, ns), U)
    oc = np.zeros((B, ns), np.int64)
    bidx = np.arange(B)[:, None, None]

    def store(arr, cnt, idx, vals, live):
        idx, live = (np.broadcast_to(a, vals.shape) for a in (idx, live))
        b = np.broadcast_to(bidx, vals.shape)
        arr[b[live], idx[live]] = vals[live]
        np.add.at(cnt, (b[live], idx[live]), 1)

    def row(r):
        own, nxt = wv[r], wv[r + 1]
        b = _shfl(np.where(LANES >= 1, own, nxt), (LANES + 1) & 31)
        c = _shfl(np.where(LANES >= 2, own, nxt), (LANES + 2) & 31)
        lo = [_be_at(own, b, k) for k in range(4)]
        hi = [_be_at(b, c, k) for k in range(4)]
        i = t0[:, None] + r * ROW_SPAN + 4 * LANES  # (tile, lane)
        h8 = np.stack([np.where(i + k < n, _hash_words(lo[k], hi[k], 8),
                                U(M32)) for k in range(4)])
        hw = np.stack([_hash_words(lo[k], hi[k], width) >> U(pbits)
                       << U(pbits) for k in range(4)])
        return h8, hw, i

    h8, hw, _ = row(0)
    L = max(S // 4, 1)
    pre, suf = _block_scans(h8, L) if plane and S >= 4 else (h8, h8)
    for r in range(rows):
        hn, hwn, _ = row(r + 1)  # the last: the halo row
        i = t0[:, None] + r * ROW_SPAN + 4 * LANES
        iu = i.astype(U)
        h4 = _shfl(np.where(LANES >= 1, h8[0], hn[0]), (LANES + 1) & 31)
        h5 = _shfl(np.where(LANES >= 1, h8[1], hn[1]), (LANES + 1) & 31)
        # pair_keys: odd where the odd members' minimum, low bit set, lies
        # below the even members', low bit cleared.
        p0 = ((np.minimum(h8[1], h8[3]) | U(1))
              < (np.minimum(h8[0], h8[2]) & U(M32 - 1))).astype(U)
        p1 = ((np.minimum(h8[3], h5) | U(1))
              < (np.minimum(h8[2], h4) & U(M32 - 1))).astype(U)
        k0 = np.where(p0 == 1, hw[1], hw[0]) | ((iu + p0) & U(pmask))
        k1 = np.where(p1 == 1, hw[3], hw[2]) | ((iu + U(2) + p1)
                                                  & U(pmask))
        store(keys, kc, i >> 1, k0 ^ U(flip), i < n)
        store(keys, kc, (i >> 1) + 1, k1 ^ U(flip), i + 2 < n)
        if plane:
            pn, sn = _block_scans(hn, L) if S >= 4 else (hn, hn)
            m = _window_min(h8, pre, suf, hn, pn, S)
            for k in range(4):
                store(out, oc, i + k, m[k], i + k < n)
            pre, suf = pn, sn
        elif S >= 4:
            m = np.minimum(np.minimum(h8[0], h8[1]), np.minimum(h8[2], h8[3]))
            d = 1
            while d < L:  # the segmented xor shuffle
                m = np.minimum(m, _shfl(m, LANES ^ d))
                d *= 2
            store(out, oc, i // S, m, (LANES % L == 0) & (i < n))
        elif S == 2:
            store(out, oc, i >> 1, np.minimum(h8[0], h8[1]), i < n)
            store(out, oc, (i >> 1) + 1, np.minimum(h8[2], h8[3]), i + 2 < n)
        elif S == 1:
            for k in range(4):
                store(out, oc, i + k, h8[k], i + k < n)
        h8, hw = hn, hwn
    if not wide:
        return keys, kc, (out if stride else None), oc
    assert (oc == 1).all()  # each scratch word written once
    reps = stride // ROW_SPAN
    if samples:  # sync_samples_kernel: a thread a sample
        m128 = out
        ns = -(-n // stride)
        out = np.full((B, ns), U(M32))
        for j in range(ns):
            out[:, j] = m128[:, j * reps:(j + 1) * reps].min(axis=1)
        return keys, kc, out, np.ones_like(out, np.int64)
    m128, out = out, np.full_like(out, U(M32))
    for r in range(reps):  # winmin_stretch_kernel
        sh = np.full_like(m128, U(M32))
        if r * ROW_SPAN < n:
            sh[:, :n - r * ROW_SPAN] = m128[:, r * ROW_SPAN:]
        out = np.minimum(out, sh)
    return keys, kc, out, oc


def _k1_blocks(B: int, n: int, seed: int) -> np.ndarray:
    """Bytes whose minima and argmin parities move: random and
    low-alphabet spans, a run, copies of earlier spans."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (B, n), np.uint8)
    x[:, n // 3:2 * n // 3] = rng.integers(0, 3, (B, 2 * n // 3 - n // 3))
    if n >= 64:
        x[0, 10:40] = 0x41
        x[B - 1, n // 2:] = x[0, :n - n // 2]
    return x


K1_SHAPES = {131072: 2, 4100: 3, 4098: 2, 6: 2}  # n: rows
K1_STRIDES = [0, 1, 2, 4, 8, 32, 128, 256, 4096]
K1_CASES = [(stride, n, samples) for stride in K1_STRIDES
            for n in sorted(K1_SHAPES) for samples in (True, False)
            if stride or samples]  # stride 0: no second output


@pytest.mark.parametrize("stride,n,samples", K1_CASES)
def test_k1_model_equals_twin(stride, n, samples):
    """The model writes every key and every sample (or plane word) once
    and equals the twin, at the kernel's tiles and at 1-row tiles in
    1-warp CTAs (a tile edge and its halo row every 128 positions): the
    pair keys with their neighbours' h8 shuffled in, the samples by
    segmented shuffle, rows that end inside a tile (4100), n % 4 == 2
    (4098, 6)."""
    x = _k1_blocks(K1_SHAPES[n], n, stride + n)
    width = (4, 5, 6, 8)[(stride + n) % 4]
    flip = F if (stride // 2 + n) % 2 else 0
    tk_keys, tk_out = tk.hash_keys_winmin_sync_twin(
        torch.from_numpy(x), width, 32768, stride, flip, samples)
    for rows, warps in ((K1_ROWS, K1_WARPS), (1, 1)):
        keys, kc, out, oc = _k1_model(x, width, stride, flip, samples,
                                      rows=rows, warps=warps)
        assert (kc == 1).all()
        np.testing.assert_array_equal(
            keys.reshape(-1), tk_keys.numpy().view(np.uint32).reshape(-1))
        if stride:
            assert (oc == 1).all()
            np.testing.assert_array_equal(out,
                                          tk_out.numpy().view(np.uint32))
        else:
            assert out is None and tk_out is None


@pytest.mark.parametrize("stride,n", [(32, 131072), (4096, 131072),
                                      (64, 4100), (32, 8192)])
def test_k1_model_equals_reference(stride, n):
    """At the kernel's tiles the model's keys are the reference's (XORed
    with the flip word) and its samples the reference's plane[:, ::stride]
    (interpret mode)."""
    x = _k1_blocks(2, n, stride)
    key_ref, minz_ref = (np.asarray(a) for a in gk.hash_keys_winmin_sync(
        jnp.asarray(x), 6, 32768, stride, interpret=True))
    keys, _, out, _ = _k1_model(x, 6, stride, F, True)
    np.testing.assert_array_equal(keys.reshape(key_ref.shape),
                                  key_ref ^ np.uint32(F))
    np.testing.assert_array_equal(out, minz_ref[:, ::stride])


# --- K4 ----------------------------------------------------------------------

def _k4_model(su, lengths, su_ldm, sb, width, max_off, flip,
              slots=SYNC_SLOTS):
    """compact_slots_sync_kernel over all threads at once: (B*nseg, w/2)
    u32 pair words and (nspans, sps) LDM words (or None) -> (B*nseg, w/4)
    u32 slot words, and how often each sample's estimate was taken."""
    B = lengths.shape[0]
    R, w2 = su.shape
    w = 2 * w2
    ns = (R // B) * w // 4
    pbits = (w - 1).bit_length()
    offbits = 32 - pbits
    pw = (su.astype(U) ^ U(flip)).reshape(B, 2 * ns)
    s = np.arange(ns)
    segbase = (s >> (pbits - 2)) << pbits
    blen = lengths.astype(np.int64)[:, None]
    best = np.full((B, ns), U(M32))
    for e in (pw[:, 0::2], pw[:, 1::2]):
        posf, off = e >> U(offbits), e & U((1 << offbits) - 1)
        ok = (off > 0) & (segbase + posf.astype(np.int64) + width <= blen)
        best = np.minimum(best, np.where(ok, ((posf & U(3)) << U(30)) | off,
                                         U(M32)))
    taken = None
    if su_ldm is not None:
        nspans, sps = su_ldm.shape
        half = sps // 2
        spb = half // sb
        stride = 4 * ns // spb
        sls = ns // spb
        assert sls >= slots and sls & (sls - 1) == 0  # the launcher's rule
        offmask = (1 << (32 - (sps - 1).bit_length())) - 1
        s0 = np.arange(0, ns, slots)  # the threads' first slots
        first = s0[(s0 & (sls - 1)) == 0]  # those that hold a sample
        q = first >> (sls.bit_length() - 1)
        taken = np.zeros((B, spb), np.int64)
        for b in range(B):  # ldm_offsets, ldm_estimate, take_ldm
            span = b // sb
            p = (b - span * sb) * spb + q
            offs = np.zeros((len(q), LDM_REACH), np.int64)
            for k in range(LDM_REACH):
                inside = p + k < half
                col = half + np.minimum(p + k, half - 1)
                offs[:, k] = np.where(inside, (su_ldm[span, col].astype(U)
                                               ^ U(flip)) & U(offmask), 0)
            o = offs[:, 0]
            agree = o > 0
            reach = agree.astype(np.int64)
            for k in range(1, LDM_REACH):
                agree = agree & (np.abs(offs[:, k] - o) <= 1) & \
                    (offs[:, k] > 0)
                reach += agree
            ldo = (o.astype(U) * U(stride) & U(M32)).astype(np.uint32) \
                .view(np.int32).astype(np.int64)
            valid = (reach >= 2) & (o >= 2) & (ldo <= max_off) & \
                (q * stride + 40 <= lengths[b])
            est = np.where(valid, reach * stride, 0)
            v = best[b, first]
            ml0 = np.where(v != U(M32), width, 0)
            best[b, first] = np.where(est > ml0, ldo.astype(np.uint32)
                                      .astype(U), v)
            np.add.at(taken[b], q, 1)
    return best.reshape(R, w // 4), taken


N_LDM, SB, WINDOW = 8192, 4, 32768
STRIDE = tk.ldm_stride(SB, N_LDM)  # 32
SPB = N_LDM // STRIDE  # 256
HALF = SB * SPB


def _crafted_ldm(seed: int = 0):
    """(su (B, N/2), lengths, su_ldm (2, 2 half)) as u32, B = 8: two spans
    of four blocks of 8192 positions. Span row 0 holds, among sparse
    random offsets: a chain of 8 equal offsets (reach capped at 6), a
    chain of 6 across the block 0 / 1 edge with +-1 jitter, a jitter of
    2 that breaks a chain, a chain of 4 that meets the row's end, chains
    at offs * stride == max_off and one past, and a chain of offsets 1.
    Span row 1: dense random offsets, and chains at q * stride + 40 ==
    the length (block 6) and one past it (block 7)."""
    rng = np.random.default_rng(seed)
    B = 2 * SB
    offs = np.where(rng.random((2, HALF)) < 0.3, rng.integers(1, 7, (2, HALF)),
                    0)
    offs[1] = rng.integers(0, 4, HALF)
    r0 = offs[0]
    r0[10:18] = 100
    r0[SPB - 3:SPB + 3] = [200, 201, 199, 200, 200, 201]
    r0[300:306] = [50, 51, 52, 50, 0, 0]
    r0[HALF - 4:] = 77
    r0[400:403] = (1 << 19) // STRIDE
    r0[410:413] = (1 << 19) // STRIDE + 1
    r0[600:603] = 1
    offs[1, 2 * SPB + 100:2 * SPB + 103] = 300
    offs[1, 3 * SPB + 100:3 * SPB + 103] = 300
    sps = 2 * HALF
    offbits = 32 - (sps - 1).bit_length()
    ctx = rng.integers(0, 1 << offbits, (2, HALF))
    cols = np.arange(sps, dtype=np.uint64) << U(offbits)
    su_ldm = (cols | np.concatenate([ctx, offs], axis=1).astype(U)) \
        .astype(np.uint32)
    lengths = np.array([N_LDM, N_LDM, 5000, N_LDM, N_LDM, 7000,
                        100 * STRIDE + 40, 100 * STRIDE + 39], np.int32)
    pbits = (min(WINDOW, N_LDM) - 1).bit_length()
    pos = rng.integers(0, N_LDM, (B, N_LDM // 2)).astype(U)
    off = np.where(rng.random((B, N_LDM // 2)) < 0.5,
                   rng.integers(1, 1 << 19, (B, N_LDM // 2)), 0).astype(U)
    su = ((pos << U(32 - pbits)) | off).astype(np.uint32)
    return su, lengths, su_ldm


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_crafted_ldm_rows_hold_their_cases():
    """The torch _ldm_est on the crafted rows: reach capped at 6, the
    chain across the block edge, the broken jitter, the row's end, the
    max_off edge, offsets 1, and the length edge."""
    _, lengths, su_ldm = _crafted_ldm()
    est, off = tk._ldm_est(_i32(su_ldm), torch.from_numpy(lengths), N_LDM,
                           SB, 1 << 19)
    est = est.numpy()
    assert est[0, 10] == est[0, 12] == 6 * STRIDE  # capped at 6
    assert est[0, 13] == 5 * STRIDE
    assert est[0, SPB - 3] == 6 * STRIDE  # block 0 into block 1
    assert est[1, 300 - SPB] == 2 * STRIDE  # 52 breaks the chain
    assert est[3, SPB - 4] == 4 * STRIDE and est[3, SPB - 2] == 2 * STRIDE
    assert est[3, SPB - 1] == 0  # alone at the row's end
    assert est[1, 400 - SPB] > 0 and off.numpy()[1, 400 - SPB] == 1 << 19
    assert est[1, 410 - SPB] == 0  # one past max_off
    assert est[2, 600 - 2 * SPB] == 0  # offsets 1
    assert est[6, 100] > 0 and est[7, 100] == 0  # the length edge


@pytest.mark.parametrize("flip", [0, F], ids=["flip0", "flip"])
@pytest.mark.parametrize("case", ["crafted LDM rows", "no LDM",
                                  "ragged rows of 4100"])
def test_k4_model_equals_twin(case, flip):
    """The model (the estimate in the kernel, each sample's once) equals
    the twin (the torch _ldm_est and the slot words) in both flip modes:
    the words come in XORed with the flip word."""
    su, lengths, su_ldm = _crafted_ldm()
    span = SB
    if case != "crafted LDM rows":
        su_ldm, span = None, 0
    if case == "ragged rows of 4100":  # 1025 slots: the guarded path
        su = su[:, :2050].copy()
        lengths = np.minimum(lengths, 4100)
    x = np.uint32(flip)
    got, taken = _k4_model(su ^ x, lengths, None if su_ldm is None
                           else su_ldm ^ x, SB, 6, 1 << 19, flip)
    if taken is not None:
        assert (taken == 1).all()
    want = tk.compact_slots_sync_twin(
        _i32(su ^ x), WINDOW, torch.from_numpy(lengths), 6,
        None if su_ldm is None else _i32(su_ldm ^ x), span, flip=flip)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))
    if flip:  # the same words as flip 0 on the plain ones
        np.testing.assert_array_equal(got, _k4_model(
            su, lengths, su_ldm, SB, 6, 1 << 19, 0)[0])


@pytest.mark.parametrize("max_off", [1 << 19, (1 << 19) - 1])
def test_k4_model_equals_reference(max_off):
    """On the crafted rows the model gives the reference's
    compact_slots_sync(su_ldm=...) words (interpret mode); one below the
    max_off edge the chain at it no longer claims."""
    su, lengths, su_ldm = _crafted_ldm()
    want = np.asarray(gk.compact_slots_sync(
        jnp.asarray(su), WINDOW, jnp.asarray(lengths), width=6,
        su_ldm=jnp.asarray(su_ldm), span_blocks=SB, local_cap=24,
        max_off=max_off, interpret=True))
    got, _ = _k4_model(su, lengths, su_ldm, SB, 6, max_off, 0)
    np.testing.assert_array_equal(got, want)


def test_k4_sample_spacing_is_a_shift():
    """ldm_stride is 32 * 2^k, so a sample every stride / 4 slots is a
    power of two no smaller than the kernel's slots a thread: the
    launcher's rule, which every level's shape meets."""
    for span in (4, 8, 16):
        for n in (4096, 32768, 131072, 1 << 20):
            sls = tk.ldm_stride(span, n) // 4
            assert sls >= SYNC_SLOTS and sls & (sls - 1) == 0


def test_l1_sync_designs_script_needs_a_card(monkeypatch):
    """designs/l1_sync.py times K1, K3 and K4 beside a parent tree on a
    card; without one it stops before it builds anything. Its designs
    replace l1_kernels.cu's constants."""
    from qat_zstd_plugin_tpu_torch.designs import l1_sync
    for name, (_, consts) in l1_sync.DESIGNS.items():
        src = l1_sync._sources(_build.CSRC, l1_sync.DESIGNS[name])
        for const, value in consts.items():
            assert re.search(rf"constexpr \w+ {const} = {value};",
                             src["l1_kernels.cu"]), name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        l1_sync.main([])
