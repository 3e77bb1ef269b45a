"""The hash-matcher device paths in PyTorch: the CUDA kernels of
qat_zstd_plugin_tpu.ops.glue_kernels and the torch ops between them.

Port of qat_zstd_plugin_tpu.ops.glue_kernels `find_matches_positions`
(every branch) and what it reaches. Level 1, sync=True (the
syncmer pair anchors, csrc/l1_kernels.cu):

  hash_keys_winmin_sync -> sort -> neighbor_unsort_keys -> sort --+
    +- LDM samples -> ldm_keys -> sort -> neighbor_unsort_keys     |
         -> sort ---------------------------------------------------+
                                                                   v
    compact_slots_sync (the LDM estimates inside) -> (B*nseg, w/4) slot words

with the sign bit flipped on every word from K1 to K4, so that the row
sorts are signed ones with no torch pass between the kernels.

Levels 2-4, sync=False (full-resolution keys, csrc/dense_kernels.cu):

  width 0: hash_keys_winmin -> sort -> neighbor_unsort_keys -> sort --+
  width i: hash_keys        -> sort -> neighbor_unsort_keys -> sort --+
  minz plane -> ldm_keys -> ... -> _ldm_est (as above)                 v
     finalize_candidates -> (mlen, moff) -> compact_slots_dense -> slot words

Without LDM (a batch that is no whole number of spans) every width takes
hash_keys and compact_slots_dense gets no estimates.

The parsed branch, dense=False (no shipped level takes it;
csrc/parsed_kernels.cu):

  candidates_hash_split -> (mlen, moff) -> [ldm_winmin -> ldm_unsorted ->
    merge_ldm] -> parse_greedy (B10, psegs segments a block) ->
    compact_slots (B17) -> slot words

and the packed hash contract (find_matches_hash_split; the reference's
candidates_hash, compact_fast and find_matches_fused(matcher="hash") in
ops/match_pipeline.py are these same computations):

  candidates_hash_split -> parse_greedy (B10) -> compact_operands (B18)
    -> two row sorts -> [the segment merge -> two row sorts] -> the
    sequence fields (compact_fast_glue) -> pack_outputs

B19 bitonic_sort is in ops/sort_kernel.py (csrc/sort_kernels.cu).

Levels 5-12 (the content path, ops/match_pipeline.find_matches_packed)
take their LDM claims from here: ldm_winmin (csrc/content_kernels.cu) ->
ldm_unsorted -> merge_ldm folds them into the exact-LCP candidates.

Levels 1-4 with hybrid device entropy take the byte-verified matcher
(candidates_hash_verified, csrc/verified_kernels.cu):

  gram_pos_planes -> (gram, pos) sort -> neighbor_verify_keys -> sort
    -> finalize_verified -> (mlen, moff), every claim a true match

Each kernel has here (parse_greedy in ops/parse_kernel.py, the FSE
state machine in ops/fse_kernel.py, literal_keys and byte_hist in
ops/literals_kernel.py and bitonic_sort in ops/sort_kernel.py, which count
their launches in `launches` below as well)
  * a wrapper with the reference's name, which checks device, dtype,
    shape and contiguity and launches the kernel of csrc/ on PyTorch's
    current stream (counting the launch in `launches`);
  * a plain-torch twin (`<name>_twin`) that computes the same words. The
    wrapper calls the twin only for a tensor on the CPU; for any other
    device it launches the kernel or raises.

Sort keys and slot words are u32 bit patterns held in int32 tensors. The
twins carry them in int64 and mask with 0xFFFFFFFF after every shift and
multiply: torch has no uint32 shifts, compares or minimum on the CPU, and
the reference's u32 wrap-around is part of the result (an un-sort key
shifts the hash bits out of the word).
"""

from __future__ import annotations

import threading

import torch

from . import _build

_M32 = 0xFFFFFFFF
_SIGN = -0x80000000  # int32 bit 31: xor maps u32 order onto int32 order
_FLIP = 0x80000000  # the same bit as a u32 word: the flip word of K1-K4,
                    # B5 and B6
_C1 = 2654435761
_C2 = 2246822519
_C3 = 3266489917

# Kernel launches since the last reset_launches(), by kernel name. A
# wrapper counts where it launches its kernel and nowhere else, under
# _launches_lock, so that the totals of threads sharing a card are exact.
_launches_lock = threading.Lock()
launches = {"hash_keys_winmin_sync": 0, "neighbor_unsort_keys": 0,
            "ldm_keys": 0, "compact_slots_sync": 0, "hash_keys": 0,
            "hash_keys_winmin": 0, "finalize_candidates": 0,
            "compact_slots_dense": 0, "ldm_winmin": 0, "parse_greedy": 0,
            "gram_pos_planes": 0, "neighbor_verify_keys": 0,
            "finalize_verified": 0, "fse_state": 0, "literal_keys": 0,
            "byte_hist": 0, "compact_slots": 0, "compact_operands": 0,
            "bitonic_sort": 0}

MIN_MATCH = 4  # qat_zstd_plugin_tpu.ops.match_pipeline.MIN_MATCH


def reset_launches() -> None:
    with _launches_lock:
        for name in launches:
            launches[name] = 0


def segment_rule(n: int, window: int, multiple: int,
                 pow2: bool = False) -> str | None:
    """The rule the hash matchers' kernels hold a block length n to:
    segments of w = min(window, n) bytes tile the row, and w is a multiple
    of `multiple` (K1 pairs bytes: 2; B5-B8 and B11 read 4-byte words,
    K4 pairs K1's pairs: 4) and, with pow2, a power of two (the
    byte-verified matcher's positions are i & (w - 1): its kernels run at
    any width, but only there are its claims true). Returns the broken
    rule as text, or None when n tiles."""
    w = min(window, n)
    if n >= 1 and not n % w and not w % multiple \
            and not (pow2 and w & (w - 1)):
        return None
    want = f"a multiple of {multiple}" + (" and a power of two" if pow2
                                           else "")
    return (f"block length {n} must be a whole number of segments of "
            f"min(window {window}, {n}) = {w} bytes, {want}")


# ---------------------------------------------------------------------------
# u32 helpers for the twins (int64 tensors holding values in [0, 2^32))
# ---------------------------------------------------------------------------

def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or bytes) -> int64 u32 values."""
    return t.to(torch.int64) & _M32


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 bit patterns."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for u32 a and constant c, in two 16-bit halves so
    that no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _shl(a: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """Element i <- a[:, i+s] along the whole row; the last s get fill."""
    out = torch.full_like(a, fill)
    if s < a.shape[1]:
        out[:, :a.shape[1] - s] = a[:, s:]
    return out


def _shr(a: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """Element i <- a[:, i-s] along the whole row; the first s get fill."""
    out = torch.full_like(a, fill)
    if s < a.shape[1]:
        out[:, s:] = a[:, :a.shape[1] - s]
    return out


def _winmin_tail(h8: torch.Tensor, stride: int) -> torch.Tensor:
    """Entry i <- min of h8 over [i, i+stride), by doubling. An unsigned
    minimum with fill 0xFFFFFFFF: the same values as the reference's
    sign-flipped int32 minimum with fill 0x7FFFFFFF."""
    m = h8
    s = 1
    while s < stride:
        m = torch.minimum(m, _shl(m, s, _M32))
        s *= 2
    return m


def _hash_tile(x: torch.Tensor, width: int, hbits: int) -> torch.Tensor:
    """hbits-bit hash of the width-byte gram at every position of the
    (rows, N) int64 bytes; bytes past the row's end read as 0."""
    def at(shift: int) -> torch.Tensor:
        return x if shift == 0 else _shl(x, shift, 0)

    def word(shift: int) -> torch.Tensor:
        return ((at(shift) << 24) | (at(shift + 1) << 16)
                | (at(shift + 2) << 8) | at(shift + 3))

    w0 = _mul32(word(0), _C1)
    if width == 4:
        h = w0
    elif width == 5:
        h = w0 ^ ((_mul32(at(4), _C2) << 11) & _M32)
    elif width == 6:
        h = w0 ^ _mul32((at(4) << 8) | at(5), _C2)
    elif width == 8:
        h = w0 ^ _mul32(_mul32(word(4), _C2), _C3)
    else:
        raise ValueError(f"unsupported hash width {width}")
    return h >> (32 - hbits)


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _use_twin(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the twin runs); False for a CUDA tensor (the
    kernel launches); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return False


_entries: dict = {}  # the library's qz_<name> functions, by name


def _launch(name: str, *args) -> None:
    """Call entry point qz_<name> with tensors as device pointers, on the
    current stream of the first tensor's device; raise on a CUDA error.
    The entry point is looked up once; a launch then costs its tensors'
    checks, one device and one stream lookup (torch's raw getters: a
    torch.cuda.Stream object costs microseconds) and the call."""
    index = None
    values = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if index is None:
                index = a.get_device()
            elif a.get_device() != index:
                raise ValueError(f"{name}: tensors on cuda:{index} and "
                                 f"{a.device}")
            a = a.data_ptr()
            if index < 0:
                raise ValueError(f"{name}: tensors must be on a CUDA device")
            if a % 16:
                raise ValueError(f"{name}: tensors must start on a 16-byte "
                                 "boundary (the kernels load 8 and 16 bytes)")
        values.append(a)
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(_build.load(), "qz_" + name)
    if index == torch._C._cuda_getDevice():
        rc = fn(*values, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*values, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        err = _build.load().qz_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({err})")
    with _launches_lock:
        launches[name] += 1


def _sort_signed(x: torch.Tensor) -> torch.Tensor:
    """Signed row sort of int32 words (torch.sort has no unsigned int32)."""
    return torch.sort(x, dim=1).values


def _sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Unsigned row sort of int32 bit patterns (the reference's
    jax.lax.sort, which is XLA's and not a Pallas kernel). Keys are unique
    within a row (the position sits in the low bits), so any sort gives
    the reference's order."""
    return _sort_signed(x ^ _SIGN) ^ _SIGN


# ---------------------------------------------------------------------------
# K1 hash_keys_winmin_sync
# ---------------------------------------------------------------------------

def _k1_geometry(blocks: torch.Tensor, window: int):
    B, N = blocks.shape
    broken = segment_rule(N, window, 2)
    if broken:
        raise ValueError(broken)
    w = min(window, N)
    return B, N, w, (w - 1).bit_length()


def hash_keys_winmin_sync_twin(blocks: torch.Tensor, width: int,
                               window: int, stride: int, flip: int = 0,
                               samples: bool = False):
    """Plain-torch K1 (see hash_keys_winmin_sync)."""
    B, N, w, pbits = _k1_geometry(blocks, window)
    x = blocks.to(torch.int64)
    gp = torch.arange(N, device=blocks.device)
    h = _hash_tile(x, width, 32 - pbits)
    h8 = _hash_tile(x, 8, 32)
    # Argmin parity over the 4-wide window [i, i+4): the low bit carries
    # the lane parity (hash low bit cleared), so ties go to the even lane.
    v = (h8 & 0xFFFFFFFE) | (gp & 1)
    for s in (1, 2):
        v = torch.minimum(v, _shl(v, s, _M32))
    pick_next = (v & 1) == 1
    pos = gp & (w - 1)
    selh = torch.where(pick_next, _shl(h, 1, 0), h)
    selp = torch.where(pick_next, pos + 1, pos)
    key = ((selh << pbits) | selp) ^ flip
    keys = _i32(key[:, ::2].reshape(B * (N // w), w // 2))
    if not stride:
        return keys, None
    minz = _winmin_tail(h8, stride)
    return keys, _i32(minz[:, ::stride] if samples else minz)


def hash_keys_winmin_sync(blocks: torch.Tensor, width: int, window: int,
                          stride: int, flip: int = 0,
                          samples: bool = False):
    """K1. (B, N) uint8 blocks -> ((B*nseg, w/2) int32 pair-anchor keys,
    the windowed minima of the 8-gram hash: with samples=False the (B, N)
    int32 plane minz[i] = min over [i, i+stride), with samples=True only
    the (B, ceil(N/stride)) samples minz[:, ::stride] that the LDM chain
    reads (ldm_keys at stride 1), or None when stride is 0).

    Pair p of a segment holds (hash_width(sel) << pbits | sel) with sel in
    {2p, 2p+1} chosen by the parity of the argmin of the 8-gram hash over
    a 4-wide window. Port of the Pallas kernel of the same name, which
    writes the plane. `flip` (0 or _FLIP) is XORed into every key, for a
    signed row sort that follows (_unsorted's flipped=True); the minima
    are never flipped."""
    _check(blocks, "hash_keys_winmin_sync", torch.uint8, 2)
    if width not in (4, 5, 6, 8):
        raise ValueError(f"unsupported hash width {width}")
    if stride & (stride - 1) or not 0 <= stride <= 4096:
        raise ValueError(f"stride {stride} must be 0 or a power of two "
                         "<= 4096")
    if _use_twin(blocks, "hash_keys_winmin_sync"):
        return hash_keys_winmin_sync_twin(blocks, width, window, stride,
                                          flip, samples)
    B, N, w, pbits = _k1_geometry(blocks, window)
    dev = blocks.device
    keys = torch.empty((B * (N // w), w // 2), dtype=torch.int32, device=dev)
    out = scratch = None
    if stride:
        out = torch.empty((B, -(-N // stride) if samples else N),
                          dtype=torch.int32, device=dev)
        if stride > WINMIN_ROW_SPAN:  # the stride-128 samples or plane
            scratch = torch.empty(
                (B, -(-N // WINMIN_ROW_SPAN) if samples else N),
                dtype=torch.int32, device=dev)
    _launch("hash_keys_winmin_sync", blocks, keys, out, scratch, B, N, width,
            pbits, w - 1, stride, flip, int(samples))
    return keys, out


# ---------------------------------------------------------------------------
# B5 hash_keys and B6 hash_keys_winmin
# ---------------------------------------------------------------------------

def _dense_geometry(blocks: torch.Tensor, window: int):
    B, N = blocks.shape
    broken = segment_rule(N, window, 4)
    if broken:
        raise ValueError(broken)
    w = min(window, N)
    return B, N, w, (w - 1).bit_length()


def hash_keys_twin(blocks: torch.Tensor, width: int, window: int,
                   flip: int = 0) -> torch.Tensor:
    """Plain-torch B5 (see hash_keys)."""
    B, N, w, pbits = _dense_geometry(blocks, window)
    h = _hash_tile(blocks.to(torch.int64), width, 32 - pbits)
    pos = torch.arange(N, device=blocks.device) & (w - 1)
    return _i32(((h << pbits) | pos) ^ flip).reshape(B * (N // w), w)


def _check_hash_args(blocks: torch.Tensor, name: str, width: int) -> None:
    _check(blocks, name, torch.uint8, 2)
    if width not in (4, 5, 6, 8):
        raise ValueError(f"unsupported hash width {width}")


def hash_keys(blocks: torch.Tensor, width: int, window: int,
              flip: int = 0) -> torch.Tensor:
    """B5. (B, N) uint8 blocks -> (B*nseg, w) int32 sort keys, position i
    of a block holding (hash_width(i) << pbits | i & (w - 1)) at row
    i // w, column i % w of its block's segments. Port of the Pallas
    kernel of the same name. `flip` (0 or _FLIP) is XORed into every key
    written, for a signed row sort that follows (_unsorted's
    flipped=True)."""
    _check_hash_args(blocks, "hash_keys", width)
    B, N, w, pbits = _dense_geometry(blocks, window)
    if _use_twin(blocks, "hash_keys"):
        return hash_keys_twin(blocks, width, window, flip)
    keys = torch.empty((B * (N // w), w), dtype=torch.int32,
                       device=blocks.device)
    _launch("hash_keys", blocks, keys, B, N, width, pbits, w - 1, flip)
    return keys


WINMIN_ROW_SPAN = 128  # common.cuh kRowSpan: the largest stride the
                       # winmin kernels take in one launch; above it they
                       # take a second over the stride-128 plane in scratch


def _check_stride(stride: int) -> None:
    if stride < 1 or stride & (stride - 1) or stride > 4096:
        raise ValueError(f"stride {stride} must be a power of two <= 4096")


def _winmin_scratch(blocks: torch.Tensor, stride: int):
    """The stride-128 plane's (B, N) int32 scratch for a stride above
    WINMIN_ROW_SPAN, else None."""
    if stride <= WINMIN_ROW_SPAN:
        return None
    return torch.empty(blocks.shape, dtype=torch.int32, device=blocks.device)


def hash_keys_winmin_twin(blocks: torch.Tensor, width: int, window: int,
                          stride: int, flip: int = 0):
    """Plain-torch B6 (see hash_keys_winmin)."""
    keys = hash_keys_twin(blocks, width, window, flip)
    h8 = _hash_tile(blocks.to(torch.int64), 8, 32)
    return keys, _i32(_winmin_tail(h8, stride))


def hash_keys_winmin(blocks: torch.Tensor, width: int, window: int,
                     stride: int, flip: int = 0):
    """B6. hash_keys for one width plus the (B, N) int32 windowed-minimum
    plane of the 8-gram hash (minz[i] = min over [i, i+stride)), from one
    read of the bytes. Port of the Pallas kernel of the same name. `flip`
    is XORed into the keys as in hash_keys; minz is never flipped."""
    _check_hash_args(blocks, "hash_keys_winmin", width)
    _check_stride(stride)
    B, N, w, pbits = _dense_geometry(blocks, window)
    if _use_twin(blocks, "hash_keys_winmin"):
        return hash_keys_winmin_twin(blocks, width, window, stride, flip)
    keys = torch.empty((B * (N // w), w), dtype=torch.int32,
                       device=blocks.device)
    minz = torch.empty((B, N), dtype=torch.int32, device=blocks.device)
    _launch("hash_keys_winmin", blocks, keys, minz,
            _winmin_scratch(blocks, stride), B, N, width, pbits, w - 1,
            stride, flip)
    return keys, minz


# ---------------------------------------------------------------------------
# B9 ldm_winmin
# ---------------------------------------------------------------------------

def ldm_winmin_twin(blocks: torch.Tensor, stride: int) -> torch.Tensor:
    """Plain-torch B9 (see ldm_winmin)."""
    h8 = _hash_tile(blocks.to(torch.int64), 8, 32)
    return _i32(_winmin_tail(h8, stride))


def ldm_winmin(blocks: torch.Tensor, stride: int) -> torch.Tensor:
    """B9. (B, N) uint8 blocks -> (B, N) int32 windowed-minimum plane:
    entry i holds the minimum 8-gram hash over [i, i+stride) (0xFFFFFFFF
    past the row's end), the same words as hash_keys_winmin's second
    output. Port of the Pallas kernel of the same name."""
    _check(blocks, "ldm_winmin", torch.uint8, 2)
    _check_stride(stride)
    B, N = blocks.shape
    if N % 4:
        raise ValueError(f"ldm_winmin: block length {N} must be a "
                         "multiple of 4")
    if _use_twin(blocks, "ldm_winmin"):
        return ldm_winmin_twin(blocks, stride)
    minz = torch.empty((B, N), dtype=torch.int32, device=blocks.device)
    _launch("ldm_winmin", blocks, minz, _winmin_scratch(blocks, stride), B,
            N, stride)
    return minz


# ---------------------------------------------------------------------------
# The byte-verified matcher: B11 gram_pos_planes, B12 neighbor_verify_keys,
# B13 finalize_verified
# ---------------------------------------------------------------------------

VERIFIED_CHAIN_STEPS = 3  # the reference's chain_steps default, every level's


def gram_pos_planes_twin(blocks: torch.Tensor, window: int):
    """Plain-torch B11 (see gram_pos_planes)."""
    B, N, w, _ = _dense_geometry(blocks, window)
    x = blocks.to(torch.int64)
    g = (x << 24) | (_shl(x, 1, 0) << 16) | (_shl(x, 2, 0) << 8) \
        | _shl(x, 3, 0)
    pos = (torch.arange(N, device=blocks.device) & (w - 1)).expand(B, N)
    return (_i32(g).reshape(B * (N // w), w),
            pos.to(torch.int32).reshape(B * (N // w), w))


def gram_pos_planes(blocks: torch.Tensor, window: int):
    """B11. (B, N) uint8 blocks -> ((B*nseg, w) int32 big-endian 4-byte
    grams, (B*nseg, w) int32 positions i & (w - 1)), position i of a block
    at row i // w, column i % w of its segments. A gram reads along the
    whole block row, zero past its end (the last three grams of a segment
    read the next segment's bytes). i & (w - 1) is the column only for a
    power-of-two w: at other widths the matcher claims false matches, as
    the reference's does, so the codec refuses such blocks where it runs
    (runtime/gpu_codec.check_block_size). Port of the Pallas kernel of
    the same name."""
    _check(blocks, "gram_pos_planes", torch.uint8, 2)
    B, N, w, _ = _dense_geometry(blocks, window)
    if _use_twin(blocks, "gram_pos_planes"):
        return gram_pos_planes_twin(blocks, window)
    g = torch.empty((B * (N // w), w), dtype=torch.int32,
                    device=blocks.device)
    p = torch.empty_like(g)
    _launch("gram_pos_planes", blocks, g, p, B, N, w - 1)
    return g, p


def _sort_rows2(g: torch.Tensor, pos: torch.Tensor, pbits: int):
    """Lexicographic (unsigned gram, position) row sort (the reference's
    two-key jax.lax.sort): one int64 key (gram << pbits | pos), unique per
    row, so any sort gives the reference's order. The gram is unsigned
    here, where the content path's sorts the signed one."""
    key = torch.sort((_u32(g) << pbits) | pos.to(torch.int64), dim=1).values
    return _i32(key >> pbits), (key & ((1 << pbits) - 1)).to(torch.int32)


def _b12_params(sg: torch.Tensor, sp: torch.Tensor, pbits: int,
                neighbors: int) -> None:
    if sg.shape != sp.shape:
        raise ValueError(f"neighbor_verify_keys: grams {tuple(sg.shape)} "
                         f"and positions {tuple(sp.shape)} differ")
    if not 2 <= pbits <= 31 or neighbors < 1:
        raise ValueError(f"pbits {pbits} or neighbors {neighbors} out of "
                         "range")


def neighbor_verify_keys_twin(sg: torch.Tensor, sp: torch.Tensor,
                              pbits: int, neighbors: int = 1
                              ) -> torch.Tensor:
    """Plain-torch B12 (see neighbor_verify_keys)."""
    _b12_params(sg, sp, pbits, neighbors)
    g = _u32(sg)
    p = _u32(sp)
    i = torch.arange(g.shape[1], device=g.device)
    off = torch.zeros_like(p)
    for k in range(1, neighbors + 1):
        eq = (i >= k) & (g == _shr(g, k, _M32)) & (_shr(p, k, 0) < p)
        off = torch.where((off == 0) & eq, p - _shr(p, k, 0), off)
    return _i32(((p << (32 - pbits)) | off) & _M32)


def neighbor_verify_keys(sg: torch.Tensor, sp: torch.Tensor, pbits: int,
                         neighbors: int = 1) -> torch.Tensor:
    """B12. (gram, pos)-sorted rows (R, w) of grams and positions -> un-sort
    keys (pos << (32 - pbits) | off) truncated to u32: entry i claims off =
    pos - prev for the nearest of the `neighbors` entries before it in
    its row that carries an equal gram, so every claim is a true 4-byte
    match. Port of the Pallas kernel of the same name, with one repair:
    the reference reads a missing neighbour (i < k) as gram 0xFFFFFFFF at
    position 0, which claims a false match to position 0 when a segment
    holds exactly one gram below 0xFFFFFFFF; here a claim needs i >= k."""
    _check(sg, "neighbor_verify_keys", torch.int32, 2)
    _check(sp, "neighbor_verify_keys", torch.int32, 2)
    _b12_params(sg, sp, pbits, neighbors)
    if _use_twin(sg, "neighbor_verify_keys"):
        return neighbor_verify_keys_twin(sg, sp, pbits, neighbors)
    out = torch.empty_like(sg)
    _launch("neighbor_verify_keys", sg, sp, out, sg.shape[0], sg.shape[1],
            pbits, neighbors)
    return out


VERIFIED_NEAR_OFF = 32768  # finalize_verified's near_off default
VERIFIED_FAR_MIN = 4       # and far_min


def _verified_geometry(su, blocks, lengths):
    name = "finalize_verified"
    _check(su, name, torch.int32, 2)
    _check(blocks, name, torch.uint8, 2)
    _check(lengths, name, torch.int32, 1)
    B, N = blocks.shape
    if su.numel() != B * N or su.shape[0] % B or lengths.shape != (B,):
        raise ValueError(f"{name}: keys {tuple(su.shape)}, blocks "
                         f"{tuple(blocks.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not fit")
    w = su.shape[1]
    return B, N, (w - 1).bit_length()


def finalize_verified_twin(su: torch.Tensor, blocks: torch.Tensor,
                           lengths: torch.Tensor):
    """Plain-torch B13 (see finalize_verified): the reference's kernel
    body, whole-row shifts and all, on int64 planes."""
    B, N, pbits = _verified_geometry(su, blocks, lengths)
    dev = blocks.device
    gp = torch.arange(N, device=dev)
    blen = lengths.to(torch.int64)[:, None]
    offs = (su.to(torch.int64) & ((1 << pbits) - 1)).reshape(B, N)
    offs = torch.where(gp + 4 <= blen, offs, 0)
    reach = (offs > 0).to(torch.int64)
    span = 1
    for _ in range(VERIFIED_CHAIN_STEPS):
        nxt_off = _shl(offs, span * 4, 0)
        nxt_reach = _shl(reach, span * 4, 0)
        cont = (offs > 0) & (reach == span) & (nxt_off == offs)
        reach = torch.where(cont, reach + nxt_reach, reach)
        span *= 2
    mlen = reach * 4
    worth = (mlen >= VERIFIED_FAR_MIN) | ((mlen >= 4)
                                          & (offs <= VERIFIED_NEAR_OFF))
    mlen = torch.where(worth, mlen, 0).clamp(max=RUN_CAP)
    moff = torch.where(worth, offs, 0)
    mlen, moff = _offset1_runs(blocks, blen, mlen, moff)
    return mlen.to(torch.int32), moff.to(torch.int32)


def finalize_verified(su: torch.Tensor, blocks: torch.Tensor,
                      lengths: torch.Tensor):
    """B13. Position-ordered verified claims (B*nseg, w), entry j = (pos <<
    hbits | off), + (B, N) uint8 blocks + (B,) int32 lengths -> (mlen,
    moff), two (B, N) int32 planes of true matches: claims whose gram
    passes the block's length are dropped, same-offset claims 4, 8 and 16
    positions on along the whole row chain into lengths in 4-byte units
    (at most 32 bytes), capped at 16383, and the exact offset-1 run scan
    takes over where it is longer. Port of the Pallas kernel of the same
    name at its defaults (chain_steps 3, far_min 4, near_off 32768), the
    arguments of every level."""
    B, N, pbits = _verified_geometry(su, blocks, lengths)
    if _use_twin(blocks, "finalize_verified"):
        return finalize_verified_twin(su, blocks, lengths)
    mlen, moff, scratch = _run_outputs("finalize_verified", blocks)
    _launch("finalize_verified", su, blocks, lengths, mlen, moff, scratch,
            B, N, pbits, scratch.numel())
    return mlen, moff


def candidates_hash_verified(blocks: torch.Tensor, lengths: torch.Tensor,
                             neighbors: int = 2, window: int = 32768):
    """Byte-verified hash-path candidates (reference:
    glue_kernels.candidates_hash_verified): B11 -> (gram, pos) row sort ->
    B12 -> u32 row sort -> B13. Every (mlen, moff) is a true match, so the
    device may encode the sequence sections with no host pass."""
    pbits = (min(window, blocks.shape[1]) - 1).bit_length()
    g, pos = gram_pos_planes(blocks, window)
    sg, sp = _sort_rows2(g, pos, pbits)
    su = _sort_rows(neighbor_verify_keys(sg, sp, pbits, neighbors))
    return finalize_verified(su, blocks, lengths)


# ---------------------------------------------------------------------------
# K2 neighbor_unsort_keys
# ---------------------------------------------------------------------------

def _k2_params(sk: torch.Tensor, pbits: int, pos_mask: int | None):
    if not 2 <= pbits <= 31:
        raise ValueError(f"pbits {pbits} out of range")
    return sk.shape[1] - 1 if pos_mask is None else pos_mask


def neighbor_unsort_keys_twin(sk: torch.Tensor, pbits: int,
                              neighbors: int = 1,
                              pos_mask: int | None = None,
                              flip: int = 0) -> torch.Tensor:
    """Plain-torch K2 (see neighbor_unsort_keys)."""
    pmask = _k2_params(sk, pbits, pos_mask)
    s = _u32(sk) ^ flip
    sh = s >> pbits
    sp = s & pmask
    off = torch.zeros_like(s)
    for k in range(1, neighbors + 1):
        ph = _shr(sh, k, _M32)
        pp = _shr(sp, k, 0)
        eq = (sh == ph) & (pp < sp)
        off = torch.where((off == 0) & eq, sp - pp, off)
    return _i32((((s << (32 - pbits)) | off) & _M32) ^ flip)


def neighbor_unsort_keys(sk: torch.Tensor, pbits: int, neighbors: int = 1,
                         pos_mask: int | None = None,
                         flip: int = 0) -> torch.Tensor:
    """K2. Sorted (R, w) keys (hash << pbits | pos) -> un-sort keys
    (key << (32 - pbits) | off), truncated to 32 bits: the nearest earlier
    entry of the row with an equal hash (up to `neighbors` back) claims
    off = pos - prev. pos_mask overrides the position mask w - 1 (pair
    rows carry w/2 entries over w positions). Port of the Pallas kernel
    of the same name. `flip` (0 or _FLIP) is XORed into every word read
    and written: a signed row sort may then stand on either side in place
    of the unsigned one, with no XOR pass between."""
    _check(sk, "neighbor_unsort_keys", torch.int32, 2)
    pmask = _k2_params(sk, pbits, pos_mask)
    if _use_twin(sk, "neighbor_unsort_keys"):
        return neighbor_unsort_keys_twin(sk, pbits, neighbors, pos_mask,
                                         flip)
    out = torch.empty_like(sk)
    _launch("neighbor_unsort_keys", sk, out, sk.shape[0], sk.shape[1],
            pbits, neighbors, pmask, flip)
    return out


# ---------------------------------------------------------------------------
# K3 ldm_keys
# ---------------------------------------------------------------------------

def ldm_stride(span_blocks: int, n: int) -> int:
    """Sample spacing that keeps a combined row at <= 65536 samples, so the
    packed keys keep >= 16 hash bits (reference: glue_kernels.ldm_stride)."""
    s = 32
    while 2 * span_blocks * (n // s) > 65536:
        s *= 2
    return s


def _k3_geometry(minz: torch.Tensor, span_blocks: int, stride: int):
    B, N = minz.shape
    if B % span_blocks or N % stride:
        raise ValueError(f"ldm_keys: B={B} must be a multiple of "
                         f"span_blocks={span_blocks}, N={N} of "
                         f"stride={stride}")
    half = span_blocks * (N // stride)
    return B, N, half, (2 * half - 1).bit_length()


def ldm_keys_twin(minz: torch.Tensor, span_blocks: int = 4,
                  stride: int = 32, flip: int = 0) -> torch.Tensor:
    """Plain-torch K3 (see ldm_keys)."""
    B, N, half, pbits = _k3_geometry(minz, span_blocks, stride)
    dest = _u32(minz[:, ::stride])
    ctx = torch.cat([torch.full((span_blocks, N // stride), _M32,
                                dtype=torch.int64, device=minz.device),
                     dest[:B - span_blocks]])
    hd = (_mul32(dest, _C1) >> pbits).reshape(B // span_blocks, half)
    hc = (_mul32(ctx, _C1) >> pbits).reshape(B // span_blocks, half)
    pos = torch.arange(2 * half, device=minz.device)
    return _i32(((torch.cat([hc, hd], dim=1) << pbits) | pos) ^ flip)


def ldm_keys(minz: torch.Tensor, span_blocks: int = 4, stride: int = 32,
             flip: int = 0) -> torch.Tensor:
    """K3. (B, N) minimizer plane -> (B/span_blocks, 2*half) int32 LDM
    sort keys (h << pbits | sample index), each row [previous span's
    samples | this span's samples], h the top bits of the sample
    remixed by x2654435761. Port of the Pallas kernel of the same name.
    `flip` (0 or _FLIP) is XORed into every word written, for a signed
    row sort that follows."""
    _check(minz, "ldm_keys", torch.int32, 2)
    B, N, half, pbits = _k3_geometry(minz, span_blocks, stride)
    if _use_twin(minz, "ldm_keys"):
        return ldm_keys_twin(minz, span_blocks, stride, flip)
    out = torch.empty((B // span_blocks, 2 * half), dtype=torch.int32,
                      device=minz.device)
    _launch("ldm_keys", minz, out, B // span_blocks, N, stride, span_blocks,
            pbits, flip)
    return out


def ldm_unsorted(minz: torch.Tensor, span_blocks: int = 4,
                 neighbors: int = 1, stride: int | None = None,
                 flip_out: bool = False) -> torch.Tensor:
    """LDM candidate chain: keys -> sort -> neighbor/un-sort keys -> sort.
    Returns (B/span_blocks, sps) int32, entry j = (j << hbits | sample
    offset), position-ordered. The reference computes the minimizer plane
    itself when none is given; here the caller always passes one: a full
    (B, N) plane (B6's or B9's, or K1's with samples=False), sampled at
    ldm_stride(span_blocks, N) (stride None), or K1's sample plane, which
    is sampled already (stride=1). The reference's two unsigned row sorts
    are signed ones here, with K3 and K2 flipping the sign bit: one XOR
    pass in all, none with flip_out (the words come back with the sign
    bit flipped, for K4's flip=_FLIP)."""
    if stride is None:
        stride = ldm_stride(span_blocks, minz.shape[1])
    key = ldm_keys(minz, span_blocks, stride, flip=_FLIP)
    pbits = (key.shape[1] - 1).bit_length()
    su = _sort_signed(neighbor_unsort_keys(_sort_signed(key), pbits,
                                           neighbors, flip=_FLIP))
    return su if flip_out else su ^ _SIGN


def _ldm_est(su: torch.Tensor, lengths: torch.Tensor, n: int,
             span_blocks: int, max_off: int):
    """Sample-grid LDM claims from position-ordered LDM keys (reference:
    glue_kernels._ldm_est, XLA glue there and torch ops here). Returns
    (B, spb) int32 chained estimates (0 = no claim) and byte offsets."""
    sb = span_blocks
    stride = ldm_stride(sb, n)
    nspans, sps = su.shape
    half = sps // 2
    spb = half // sb
    B = nspans * sb
    pbits = (sps - 1).bit_length()
    offs = su[:, half:] & ((1 << (32 - pbits)) - 1)

    def shl(a, s, fill):
        return torch.cat([a[:, s:], torch.full((nspans, s), fill,
                                               dtype=a.dtype,
                                               device=a.device)], dim=1)

    # Chain over consecutive samples agreeing on the offset within +-1
    # slot (minimizer offsets jitter by one slot); reach caps at 6.
    agree = offs > 0
    reach = agree.to(torch.int32)
    for k in range(1, 6):
        nxt = shl(offs, k, 0)
        agree = agree & ((nxt - offs).abs() <= 1) & (nxt > 0)
        reach = reach + agree.to(torch.int32)
    valid = (reach >= 2) & (offs >= 2) & (offs * stride <= max_off)
    est_b = torch.where(valid, reach * stride, 0).reshape(B, spb)
    off_b = (offs * stride).reshape(B, spb)
    posb = torch.arange(spb, dtype=torch.int32, device=su.device) * stride
    est_b = torch.where(posb[None, :] + 40 <= lengths.to(torch.int32)[:, None],
                        est_b, 0)
    return est_b, off_b


def merge_ldm(mlen: torch.Tensor, moff: torch.Tensor, su: torch.Tensor,
              lengths: torch.Tensor, span_blocks: int, local_cap: int,
              max_off: int = 1 << 19):
    """Fold LDM claims into the full-resolution (mlen, moff) candidate
    planes (reference: glue_kernels.merge_ldm, XLA there and torch ops
    here). The estimates sit on the sample grid (every ldm_stride-th
    position, zeros between); one takes a position where it is longer
    than the local candidate and the local one is unsaturated (< local_cap)
    or the estimate shows >= 128 bytes."""
    B, N = mlen.shape
    stride = ldm_stride(span_blocks, N)
    est_b, off_b = _ldm_est(su, lengths, N, span_blocks, max_off)
    up_est = torch.zeros_like(mlen)
    up_off = torch.zeros_like(moff)
    up_est[:, ::stride] = est_b
    up_off[:, ::stride] = off_b
    take = (up_est > mlen) & ((mlen < local_cap) | (up_est >= 128))
    return torch.where(take, up_est, mlen), torch.where(take, up_off, moff)


# ---------------------------------------------------------------------------
# K4 compact_slots_sync
# ---------------------------------------------------------------------------

def _k4_geometry(su: torch.Tensor, lengths: torch.Tensor, su_ldm,
                 span_blocks: int):
    """(B, Ns, w, pbits, ldm) of K4's arguments; ldm is None without LDM
    rows, else (spb, stride, LDM key pbits) of their sample grid."""
    B = lengths.shape[0]
    R, w2 = su.shape
    if B < 1 or R % B or w2 % 2:
        raise ValueError(f"compact_slots_sync: {R} rows of {w2} pair "
                         f"entries for {B} blocks (an even count a row)")
    w = 2 * w2
    N = (R // B) * w
    if su_ldm is None:
        return B, N // 4, w, (w - 1).bit_length(), None
    nspans, sps = su_ldm.shape
    sb = span_blocks
    stride = ldm_stride(sb, N) if sb > 0 else 0
    if sb < 1 or nspans * sb != B or sps % (2 * sb) or \
            (sps // (2 * sb)) * stride != N:
        raise ValueError(f"compact_slots_sync: LDM rows {nspans} x {sps} "
                         f"are no spans of {sb} of {B} blocks of {N} "
                         "positions")
    return (B, N // 4, w, (w - 1).bit_length(),
            (sps // (2 * sb), stride, (sps - 1).bit_length()))


def compact_slots_sync_twin(su: torch.Tensor, window: int,
                            lengths: torch.Tensor, width: int = 6,
                            su_ldm: torch.Tensor | None = None,
                            span_blocks: int = 0, local_cap: int = 24,
                            max_off: int = 1 << 19,
                            flip: int = 0) -> torch.Tensor:
    """Plain-torch K4 (see compact_slots_sync): the torch _ldm_est and
    the slot words."""
    B, Ns, w, pbits, ldm = _k4_geometry(su, lengths, su_ldm, span_blocks)
    offbits = 32 - pbits
    s = (_u32(su) ^ flip).reshape(B, 2 * Ns)
    blen = lengths.to(torch.int64)[:, None]
    gp4 = torch.arange(Ns, device=su.device)
    segbase = (gp4 >> (pbits - 2)) << pbits  # (slot // ws) * w
    best = torch.full((B, Ns), _M32, dtype=torch.int64, device=su.device)
    for src in (s[:, 0::2], s[:, 1::2]):  # pairs 2i and 2i+1
        posf = src >> offbits
        off = src & ((1 << offbits) - 1)
        valid = (off > 0) & (segbase + posf + width <= blen)
        best = torch.minimum(best, torch.where(
            valid, ((posf & 3) << 30) | off, _M32))
    if ldm is not None:
        est_b, off_b = _ldm_est(_i32(_u32(su_ldm) ^ flip), lengths, 4 * Ns,
                                span_blocks, max_off)
        sls = Ns // ldm[0]
        est = torch.zeros_like(best)
        ldo = torch.zeros_like(best)
        est[:, ::sls] = est_b.to(torch.int64)
        ldo[:, ::sls] = off_b.to(torch.int64)
        ml0 = torch.where(best != _M32, width, 0)
        best = torch.where(est > ml0, ldo & _M32, best)
    return _i32(best).reshape(su.shape[0], w // 4)


def compact_slots_sync(su: torch.Tensor, window: int, lengths: torch.Tensor,
                       width: int = 6, su_ldm: torch.Tensor | None = None,
                       span_blocks: int = 0, local_cap: int = 24,
                       max_off: int = 1 << 19,
                       flip: int = 0) -> torch.Tensor:
    """K4. Position-ordered pair keys su (B*nseg, w/2), entry j =
    (pos << (32 - pbits) | off) -> (B*nseg, w/4) int32 slot words: slot i
    holds the smaller (k << 30 | off) of pairs 2i and 2i+1 whose claim has
    an offset and passes pos + width <= length, else 0xFFFFFFFF. With the
    position-ordered LDM keys su_ldm (ldm_unsorted's (B/span_blocks,
    sps) rows) the kernel computes _ldm_est's estimate of each sample,
    and the sample's slot takes the LDM offset when the estimate beats the
    local claim's width. Port of the Pallas kernel of the same name, with
    its signature; window and local_cap are the reference's arguments
    (window follows from su's width; local_cap is unused there too).
    `flip` (0 or _FLIP) is XORed into every word read from su and su_ldm:
    the last row sorts' signed words come in as they are."""
    _check(su, "compact_slots_sync", torch.int32, 2)
    _check(lengths, "compact_slots_sync", torch.int32, 1)
    if su_ldm is not None:
        _check(su_ldm, "compact_slots_sync", torch.int32, 2)
    B, Ns, w, pbits, ldm = _k4_geometry(su, lengths, su_ldm, span_blocks)
    if _use_twin(su, "compact_slots_sync"):
        return compact_slots_sync_twin(su, window, lengths, width, su_ldm,
                                       span_blocks, local_cap, max_off, flip)
    out = torch.empty((su.shape[0], w // 4), dtype=torch.int32,
                      device=su.device)
    spb, stride, lpbits = ldm or (0, 0, 0)
    _launch("compact_slots_sync", su, lengths, su_ldm, out, B, Ns, pbits,
            width, span_blocks, spb, lpbits, stride,
            max(-1 << 31, min(max_off, (1 << 31) - 1)), flip)
    return out


# ---------------------------------------------------------------------------
# B7 finalize_candidates
# ---------------------------------------------------------------------------

RUN_CAP = 16383  # longest offset-1 run and length estimate
CHAIN_STEPS = 2  # chain doublings per width (the reference's default,
                 # which every level's path uses)
RUN_TILE = 2048  # positions a CTA of B7's and B13's kernels (common.cuh
                 # kRunTile): one scratch word per tile of every row
MAX_RUN_ROWS = 65535  # the kernels' grid holds a row per blockIdx.y


def _run_outputs(name: str, blocks: torch.Tensor):
    """(mlen, moff, scratch) for B7's or B13's kernels on (B, N) blocks:
    two (B, N) int32 planes and the pre-pass's word per tile of each row.
    Raises for a shape the kernels' grid cannot hold."""
    B, N = blocks.shape
    if not 1 <= B <= MAX_RUN_ROWS or not 1 <= N < 1 << 30:
        raise ValueError(f"{name}: blocks {tuple(blocks.shape)}: the kernel "
                         f"takes 1-{MAX_RUN_ROWS} rows of 1 to 2^30 - 1 "
                         "bytes")
    mlen = torch.empty((B, N), dtype=torch.int32, device=blocks.device)
    scratch = torch.empty(B * -(-N // RUN_TILE), dtype=torch.int32,
                          device=blocks.device)
    return mlen, torch.empty_like(mlen), scratch


def _finalize_chunk_twin(sus, blocks: torch.Tensor, lengths: torch.Tensor,
                         widths: tuple, window: int, carry, final: bool):
    """Plain-torch _finalize_chunk: the reference's kernel body, whole-row
    shifts and all, on int64 planes."""
    B, N = blocks.shape
    w = min(window, N)
    omask = (1 << (w - 1).bit_length()) - 1
    dev = blocks.device
    gp = torch.arange(N, device=dev)
    blen = lengths.to(torch.int64)[:, None]
    if carry is None:
        mlen = torch.zeros((B, N), dtype=torch.int64, device=dev)
        moff = torch.zeros_like(mlen)
    else:
        mlen, moff = (c.to(torch.int64) for c in carry)
    for su, width in zip(sus, widths):
        # The chain runs along the whole block row, across segments.
        offs = (su.to(torch.int64) & omask).reshape(B, N)
        offs = torch.where(gp + width <= blen, offs, 0)
        reach = (offs > 0).to(torch.int64)
        span = 1
        for _ in range(CHAIN_STEPS):
            nxt_off = _shl(offs, span * width, 0)
            nxt_reach = _shl(reach, span * width, 0)
            cont = (offs > 0) & (reach == span) & (nxt_off == offs)
            reach = torch.where(cont, reach + nxt_reach, reach)
            span *= 2
        est = reach * width
        better = (est > mlen) | ((est == mlen) & (offs > 0)
                                 & ((offs < moff) | (moff == 0)))
        take = (offs > 0) & better
        mlen = torch.where(take, est, mlen)
        moff = torch.where(take, offs, moff)
    if final:
        worth = ((mlen >= 7) | ((mlen >= 6) & (moff <= 32768))
                 | ((mlen >= 5) & (moff <= 4096))
                 | ((mlen >= 4) & (moff <= 256)))
        mlen = torch.where(worth, mlen, 0).clamp(max=RUN_CAP)
        moff = torch.where(worth, moff, 0)
        mlen, moff = _offset1_runs(blocks, blen, mlen, moff)
    return mlen.to(torch.int32), moff.to(torch.int32)


def _offset1_runs(blocks: torch.Tensor, blen: torch.Tensor,
                  mlen: torch.Tensor, moff: torch.Tensor):
    """The offset-1 run scan of B7 and B13: r[i] = first byte change in
    [i, i + 2^nsteps), by doubling (the row's last byte always counts as
    a change); len1 = min(r - i + 1, blen - i, 16383) takes over where the
    byte repeats and len1 >= 4 beats mlen. int64 planes in and out."""
    B, N = blocks.shape
    gp = torch.arange(N, device=blocks.device)
    x = blocks.to(torch.int64)
    big = 1 << 30
    r = torch.where(x != _shl(x, 1, -1), gp, big)
    step = 1
    for _ in range(min(14, max(1, (N - 1).bit_length()))):
        r = torch.minimum(r, _shl(r, step, big))
        step *= 2
    len1 = torch.minimum(r - gp + 1, blen - gp).clamp(max=RUN_CAP)
    use1 = (x == _shr(x, 1, -1)) & (len1 >= 4) & (len1 > mlen)
    return torch.where(use1, len1, mlen), torch.where(use1, 1, moff)


def finalize_candidates_twin(sus, blocks: torch.Tensor,
                             lengths: torch.Tensor, widths: tuple,
                             window: int):
    """Plain-torch B7, chunked as the reference is (two widths per pass,
    the running (mlen, moff) carried between passes), so that the kernel,
    which does every width in one pass, is held to the chunked result."""
    carry = None
    for i in range(0, len(widths), 2):
        carry = _finalize_chunk_twin(sus[i:i + 2], blocks, lengths,
                                     tuple(widths[i:i + 2]), window, carry,
                                     final=i + 2 >= len(widths))
    return carry


def finalize_candidates(sus, blocks: torch.Tensor, lengths: torch.Tensor,
                        widths: tuple, window: int):
    """B7. Position-ordered un-sort keys of each width (B*nseg, w), entry
    j = (pos << hbits | off), + (B, N) uint8 blocks + (B,) int32 lengths
    -> (mlen, moff), two (B, N) int32 planes: per width the chain-doubled
    length estimate of each offset claim, merged across widths (longer,
    then nearer), the cost filter, then the exact offset-1 run scan
    (capped at 16383). Port of the reference's finalize_candidates and
    its Pallas kernel _finalize_chunk."""
    name = "finalize_candidates"
    _check(blocks, name, torch.uint8, 2)
    _check(lengths, name, torch.int32, 1)
    B, N = blocks.shape
    w = min(window, N)
    if not 1 <= len(widths) <= 4 or len(sus) != len(widths):
        raise ValueError(f"{name}: 1-4 widths, one key array each (got "
                         f"{len(widths)} widths, {len(sus)} arrays)")
    if any(not 1 <= int(x) <= 64 for x in widths):
        raise ValueError(f"{name}: widths {widths} out of range")
    if N % w or lengths.shape != (B,):
        raise ValueError(f"{name}: blocks {tuple(blocks.shape)} and "
                         f"lengths {tuple(lengths.shape)} do not fit")
    for su in sus:
        _check(su, name, torch.int32, 2)
        if su.shape != (B * (N // w), w):
            raise ValueError(f"{name}: key array {tuple(su.shape)} is not "
                             f"{(B * (N // w), w)}")
    if _use_twin(blocks, name):
        return finalize_candidates_twin(sus, blocks, lengths, widths, window)
    mlen, moff, scratch = _run_outputs(name, blocks)
    pad = 4 - len(widths)
    _launch(name, *sus, *[None] * pad, blocks, lengths, mlen, moff, scratch,
            B, N, len(widths), *widths, *[0] * pad, (w - 1).bit_length(),
            scratch.numel())
    return mlen, moff


# ---------------------------------------------------------------------------
# B8 compact_slots_dense
# ---------------------------------------------------------------------------

def _b8_geometry(mlen: torch.Tensor, window: int, est_b, off_b):
    B, N = mlen.shape
    w = min(window, N)
    if N % w or w % 4:
        raise ValueError(f"compact_slots_dense: block length {N} must be a "
                         f"multiple of a segment width {w} that 4 divides")
    Ns = N // 4
    spb = 0
    if est_b is not None:
        spb = est_b.shape[1]
        if (est_b.shape != (B, spb) or off_b is None
                or off_b.shape != est_b.shape or Ns % spb):
            raise ValueError("compact_slots_dense: est_b and off_b must be "
                             f"(B, spb) with spb dividing {Ns}")
    return B, N, w, Ns, spb


def compact_slots_dense_twin(mlen: torch.Tensor, moff: torch.Tensor,
                             window: int, est_b: torch.Tensor | None = None,
                             off_b: torch.Tensor | None = None,
                             local_cap: int = 24) -> torch.Tensor:
    """Plain-torch B8 (see compact_slots_dense)."""
    B, N, w, Ns, spb = _b8_geometry(mlen, window, est_b, off_b)
    best = torch.full((B, Ns), _M32, dtype=torch.int64, device=mlen.device)
    for k in range(4):
        key = (k << 30) | moff[:, k::4].to(torch.int64)
        best = torch.minimum(best, torch.where(mlen[:, k::4] >= MIN_MATCH,
                                               key, _M32))
    if spb:
        sls = Ns // spb
        ml0 = mlen[:, ::4 * sls].to(torch.int64)  # lane 0 of sample slots
        est = est_b.to(torch.int64)
        take = (est > ml0) & ((ml0 < local_cap) | (est >= 128))
        best[:, ::sls] = torch.where(take, off_b.to(torch.int64) & _M32,
                                     best[:, ::sls])
    return _i32(best).reshape(B * (N // w), w // 4)


def compact_slots_dense(mlen: torch.Tensor, moff: torch.Tensor, window: int,
                        est_b: torch.Tensor | None = None,
                        off_b: torch.Tensor | None = None,
                        local_cap: int = 24) -> torch.Tensor:
    """B8. Dense claims (B, N) int32 mlen/moff -> (B*nseg, w/4) int32 slot
    words: slot i holds the smallest (k << 30 | moff[4i+k]) over the lanes
    with mlen >= MIN_MATCH, else 0xFFFFFFFF. With LDM estimates (est_b,
    off_b: (B, spb) from _ldm_est) the slot of each sample takes the LDM
    offset under merge_ldm's rule: est > mlen[4i] and (mlen[4i] <
    local_cap or est >= 128). Port of the Pallas kernel of the same name,
    which computes _ldm_est inside its program."""
    name = "compact_slots_dense"
    for t in (mlen, moff):
        _check(t, name, torch.int32, 2)
    for t in (est_b, off_b):
        if t is not None:
            _check(t, name, torch.int32, 2)
    if moff.shape != mlen.shape:
        raise ValueError(f"{name}: mlen {tuple(mlen.shape)} and moff "
                         f"{tuple(moff.shape)} differ")
    B, N, w, Ns, spb = _b8_geometry(mlen, window, est_b, off_b)
    if _use_twin(mlen, name):
        return compact_slots_dense_twin(mlen, moff, window, est_b, off_b,
                                        local_cap)
    out = torch.empty((B * (N // w), w // 4), dtype=torch.int32,
                      device=mlen.device)
    _launch(name, mlen, moff, est_b, off_b, out, B, Ns, spb, local_cap)
    return out


# ---------------------------------------------------------------------------
# The parsed branch: B17 compact_slots, B18 compact_operands
# ---------------------------------------------------------------------------

def _parsed_geometry(name: str, chosen: torch.Tensor, *planes: torch.Tensor,
                     window: int):
    """Check the parse outputs; returns (B, N, w). `chosen` is bool (B10's
    output) or int32, the planes int32, all (B, N) with 4 | w | N."""
    if chosen.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"{name}: chosen must be bool or int32, got "
                         f"{chosen.dtype}")
    _check(chosen, name, chosen.dtype, 2)
    for t in planes:
        _check(t, name, torch.int32, 2)
        if t.shape != chosen.shape:
            raise ValueError(f"{name}: planes {tuple(t.shape)} and chosen "
                             f"{tuple(chosen.shape)} differ")
    B, N = chosen.shape
    w = min(window, N)
    if N % w or w % 4:
        raise ValueError(f"{name}: block length {N} must be a multiple of a "
                         f"segment width {w} that 4 divides")
    return B, N, w


def compact_slots_twin(chosen: torch.Tensor, moff: torch.Tensor,
                       window: int) -> torch.Tensor:
    """Plain-torch B17 (see compact_slots)."""
    B, N, w = _parsed_geometry("compact_slots", chosen, moff, window=window)
    best = torch.full((B, N // 4), _M32, dtype=torch.int64,
                      device=moff.device)
    for k in range(4):
        key = (k << 30) | _u32(moff[:, k::4])
        best = torch.minimum(best, torch.where(chosen[:, k::4] != 0, key,
                                               _M32))
    return _i32(best).reshape(B * (N // w), w // 4)


def compact_slots(chosen: torch.Tensor, moff: torch.Tensor,
                  window: int) -> torch.Tensor:
    """B17. Parse outputs (B, N) chosen (bool or int32) and int32 moff ->
    (B*nseg, w/4) int32 slot words: slot i holds the unsigned minimum of
    (k << 30 | moff[4i+k]) over the chosen lanes k, else 0xFFFFFFFF. A
    parse chooses at most one lane of a slot; a dense mask may choose
    several, and the minimum keeps the smallest k. Port of the Pallas
    kernel of the same name (a sign-flipped int32 minimum there, the same
    words)."""
    B, N, w = _parsed_geometry("compact_slots", chosen, moff, window=window)
    if _use_twin(moff, "compact_slots"):
        return compact_slots_twin(chosen, moff, window)
    out = torch.empty((B * (N // w), w // 4), dtype=torch.int32,
                      device=moff.device)
    _launch("compact_slots", chosen, moff, out, B, N, chosen.element_size())
    return out


def _operands_window(chosen: torch.Tensor, window: int) -> None:
    if min(window, chosen.shape[1]) > 32768:
        raise ValueError(f"compact_operands: segment width "
                         f"{min(window, chosen.shape[1])} > 32768 (the "
                         "position key has 16 bits with its sentinels)")


def compact_operands_twin(chosen: torch.Tensor, mlen: torch.Tensor,
                          moff: torch.Tensor, window: int):
    """Plain-torch B18 (see compact_operands)."""
    _operands_window(chosen, window)
    B, N, w = _parsed_geometry("compact_operands", chosen, mlen, moff,
                               window=window)
    gp = torch.arange(N, device=mlen.device) & (w - 1)
    poskey = (torch.where(chosen != 0, gp, gp + w) << 16) & _M32
    return tuple(_i32(poskey | _u32(x)).reshape(B * (N // w), w)
                 for x in (mlen, moff))


def compact_operands(chosen: torch.Tensor, mlen: torch.Tensor,
                     moff: torch.Tensor, window: int):
    """B18. Parse outputs (B, N) chosen (bool or int32), int32 mlen and
    moff -> two (B*nseg, w) int32 sort operands (poskey << 16 | mlen) and
    (poskey << 16 | moff) as u32 bit patterns, poskey the local position
    i & (w - 1) where chosen and w + that position elsewhere (distinct
    sentinels that sort after every chosen slot). The payload is ORed in
    unmasked, as the reference does. Port of the Pallas kernel of the same
    name, which asserts w <= 32768; here that raises ValueError."""
    _operands_window(chosen, window)
    B, N, w = _parsed_geometry("compact_operands", chosen, mlen, moff,
                               window=window)
    if _use_twin(mlen, "compact_operands"):
        return compact_operands_twin(chosen, mlen, moff, window)
    op_a = torch.empty((B * (N // w), w), dtype=torch.int32,
                       device=mlen.device)
    op_b = torch.empty_like(op_a)
    _launch("compact_operands", chosen, mlen, moff, op_a, op_b, B, N, w,
            chosen.element_size())
    return op_a, op_b


def compact_fast_glue(chosen: torch.Tensor, mlen: torch.Tensor,
                      moff: torch.Tensor, lengths: torch.Tensor,
                      max_seq: int, window: int) -> dict:
    """Parse outputs -> the packed-contract sequences dict (lit_len, offset,
    match_len: (B, max_seq) int32; nseq, last_literals: (B,) int32;
    overflow: (B,) bool). Port of the reference's compact_fast_glue, torch
    ops around B18: the two operands' unsigned row sorts, then for nseg > 1
    the segment merge (each segment's first min(w / 4, max_seq) entries as
    (global pos << gshift | payload) words, N - 1 for the empty ones, and
    two more row sorts), then the sequence fields. Keys repeat only as
    equal words (the merge's empty entries), so any sort gives the
    reference's order."""
    B, N = chosen.shape
    req_seq = max_seq
    max_seq = min(max_seq, N)
    w = min(window, N)
    nseg = N // w
    dev = mlen.device
    op_a, op_b = compact_operands(chosen, mlen, moff, window)
    capseg = min(w // MIN_MATCH, max_seq)
    s_a = _u32(_sort_rows(op_a)[:, :capseg])
    s_b = _u32(_sort_rows(op_b)[:, :capseg])
    segpos, segml, segoff = s_a >> 16, s_a & 0xFFFF, s_b & 0xFFFF
    nseq = chosen.sum(dim=1, dtype=torch.int64)
    if nseg > 1:
        R = B * nseg
        seg_start = ((torch.arange(R, device=dev) % nseg) * w)[:, None]
        seg_cnt = chosen.reshape(R, w).sum(dim=1, dtype=torch.int64)[:, None]
        valid = torch.arange(capseg, device=dev)[None, :] < seg_cnt
        gpos = torch.where(valid, segpos + seg_start, N - 1)
        gshift = 32 - (N - 1).bit_length()
        M = nseg * capseg
        gpos = ((gpos << gshift) & _M32).reshape(B, M)
        g_a = gpos | torch.where(valid, segml, 0).reshape(B, M)
        g_b = gpos | torch.where(valid, segoff, 0).reshape(B, M)
        take = min(max_seq, M)
        g_a = _u32(_sort_rows(_i32(g_a))[:, :take])
        g_b = _u32(_sort_rows(_i32(g_b))[:, :take])
        t2 = g_a >> gshift
        l2 = g_a & ((1 << gshift) - 1)
        o2 = g_b & ((1 << gshift) - 1)
    else:
        take = min(max_seq, capseg)
        t2, l2, o2 = segpos[:, :take], segml[:, :take], segoff[:, :take]
    if take < max_seq:
        t2, l2, o2 = (torch.nn.functional.pad(x, (0, max_seq - take))
                      for x in (t2, l2, o2))
    valid = torch.arange(max_seq, device=dev)[None, :] < nseq[:, None]
    ends = t2 + l2
    prev_end = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                          ends[:, :-1]], dim=1)
    lit = torch.where(valid, t2 - prev_end, 0)
    ml = torch.where(valid, l2, 0)
    off = torch.where(valid, o2, 0)
    last_end = torch.where(valid, ends, 0).max(dim=1).values
    out = {"lit_len": lit, "offset": off, "match_len": ml}
    out = {k: torch.nn.functional.pad(v, (0, req_seq - max_seq))
           .to(torch.int32) for k, v in out.items()}
    out.update(nseq=nseq.clamp(max=max_seq).to(torch.int32),
               last_literals=(lengths.to(torch.int64) - last_end)
               .to(torch.int32),
               overflow=nseq > max_seq)
    return out


def find_matches_hash_split(blocks: torch.Tensor, lengths: torch.Tensor,
                            widths: tuple = (5, 8), neighbors: int = 1,
                            window: int = 32768, max_seq: int = 16384,
                            lazy: bool = False) -> torch.Tensor:
    """The hash matcher's packed-sequences contract: (B, N) uint8 blocks
    and (B,) int32 lengths -> (B, max_seq + 1, 2) int32 (see
    match_pipeline.pack_outputs). Port of the reference's
    glue_kernels.find_matches_hash_split: candidates_hash_split (B5, K2,
    B7), the parse (B10), compact_fast_glue (B18, the row sorts, for
    nseg > 1 the segment merge, the sequence fields) and the packing."""
    from .match_pipeline import pack_outputs  # it imports this module
    from .parse_kernel import parse_greedy  # it imports this module
    mlen, moff = candidates_hash_split(blocks, lengths, widths=widths,
                                       neighbors=neighbors, window=window)
    chosen = parse_greedy(mlen, lazy).to(torch.int32)
    return pack_outputs(compact_fast_glue(chosen, mlen, moff, lengths,
                                          max_seq, window), max_seq)


# ---------------------------------------------------------------------------
# The compositions
# ---------------------------------------------------------------------------

def _sync_tail_fused(su, lengths, samples, width: int, window: int,
                     span_blocks: int, max_off: int) -> torch.Tensor:
    """LDM chain + pair-claim compaction (one XLA program in the
    reference; here a sequence of launches on one stream). su and the LDM
    rows come with the sign bit flipped, as the signed sorts leave them;
    samples is K1's sample plane."""
    su_l = ldm_unsorted(samples, span_blocks, neighbors=1, stride=1,
                        flip_out=True) if span_blocks else None
    return compact_slots_sync(su, window, lengths, width, su_l, span_blocks,
                              max_off=max_off, flip=_FLIP)


def _dense_tail_fused(sus, blocks, lengths, minz, widths: tuple,
                      window: int, span_blocks: int, local_cap: int,
                      max_off: int) -> torch.Tensor:
    """finalize + LDM chain + dense slot compaction (one XLA program in
    the reference)."""
    mlen, moff = finalize_candidates(sus, blocks, lengths, widths, window)
    est_b = off_b = None
    if span_blocks:
        su_l = ldm_unsorted(minz, span_blocks, neighbors=1)
        est_b, off_b = _ldm_est(su_l, lengths, blocks.shape[1], span_blocks,
                                max_off)
    return compact_slots_dense(mlen, moff, window, est_b, off_b, local_cap)


def _unsorted(key: torch.Tensor, pbits: int, neighbors: int,
              pos_mask: int | None = None, flipped: bool = False,
              flip_out: bool = False) -> torch.Tensor:
    """sort -> neighbor/un-sort keys -> sort: position-ordered claims. The
    unsigned row sorts are signed ones with K2 flipping the sign bit on
    its way in and out. `flipped`: the keys come with the sign bit
    flipped already (K1, B5 and B6 with flip=_FLIP), which saves the first
    XOR pass; `flip_out`: the words go out with the sign bit flipped (for
    K4's flip=_FLIP), which saves the last."""
    sk = _sort_signed(key if flipped else key ^ _SIGN)
    su = _sort_signed(neighbor_unsort_keys(sk, pbits, neighbors, pos_mask,
                                           flip=_FLIP))
    return su if flip_out else su ^ _SIGN


def candidates_hash_split(blocks, lengths, widths: tuple = (5, 8),
                          neighbors: int = 1, window: int = 32768):
    """(mlen, moff) from hash_keys of every width, without LDM: B5 -> sort
    -> K2 -> sort per width, then B7 (reference:
    glue_kernels.candidates_hash_split, and candidates_hash_glue and
    match_pipeline.candidates_hash, which compute the same planes)."""
    pbits = (min(window, blocks.shape[1]) - 1).bit_length()
    sus = [_unsorted(hash_keys(blocks, width, window, flip=_FLIP), pbits,
                     neighbors, flipped=True)
           for width in widths]
    return finalize_candidates(sus, blocks, lengths, tuple(widths), window)


def find_matches_positions(blocks: torch.Tensor, lengths: torch.Tensor,
                           widths: tuple = (6,), neighbors: int = 1,
                           window: int = 32768, ldm: int = 0,
                           ldm_max_off: int = 1 << 19, dense: bool = True,
                           sync: bool = False, lazy: bool = False,
                           psegs: int = 1) -> torch.Tensor:
    """Hash-matcher pipeline, segment-slots contract: (B, N) uint8 blocks
    and (B,) int32 lengths -> (B*nseg, w/4) int32 slot words, slot i of a
    row holding (subslot_k << 30 | byte_offset) or 0xFFFFFFFF. Port of the
    reference's glue_kernels.find_matches_positions: the dense branches,
    sync (level 1's syncmer pair anchors, one width) and full-resolution
    keys with or without LDM (levels 2-4), and the parsed branch
    (dense=False, no shipped level takes it): candidates, LDM claims merged
    in at full resolution, the greedy (or one-step lazy) parse B10 in
    `psegs` segments a block (each candidate cut at its segment's end
    when psegs > 1), then B17 compact_slots."""
    widths = tuple(widths)
    N = blocks.shape[1]
    w = min(window, N)
    pbits = (w - 1).bit_length()
    local_cap = 4 * max(widths)
    if sync:
        if not dense or len(widths) != 1:
            raise ValueError("sync implies single-width dense (got "
                             f"dense={dense}, widths={widths})")
        stride = ldm_stride(ldm, N) if ldm else 0  # 0: no LDM samples
        key, samples = hash_keys_winmin_sync(blocks, widths[0], window,
                                             stride, flip=_FLIP,
                                             samples=True)
        su = _unsorted(key, pbits, neighbors, pos_mask=w - 1, flipped=True,
                       flip_out=True)
        return _sync_tail_fused(su, lengths, samples, width=widths[0],
                                window=window, span_blocks=ldm,
                                max_off=ldm_max_off)
    if dense and ldm:
        # The first width's key build also writes the minimizer plane.
        key, minz = hash_keys_winmin(blocks, widths[0], window,
                                     ldm_stride(ldm, N), flip=_FLIP)
        sus = [_unsorted(key, pbits, neighbors, flipped=True)]
        sus += [_unsorted(hash_keys(blocks, width, window, flip=_FLIP),
                          pbits, neighbors, flipped=True)
                for width in widths[1:]]
        return _dense_tail_fused(sus, blocks, lengths, minz, widths, window,
                                 span_blocks=ldm, local_cap=local_cap,
                                 max_off=ldm_max_off)
    if dense:
        mlen, moff = candidates_hash_split(blocks, lengths, widths,
                                           neighbors, window)
        return compact_slots_dense(mlen, moff, window, local_cap=local_cap)
    chosen, _, moff = parsed_claims(blocks, lengths, widths, neighbors,
                                    window, ldm, ldm_max_off, lazy, psegs)
    return compact_slots(chosen, moff, window)


def parsed_claims(blocks: torch.Tensor, lengths: torch.Tensor,
                  widths: tuple, neighbors: int, window: int, ldm: int,
                  ldm_max_off: int, lazy: bool, psegs: int = 1):
    """The parsed branch up to its parse: (chosen, mlen, moff), the (B, N)
    bool parse (in psegs segments a block) of the hash candidates with the
    LDM claims merged in at full resolution (reference:
    glue_kernels.find_matches_positions, dense=False, before
    compact_slots)."""
    from .parse_kernel import parse_greedy  # it imports this module
    mlen, moff = candidates_hash_split(blocks, lengths, widths, neighbors,
                                       window)
    if ldm:
        su_l = ldm_unsorted(ldm_winmin(blocks, ldm_stride(ldm,
                                                          blocks.shape[1])),
                            ldm)
        mlen, moff = merge_ldm(mlen, moff, su_l, lengths, ldm,
                               local_cap=4 * max(widths),
                               max_off=ldm_max_off)
    return parse_greedy(mlen, lazy, psegs), mlen, moff
