"""compressAndVerify parity of the port (reference src/qatseqprod.c:1245),
against the JAX package, on the CPU.

The counterparts of tests/test_verify_mode.py: wrong device claims must
still give frames that decode exactly (the native extension pass
re-checks every claim against the bytes), and GpuCodec.compress(...,
validate=True) checks each block's final sequences with the port's
format.validate_sequences, whose verdicts are golden/matcher.py's.
"""

import inspect

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.format.frame import BlockSequences as JaxSeqs
from qat_zstd_plugin_tpu.golden import matcher
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec

from qat_zstd_plugin_tpu_torch import native, oracle
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.format import (MIN_MATCH, BlockSequences,
                                              validate_sequences)
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 131072


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    text = make_corpus(120000, seed=3)
    return (text + rng.integers(0, 256, 30000, np.uint8).tobytes()) * 2


def corrupting(collect):
    """tests/test_verify_mode.py's corruption: wrong offsets for a third
    of each block's sequences, lengths plus 7 for another third."""
    def run(handle):
        out = collect(handle)
        rng = np.random.default_rng(0)
        bad = []
        for seqs, sec in out:
            if seqs is None or seqs.nseq == 0:
                bad.append((seqs, sec))
                continue
            off = seqs.offsets.copy()
            ml = seqs.match_lengths.copy()
            k = len(off)
            idx = rng.permutation(k)
            off[idx[:k // 3]] = rng.integers(1, 30000, k // 3) \
                .astype(off.dtype)
            ml[idx[k // 3:2 * k // 3]] += 7
            bad.append((type(seqs)(seqs.lit_lengths, off, ml,
                                   seqs.last_literals), sec))
        return bad
    return run


@pytest.mark.parametrize("level", [1, 9])
def test_false_device_claims_are_repaired(corpus, level):
    """Twin of test_verify_mode.py's case, at the hash and content paths:
    the frame decodes exactly."""
    c = GpuCodec(level=level, batch=2, device="cpu")
    c.collect_batch = corrupting(c.collect_batch)
    f = c.compress(corpus)
    assert oracle.decompress(f, len(corpus)) == corpus


def test_validate_refuses_the_corrupted_claims_as_the_reference(corpus):
    """Lengths plus 7 overrun the block; the extension pass leaves that to
    the entropy coder, which writes the block raw. validate=True refuses
    such sequences, in the port as in the reference."""
    c = GpuCodec(level=1, batch=2, device="cpu")
    c.collect_batch = corrupting(c.collect_batch)
    with pytest.raises(AssertionError):
        c.compress(corpus, validate=True)
    ref = TpuCodec(level=1, batch=2)
    ref.collect_batch = corrupting(ref.collect_batch)
    with pytest.raises((AssertionError, IndexError)):
        ref.compress(corpus, validate=True)


def test_verify_pass_drops_false_and_extends_true():
    """Twin of test_verify_mode.py's case with the port's native runtime."""
    data = np.frombuffer(b"abcdefgh" * 64 + b"XYZW" * 16, np.uint8)
    lit = np.array([8, 0], np.uint32)
    off = np.array([8, 3], np.uint32)
    ml = np.array([16, 40], np.uint32)
    span = int(lit.sum() + ml.sum())
    last = len(data) - span
    ll, of, mm, lastlit = native.extend_sequences(data, lit, off, ml, last)
    assert len(ll) == 1              # false claim dropped
    assert of[0] == 8
    assert mm[0] >= 8 * 64 - 8       # true claim extended to the run end
    assert ll.sum() + mm.sum() + lastlit == len(data)
    validate_sequences(data, BlockSequences(ll, of, mm, lastlit))


@pytest.mark.parametrize("level", [1, 9])
def test_validate_flag_equals_reference(corpus, level):
    """validate=True round-trips, equals compress() and the reference's
    compress(validate=True)."""
    data = corpus[:300000]
    c = GpuCodec(level=level, batch=2, device="cpu")
    f = c.compress(data, validate=True)
    assert f == c.compress(data)
    assert f == TpuCodec(level=level, batch=2).compress(data, validate=True)
    assert oracle.decompress(f, len(data)) == data


def test_validate_is_keyword_only_where_the_reference_has_it():
    """compress_bodies and finish_block_host take validate by keyword;
    the existing positional callers (frame_start) still work."""
    for name in ("compress_bodies", "finish_block_host"):
        p = inspect.signature(getattr(GpuCodec, name)).parameters
        assert p["validate"].kind is inspect.Parameter.KEYWORD_ONLY
        assert p["validate"].default is False
    data = make_corpus(2 * BLOCK + 100, seed=8)
    c = GpuCodec(level=1, batch=2, device="cpu")
    buf = np.frombuffer(data, np.uint8)
    assert c.compress_bodies(buf, False) == c.compress_bodies(
        buf, frame_start=False, validate=True)


# (block, ctx_len, (lit_lengths, offsets, match_lengths), last_literals)
_ABC = b"abcabcabcabcXYZabcabc"
CRAFTED = {
    "good": (_ABC, 0, ([3], [3], [9]), 9),
    "overlap_off1_run": (b"a" * 40, 0, ([1], [1], [39]), 0),
    "overlap_off2_run": (b"ab" * 20, 0, ([2], [2], [38]), 0),
    "overlap_mismatch": (b"ab" * 10 + b"c" + b"ab" * 9, 0, ([2], [2], [37]),
                         0),
    "byte_mismatch": (_ABC, 0, ([3], [3], [10]), 8),
    "offset_zero": (_ABC, 0, ([3], [0], [9]), 9),
    "offset_past_pos": (_ABC, 0, ([3], [4], [9]), 9),
    "offset_into_context": (b"abc" + _ABC, 3, ([0], [3], [3]), 18),
    "offset_past_context": (b"abc" + _ABC, 3, ([0], [4], [3]), 18),
    "short_match": (_ABC, 0, ([3], [3], [MIN_MATCH - 1]), 16),
    "negative_literals": (_ABC, 0, ([-1], [3], [9]), 13),
    "span_short": (_ABC, 0, ([3], [3], [9]), 8),
    "span_long": (_ABC, 0, ([3], [3], [9]), 10),
    "match_past_end": (_ABC, 0, ([3], [3], [30]), -12),
    "second_seq_bad": (_ABC, 0, ([3, 3], [3, 99], [6, 3]), 6),
    "empty": (_ABC, 0, ([], [], []), len(_ABC)),
    "empty_with_context": (b"xyz" + _ABC, 3, ([], [], []), len(_ABC)),
}


def _verdict(fn, block, ctx, arrays, last, seqs_type) -> bool:
    ll, off, ml = (np.asarray(a, np.int64) for a in arrays)
    try:
        fn(np.frombuffer(block, np.uint8), seqs_type(ll, off, ml, last),
           ctx_len=ctx)
        return True
    except (AssertionError, IndexError):
        return False


@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_validate_sequences_gives_the_golden_verdict(case):
    block, ctx, arrays, last = CRAFTED[case]
    want = _verdict(matcher.validate_sequences, block, ctx, arrays, last,
                    JaxSeqs)
    assert _verdict(validate_sequences, block, ctx, arrays, last,
                    BlockSequences) == want
    assert want == case.startswith(("good", "overlap_off", "offset_into",
                                    "empty"))


def test_validate_sequences_random_verdicts():
    """Seeded random sequences over small alphabets (most fail somewhere,
    some pass): the port's verdict is the golden one's every time."""
    rng = np.random.default_rng(11)
    passed = 0
    for _ in range(3000):
        n, ctx = int(rng.integers(0, 60)), int(rng.integers(0, 10))
        data = rng.integers(0, 2, n + ctx, np.uint8).tobytes()
        k = int(rng.integers(0, 5))
        arrays = (rng.integers(-1, 8, k), rng.integers(0, 12, k),
                  rng.integers(2, 10, k))
        last = n - int((arrays[0] + arrays[2]).sum()) \
            + int(rng.integers(-1, 2))
        want = _verdict(matcher.validate_sequences, data, ctx, arrays, last,
                        JaxSeqs)
        assert _verdict(validate_sequences, data, ctx, arrays, last,
                        BlockSequences) == want
        passed += want
    assert passed > 100


def test_validate_sequences_raises_without_assert():
    """The check raises AssertionError itself, so python -O keeps it."""
    src = inspect.getsource(validate_sequences)
    assert "assert " not in src.replace("AssertionError", "")
    block = np.frombuffer(_ABC, np.uint8)
    with pytest.raises(AssertionError, match="seq 0: mismatch at \\+9"):
        validate_sequences(block, BlockSequences(
            np.array([3]), np.array([3]), np.array([10]), 8))
