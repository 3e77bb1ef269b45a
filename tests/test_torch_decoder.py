"""The port's decoder (qat_zstd_plugin_tpu_torch.decoder) held against the
JAX package's golden/decoder.py, on the CPU: on every input both give the
same bytes, or both raise their DecodeError.

Inputs: the port's own frames (SoftwareCodec, and GpuCodec(device="cpu")
with hybrid and full device entropy, whose custom FSE tables and
four-stream literals the device half writes), stock zstd's frames
(repcodes, treeless literals, repeat tables), edge payloads, skippable
frames, checksum and truncation rejects, a seeded corruption sweep, the
counterparts of tests/test_decoder_differential.py's regressions, a short
tools/fuzz_decoder campaign, and decompress() with libzstd hidden.
Inputs stay at 256 KiB or less: both decoders run at about 1 MB/s.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import qat_zstd_plugin_tpu as qz
from qat_zstd_plugin_tpu import oracle as jax_oracle
from qat_zstd_plugin_tpu.golden import decoder as golden

import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import decoder, format as tformat
from qat_zstd_plugin_tpu_torch import native, oracle
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec
from qat_zstd_plugin_tpu_torch.runtime.soft_codec import SoftwareCodec
from qat_zstd_plugin_tpu_torch.tools import cli

torch.set_num_threads(2)  # six test workers share a few cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 16384
SKIP = (0x184D2A50).to_bytes(4, "little")


def _corpus(n, seed=0):
    """tests/test_golden_decoder.py's mix: words, runs, small alphabets,
    random bytes."""
    rng = np.random.default_rng(seed)
    parts = []
    words = [b"golden ", b"decoder ", b"entropy ", b"of ", b"zstd "]
    while sum(map(len, parts)) < n:
        k = int(rng.integers(0, 4))
        if k == 0:
            parts.append(b"".join(words[i] for i in rng.integers(0, 5, 60)))
        elif k == 1:
            parts.append(bytes([int(rng.integers(0, 256))]) * 300)
        elif k == 2:
            parts.append(rng.integers(0, 8, 400, np.uint8).tobytes())
        else:
            parts.append(rng.integers(0, 256, 200, np.uint8).tobytes())
    return b"".join(parts)[:n]


def _verdict(mod, frame, max_output=None):
    """("ok", bytes) or ("reject", None); any other exception escapes."""
    try:
        return "ok", mod.decompress(frame, max_output=max_output)
    except mod.DecodeError:
        return "reject", None


def both(frame, max_output=None):
    """The port's verdict, asserted equal to the JAX package's."""
    mine = _verdict(decoder, frame, max_output)
    ref = _verdict(golden, frame, max_output)
    assert mine == ref, (mine[0], ref[0], frame[:16].hex())
    return mine


def _port_frame(kind, data):
    if kind.startswith("soft"):
        return SoftwareCodec(level=int(kind[5:]), block_size=BLOCK) \
            .compress(data)
    level, entropy = {"hybrid1": (1, "hybrid"), "full1": (1, True)}[kind]
    return GpuCodec(level=level, batch=4, block_size=BLOCK, device="cpu",
                    device_entropy=entropy).compress(data)


@pytest.mark.parametrize("kind", ["soft_1", "soft_5", "soft_9", "hybrid1",
                                  "full1"])
def test_port_frames(kind):
    data = _corpus(60_000 + len(kind), len(kind))
    frame = _port_frame(kind, data)
    assert both(frame) == ("ok", data)
    assert both(frame, max_output=len(data)) == ("ok", data)
    assert both(frame, max_output=len(data) - 1)[0] == "reject"


@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_stock_frames(level):
    """Repcodes, treeless literals, repeat tables, custom FSE: all that
    stock zstd writes and the port's encoder does not."""
    data = _corpus(150_000, 7)
    assert both(oracle.compress(data, level)) == ("ok", data)


@pytest.mark.parametrize("payload", [b"", b"a", b"ab" * 5000,
                                     bytes(range(256)) * 20,
                                     b"\x00" * 70000],
                         ids=["empty", "one", "ab", "range", "zeros"])
def test_edge_payloads(payload):
    assert both(oracle.compress(payload, 6)) == ("ok", payload)
    frame = SoftwareCodec(level=1, block_size=BLOCK).compress(payload)
    assert both(frame) == ("ok", payload)


def test_skippable_frames():
    data = _corpus(3_000, 9)
    frame = SoftwareCodec(level=1).compress(data)
    skip = SKIP + (6).to_bytes(4, "little") + b"skipme"
    assert both(skip + frame) == ("ok", data)
    assert both(frame + skip) == ("ok", data)
    assert both(skip + frame + skip + frame) == ("ok", data + data)
    assert both(skip) == ("ok", b"")
    assert both(skip[:7])[0] == "reject"


def test_checksum_reject():
    data = _corpus(5_000, 3)
    f = bytearray(SoftwareCodec(level=1).compress(data, checksum=True))
    assert both(bytes(f)) == ("ok", data)
    f[-1] ^= 0xFF
    assert both(bytes(f))[0] == "reject"
    with pytest.raises(decoder.DecodeError, match="checksum"):
        decoder.decompress(bytes(f))


def test_bad_magic_and_truncation():
    with pytest.raises(decoder.DecodeError, match="magic"):
        decoder.decompress(b"\x00\x01\x02\x03\x04")
    f = SoftwareCodec(level=1).compress(_corpus(20_000, 5))
    for cut in range(0, len(f), max(1, len(f) // 23)):
        assert both(f[:cut])[0] == ("ok" if cut == 0 else "reject")


@pytest.mark.parametrize("kind", ["soft_3", "full1"])
def test_corruption_sweep(kind):
    """Truncations, bit flips and 4-byte overwrites: the port's verdict
    is the JAX package's on each, and what it decodes, stock libzstd
    decodes to the same bytes (tools/fuzz_decoder's contract)."""
    data = _corpus(30_000, 11)
    f = _port_frame(kind, data)
    rng = np.random.default_rng(0)
    rejects = 0
    for trial in range(60):
        g = bytearray(f)
        k = trial % 3
        if k == 0:
            g = g[: int(rng.integers(5, len(g)))]
        elif k == 1:
            g[int(rng.integers(4, len(g)))] ^= 1 << int(rng.integers(0, 8))
        else:
            pos = int(rng.integers(4, len(g) - 4))
            g[pos:pos + 4] = rng.integers(0, 256, 4, np.uint8).tobytes()
        verdict, out = both(bytes(g), max_output=1 << 20)
        if verdict == "ok":
            assert oracle.decompress(bytes(g), 1 << 20) == out
        rejects += verdict == "reject"
    assert rejects >= 30


# tests/test_decoder_differential.py's regressions, held against both.

def _frame16(data: bytes, **kw) -> bytes:
    return SoftwareCodec(level=1, block_size=BLOCK).compress(data, **kw)


def test_fcs_is_enforced():
    f = bytearray(_frame16(b"fcs check " * 200, checksum=False))
    assert f[4] >> 6 == 1
    f[6] ^= 0x40
    assert both(bytes(f))[0] == "reject"
    with pytest.raises(decoder.DecodeError, match="content size"):
        decoder.decompress(bytes(f))
    with pytest.raises(oracle.ZstdOracleError):
        oracle.decompress(bytes(f), 1 << 20)


def test_skippable_size_beyond_input_rejected():
    real = _frame16(b"payload " * 100)
    bad = b"\x50\x2a\x4d\x18\xff\xff\x00\x00" + real
    assert both(bad)[0] == "reject"
    with pytest.raises(decoder.DecodeError, match="skippable"):
        decoder.decompress(bad)
    good = b"\x50\x2a\x4d\x18\x04\x00\x00\x00abcd" + real
    assert both(good) == ("ok", b"payload " * 100)


def test_truncated_reads_reject_cleanly():
    assert both(bytes.fromhex("28b52ffd200001"))[0] == "reject"
    full = _frame16(b"truncate me " * 400)
    for cut in (5, 7, 9, len(full) // 2, len(full) - 1):
        assert both(full[:cut])[0] == "reject"


def test_output_limit_guard():
    data = b"\x7a" * 100000  # an RLE block: a 4-byte body, 100 KB out
    f = _frame16(data)
    assert both(f) == ("ok", data)
    assert both(f, max_output=1000)[0] == "reject"
    with pytest.raises(decoder.DecodeError, match="limit"):
        decoder.decompress(f, max_output=1000)


def test_reject_contract_on_garbage():
    """Any malformed input raises DecodeError (both() lets any other
    exception escape), with the JAX package's verdict."""
    rng = np.random.default_rng(5)
    base = _frame16(b"garble " * 500)
    for _ in range(200):
        buf = bytearray(base)
        for _ in range(rng.integers(1, 6)):
            buf[rng.integers(0, len(buf))] = rng.integers(0, 256)
        both(bytes(buf), max_output=1 << 20)
    for n in (1, 3, 4, 5, 9, 64, 511):
        both(rng.integers(0, 256, n, np.uint8).tobytes())
        both(tformat.MAGIC.to_bytes(4, "little")
             + rng.integers(0, 256, n, np.uint8).tobytes())


def test_zero_sequence_block_trailing_garbage_rejected():
    lit = b"hello, zero seqs"  # < 32 bytes: the 1-byte literals header
    body = bytes([len(lit) << 3]) + lit + b"\x00"  # raw lits + nseq=0

    def build(b: bytes) -> bytes:
        return (tformat.frame_header(len(lit), 10, False)
                + tformat.block_header(True, tformat.BLOCK_COMPRESSED,
                                       len(b)) + b)

    assert both(build(body)) == ("ok", lit)
    bad = build(body + b"\xde\xad\xbe\xef")
    assert both(bad)[0] == "reject"
    with pytest.raises(oracle.ZstdOracleError):
        oracle.decompress(bad, len(lit))


def test_fuzz_decoder_campaign_smoke(tmp_path):
    """An 8 s differential campaign against stock libzstd comes back
    clean."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "qat_zstd_plugin_tpu_torch.tools.fuzz_decoder",
         "8", str(tmp_path / "corpus")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK decoder-differential" in r.stdout
    assert not (tmp_path / "corpus" / "crashes").exists()


@pytest.mark.parametrize("level,entropy", [(1, "hybrid"), (1, True),
                                            (9, True)])
def test_checksum_free_device_entropy_mutations(level, entropy):
    """chip_smoke.py phase 10 (b) on the CPU: a device-entropy frame of
    chip_smoke's 64 KiB + 5 byte input, written without a checksum so that
    a mutation that still decodes reaches the byte comparison, and its
    DIFF_MUTATIONS seeded mutations. The port's verdict is the JAX
    package's on each; chip_smoke.differential_frame finds no
    disagreement with stock libzstd, some mutations decode in both, and
    the port rejects what stock decodes only for STRICTER_REJECTS."""
    import random
    from qat_zstd_plugin_tpu_torch.corpus import make_corpus
    from qat_zstd_plugin_tpu_torch.tools import fuzz_decoder as fz
    sys.path.insert(0, REPO)
    import chip_smoke
    x = chip_smoke.ragged_bytes(make_corpus((1 << 20) + chip_smoke.TAIL, 0),
                                chip_smoke.FORMAT_BYTES)[:chip_smoke.DIFF_BYTES]
    f = GpuCodec(level=level, batch=8, block_size=chip_smoke.DIFF_BLOCK,
                 device="cpu", device_entropy=entropy).compress(
                     x, checksum=False)
    assert both(f) == ("ok", x)
    r = chip_smoke.differential_frame(f, level, chip_smoke.DIFF_MUTATIONS)
    assert r["finding"] is None, r["finding"]
    assert r["both_decoded"] > 0
    assert set(r["stricter"]) <= set(chip_smoke.STRICTER_REJECTS)
    assert r["both_decoded"] + r["both_rejected"] + sum(
        r["stricter"].values()) == chip_smoke.DIFF_MUTATIONS
    rnd = random.Random(level)
    for _ in range(chip_smoke.DIFF_MUTATIONS):
        both(fz.mutate(rnd, f), max_output=fz.MAX_OUT)


# decompress() without libzstd: the package's own decoder, as the JAX
# package's decompress() falls back to golden/decoder.py.

@pytest.fixture
def no_libzstd(monkeypatch):
    monkeypatch.setattr(oracle, "available", lambda: False)
    monkeypatch.setattr(jax_oracle, "available", lambda: False)

    def refused(*a, **k):
        raise AssertionError("libzstd was called")
    monkeypatch.setattr(oracle, "decompress", refused)
    monkeypatch.setattr(jax_oracle, "decompress", refused)


@pytest.mark.parametrize("level,entropy", [(1, False), (5, False),
                                           (1, "hybrid")])
def test_decompress_without_libzstd(no_libzstd, level, entropy):
    x = _corpus(200_000, level)
    frame = qzt.compress(x, level=level, batch=2, device="cpu",
                         device_entropy=entropy)
    assert qzt.decompress(frame) == x
    assert qzt.decompress(frame, len(x)) == x
    assert qzt.decompress(frame) == qz.decompress(frame)
    with pytest.raises(decoder.DecodeError, match="limit"):
        qzt.decompress(frame, len(x) // 2)
    with pytest.raises(golden.DecodeError, match="limit"):
        qz.decompress(frame, len(x) // 2)


def test_default_compress_decompress_without_libzstd(no_libzstd):
    x = _corpus(140_000, 2)
    assert qzt.decompress(qzt.compress(x, device="cpu")) == x


def test_cli_roundtrip_without_libzstd(no_libzstd, tmp_path, capsys):
    path = tmp_path / "in.bin"
    path.write_bytes(_corpus(50_000, 4))
    assert cli.run(["roundtrip", str(path), "--cpu"]) == 0
    assert "round-trip: PASS" in capsys.readouterr().out
    assert cli.run(["compress", str(path), "--cpu"]) == 0
    assert cli.run(["decompress", str(path) + ".zst", "-o",
                    str(tmp_path / "out")]) == 0
    assert (tmp_path / "out").read_bytes() == path.read_bytes()


# The designed difference (ROADMAP.md §C): the last Huffman weight.

def _literals_only_frame(p, n=3000):
    """A one-block frame whose body is Huffman-coded literals of n bytes
    drawn with probabilities p, and no sequences."""
    x = np.random.default_rng(1).choice(
        np.arange(len(p), dtype=np.uint8), p=p, size=n).astype(np.uint8)
    body = native.block_body(x, np.zeros(0), np.zeros(0), np.zeros(0), n)
    return tformat.assemble_frame(x, [body], 131072, True), x.tobytes()


@pytest.mark.parametrize("p,golden_refuses", [
    ((.25, .25, .5), True), ((.125, .125, .25, .5), True),
    ((.3, .3, .4), True), ((.5, .25, .25), False)])
def test_last_huffman_weight_of_a_power_of_two_sum(p, golden_refuses):
    """The last symbol's code is the shortest, so the weights sent for the
    others already sum to a power of two: the last weight tops the sum up
    to the next one, as in libzstd. The port's decoder returns libzstd's
    bytes; golden/decoder.py derives a weight of 0 and refuses the
    frame. Where the last symbol's code is not the shortest, both
    decode."""
    frame, x = _literals_only_frame(p)
    assert oracle.decompress(frame, len(x)) == x
    assert decoder.decompress(frame) == x
    if golden_refuses:
        with pytest.raises(golden.DecodeError, match="not fully consumed"):
            golden.decompress(frame)
    else:
        assert both(frame) == ("ok", x)


def test_low_entropy_shape_decodes():
    """tests/test_fuzz.py's low-entropy shape (utils.corpora.adversarial
    kind 6) at 131073 bytes: the frame at level 1 hits the rule above."""
    from qat_zstd_plugin_tpu_torch.utils.corpora import adversarial
    x = adversarial(np.random.default_rng((0, 10, 6)), (131073,), 6)
    frame = SoftwareCodec(level=1).compress(x)
    assert decoder.decompress(frame) == x == oracle.decompress(frame, len(x))
    with pytest.raises(golden.DecodeError):
        golden.decompress(frame)


@pytest.mark.parametrize("nibbles,verdict", [
    (0x11, "ok"), (0x22, "weights of 1"), (0xBB, "weights of 1"),
    (0x23, "weights of 1"), (0x12, "checksum"), (0xCC, "table log"),
    (0xD1, "table log"), (0xC1, "remainder")])
def test_huffman_tree_description_rules(nibbles, verdict):
    """Two direct weights in the tree description of the (1/4, 1/4, 1/2)
    frame replaced. libzstd refuses a table log over 12 (a sum of 4096 or
    more) and an odd number of weights of 1, or fewer than two (0x22:
    weights 2, 2 and a derived 3, the same code lengths as 1, 1, 2), and
    so does the port's decoder. A valid tree with other code lengths
    (0x12) decodes to other bytes, and the checksum refuses them."""
    frame, x = _literals_only_frame((.25, .25, .5))
    k = frame.index(bytes([129, 0x11]))
    bad = frame[:k + 1] + bytes([nibbles]) + frame[k + 2:]
    if verdict == "ok":
        assert decoder.decompress(bad) == x
        return
    with pytest.raises(oracle.ZstdOracleError):
        oracle.decompress(bad, len(x))
    with pytest.raises(decoder.DecodeError, match=verdict):
        decoder.decompress(bad)
