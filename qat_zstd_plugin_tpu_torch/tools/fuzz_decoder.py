"""Differential decoder fuzzer: the port's decoder against stock libzstd.

Port of the JAX package's scripts/fuzz_decoder.py for the port's own
frame consumer: decompress() decodes with decoder.py when libzstd is
absent, so that decoder is a parsing attack surface and must agree with
stock libzstd on every input (the reference links into zstd's
decompression-side fuzz family for the same reason).

Agreement contract, per input:
  * both decode       -> the decoded bytes must be identical;
  * both reject       -> fine (error classes may differ);
  * the port decodes what stock rejects -> FINDING (saved under
    <corpus>/crashes/). A stock accept with a port reject is tolerated:
    the decoder is stricter on purpose (it holds every offset to the
    declared window; stock checks only the buffer).
The decoder must also reject CLEANLY: an exception other than
decoder.DecodeError escaping decompress() is a finding too.

Coverage-guided: sys.monitoring LINE events over the port's decode
modules (decoder.py, fse_format.py, huffman_format.py, xxhash.py) are
the signal; inputs reaching new lines join the corpus. Seeds are the
port's own frames (SoftwareCodec at levels 1 and 5 on 16 KiB blocks,
with and without a checksum, over every block and literals mode, and
GpuCodec(device="cpu") frames with hybrid and full device entropy, whose
custom FSE tables and four-stream literals the device half writes), a
skippable frame and garbage; mutations are bit flips, byte writes,
truncations, splices, LE16 tweaks and header damage past the magic.

    python -m qat_zstd_plugin_tpu_torch.tools.fuzz_decoder \
        [seconds] [corpus_dir]

Exit 0 and an `OK decoder-differential execs=...` line when the campaign
is clean; exit 1 when a disagreement is found (the input is saved).
"""

from __future__ import annotations

import ctypes
import os
import random
import signal
import sys
import time

import numpy as np

from .. import oracle

MAX_OUT = 8 << 20  # output budget for both consumers
DEADLINE_S = 5.0  # a decode under line tracing that takes longer is skipped
SEED_BLOCK = 16384
# The directory that holds the package: the default corpus lives there.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CORPUS = os.path.join(_ROOT, ".fuzz_corpus", "torch_decoder")


def stock_decode(frame: bytes) -> bytes | None:
    """Stock libzstd's verdict: decoded bytes or None (reject), with at
    most MAX_OUT bytes out."""
    z = oracle._lib()
    dst = ctypes.create_string_buffer(MAX_OUT)
    r = z.ZSTD_decompress(dst, MAX_OUT, frame, len(frame))
    if z.ZSTD_isError(r):
        return None
    return dst.raw[:r]


class _Deadline(Exception):
    pass


def port_decode(frame: bytes, deadline_s: float = DEADLINE_S):
    """The port's decoder's verdict: bytes, None (clean reject), a
    _Deadline (too slow under line tracing: skipped, kept for the corpus),
    or an exception instance (an UNCLEAN reject, itself a finding)."""
    from .. import decoder

    def on_alarm(signum, frm):
        raise _Deadline()

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, deadline_s)
    try:
        return decoder.decompress(frame, max_output=MAX_OUT)
    except decoder.DecodeError:
        return None
    except MemoryError:
        return None
    except _Deadline:
        return _Deadline()
    except Exception as exc:  # reject-contract violation
        return exc
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def verdicts_agree(port, stock) -> str | None:
    """None when the two verdicts agree under the contract above, else
    what the finding is."""
    if isinstance(port, _Deadline):
        return None  # too slow to compare under tracing; not a bug
    if isinstance(port, Exception):
        return f"port decoder unclean reject: {type(port).__name__}: {port}"
    if port is not None and stock is not None:
        return None if port == stock else "decoded bytes differ"
    if port is not None and stock is None:
        return "port decoder decoded what stock rejects"
    return None


def make_seeds() -> list[bytes]:
    """The port's frames over every block and literals mode, a skippable
    frame before a real one, and garbage."""
    from ..runtime.gpu_codec import GpuCodec
    from ..runtime.soft_codec import SoftwareCodec
    rng = np.random.default_rng(0)
    words = [b"seed ", b"frame ", b"decoder ", b"fuzz ", b"golden "]
    text = b"".join(words[int(k)] for k in rng.integers(0, 5, 20000))
    seeds = []
    inputs = [
        text[:65536],                                    # compressed blocks
        b"\x55" * 40000,                                 # RLE block
        rng.integers(0, 256, 4096, np.uint8).tobytes(),  # raw block
        text[:900],                                      # 1-stream huffman
        text[:300] + b"\x00" * 700,                      # short mixed
        b"",                                             # empty frame
    ]
    for lvl in (1, 5):
        c = SoftwareCodec(level=lvl, block_size=SEED_BLOCK)
        for d in inputs:
            for ck in (True, False):
                seeds.append(c.compress(d, checksum=ck))
    # The device half's entropy stages: custom FSE sequence tables
    # (hybrid) and four-stream Huffman literals with their tree
    # descriptions (full).
    for lvl, entropy in ((1, "hybrid"), (1, True), (5, True)):
        c = GpuCodec(level=lvl, batch=4, block_size=SEED_BLOCK,
                     device="cpu", device_entropy=entropy)
        seeds.append(c.compress(text[:65536]))
    # skippable frame + trailing real frame
    seeds.append(b"\x50\x2a\x4d\x18\x04\x00\x00\x00abcd" + seeds[0])
    seeds.append(random.Random(99).randbytes(512))  # pure garbage
    return seeds


def mutate(rnd: random.Random, data: bytes) -> bytes:
    """One to four of the JAX fuzzer's mutations of `data`, cut to 64 KiB
    (scripts/fuzz_decoder.py:121-152)."""
    buf = bytearray(data)
    n = len(buf)
    for _ in range(rnd.randint(1, 4)):
        op = rnd.randrange(7)
        if n == 0 or op == 5:
            ins = rnd.randbytes(rnd.randint(1, 16))
            k = rnd.randint(0, n)
            buf[k:k] = ins
        elif op == 0:      # bit flip
            k = rnd.randrange(n)
            buf[k] ^= 1 << rnd.randrange(8)
        elif op == 1:      # byte write
            buf[rnd.randrange(n)] = rnd.randrange(256)
        elif op == 2:      # truncate
            buf = buf[: rnd.randint(0, n)]
        elif op == 3:      # LE16 tweak (sizes, offsets)
            k = rnd.randrange(max(1, n - 1))
            v = int.from_bytes(buf[k:k + 2], "little")
            v = (v + rnd.choice((-2, -1, 1, 2, 0x7F00))) & 0xFFFF
            buf[k:k + 2] = v.to_bytes(2, "little")
        elif op == 4:      # splice from self
            if n >= 8:
                a, b = sorted(rnd.randrange(n) for _ in range(2))
                k = rnd.randint(0, n)
                buf[k:k] = buf[a:b][:64]
        else:              # header damage past the magic
            if n > 5:
                buf[4 + rnd.randrange(min(8, n - 4))] = rnd.randrange(256)
        n = len(buf)
    return bytes(buf[: 1 << 16])


def _save(crash_dir: str, name: str, frame: bytes) -> str:
    os.makedirs(crash_dir, exist_ok=True)
    path = os.path.join(crash_dir, name)
    with open(path, "wb") as f:
        f.write(frame)
    return path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seconds = float(argv[0]) if argv else 60.0
    root = argv[1] if len(argv) > 1 else DEFAULT_CORPUS
    os.makedirs(root, exist_ok=True)
    crash_dir = os.path.join(root, "crashes")
    oracle._lib()  # raises here if there is no libzstd to hold against
    rnd = random.Random(1234)

    # Line coverage over the port's decode modules (sys.monitoring).
    from .. import decoder, fse_format, huffman_format, xxhash
    watch = {m.__file__ for m in (decoder, fse_format, huffman_format,
                                  xxhash)}
    seen: set[tuple[str, int]] = set()
    new_lines = [0]

    mon = sys.monitoring
    tool = 3  # a free slot (profilers use 2)
    mon.use_tool_id(tool, "qz-torch-decoder-fuzz")

    def on_line(code, line):
        f = code.co_filename
        if f not in watch:
            return mon.DISABLE
        key = (f, line)
        if key not in seen:
            seen.add(key)
            new_lines[0] += 1
        return None

    mon.register_callback(tool, mon.events.LINE, on_line)

    def run_one(frame: bytes):
        new_lines[0] = 0
        mon.set_events(tool, mon.events.LINE)
        try:
            port = port_decode(frame)
        finally:
            mon.set_events(tool, 0)
        return port, stock_decode(frame), new_lines[0]

    try:
        corpus: list[bytes] = []
        for sd in make_seeds():
            port, stock, _ = run_one(sd)
            bad = verdicts_agree(port, stock)
            if bad:
                p = _save(crash_dir, f"seed_{len(corpus)}.bin", sd)
                print(f"FINDING on seed: {bad} -> {p}")
                return 1
            corpus.append(sd)
        # the previous campaigns' corpus
        for fn in sorted(os.listdir(root)):
            p = os.path.join(root, fn)
            if os.path.isfile(p) and fn.endswith(".bin"):
                with open(p, "rb") as f:
                    corpus.append(f.read())

        deadline = time.monotonic() + seconds
        execs = adds = 0
        while time.monotonic() < deadline:
            frame = mutate(rnd, corpus[rnd.randrange(len(corpus))])
            port, stock, nl = run_one(frame)
            execs += 1
            bad = verdicts_agree(port, stock)
            if bad:
                p = _save(crash_dir, f"crash_{execs}.bin", frame)
                print(f"FINDING after {execs} execs: {bad} -> {p}")
                return 1
            if nl:
                corpus.append(frame)
                adds += 1
                with open(os.path.join(root, f"cov_{len(seen)}.bin"),
                          "wb") as f:
                    f.write(frame)
    finally:
        mon.register_callback(tool, mon.events.LINE, None)
        mon.free_tool_id(tool)
    print(f"OK decoder-differential execs={execs} corpus_adds={adds} "
          f"lines={len(seen)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
