"""The port's zstd codec (paimon_tpu_torch/utils/compression.py over
native/zstd.c) against libzstd, through `zstandard` and pyarrow.

Corpus: a seed-3 set of inputs from empty through 1 byte to 1.2 MiB
(several 128 KiB blocks), with text, integer columns, low-entropy bytes,
random bytes, runs of one byte, a random 300 KiB block repeated, so that
matches reach back across blocks, and random 4-byte tokens, whose blocks
hold more sequences than a 2-byte count can say. Each is compressed by `zstandard` at
levels -5, 1, 3, 9 and 19, with the content checksum on and off, and by its
stream writer, whose frames carry no content size; and by pyarrow's codec.
Every frame must decode to the input, byte for byte. The port's own frames
must decode in `zstandard` and in the port. Truncated frames must raise
ValueError; corrupted frames must raise ValueError or decode to what
`zstandard` decodes, never crash the process.
"""

import io
import pathlib
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from paimon_tpu_torch.utils.compression import ZSTD_MAGIC, zstd_compress, zstd_decompress

LEVELS = [-5, 1, 3, 9, 19]


def _corpus() -> dict[str, bytes]:
    rng = np.random.default_rng(3)
    words = rng.integers(0, 800, 40_000)
    text = " ".join(f"w{int(x)}-{int(x) % 7}" for x in words).encode()
    repeated = rng.integers(0, 256, 300 << 10, dtype=np.uint8).tobytes()
    # 256 words with distinct first bytes, each 1 KiB a new permutation of
    # them: almost every 4-byte match ends after 4 bytes
    words = (np.arange(256) | (rng.integers(0, 1 << 24, 256) << 8)).astype("<u4")
    rounds = np.stack([rng.permutation(256) for _ in range(300)])
    return {
        "empty": b"",
        "one_byte": b"x",
        "short_text": b"the quick brown fox jumps over the lazy dog " * 3,
        "text": text,
        "int64_column": (np.sort(rng.integers(0, 1 << 40, 40_000)) * 3).astype("<i8").tobytes(),
        "low_entropy": rng.integers(0, 6, 200_000, dtype=np.uint8).tobytes(),
        "random": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "one_byte_run": b"\x07" * 400_000,
        "window_spanning": repeated + rng.integers(0, 256, 1000, dtype=np.uint8).tobytes() + repeated,
        "large_mixed": text[:600_000] + rng.integers(0, 3, 650_000, dtype=np.uint8).tobytes(),
        # 4-byte matches back to back: over 0x7F00 sequences in one block
        "short_matches": words[rounds.reshape(-1)].tobytes(),
    }


CORPUS = _corpus()


def _stream_frame(data: bytes, level: int = 3) -> bytes:
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=level).stream_writer(buf, closefd=False) as w:
        w.write(data)
    return buf.getvalue()


def _zstandard_decode(frame: bytes) -> bytes:
    return zstandard.ZstdDecompressor().decompressobj().decompress(frame)


@pytest.mark.parametrize("checksum", [False, True], ids=["no_checksum", "checksum"])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", list(CORPUS))
def test_decompress_matches_zstandard(name, level, checksum):
    data = CORPUS[name]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert bytes(zstd_decompress(frame)) == data
    assert bytes(zstd_decompress(frame, len(data))) == data


@pytest.mark.parametrize("name", [n for n in CORPUS if CORPUS[n]])
def test_decompress_stream_frames_without_content_size(name):
    data = CORPUS[name]
    frame = _stream_frame(data)
    assert zstandard.get_frame_parameters(frame).content_size == zstandard.CONTENTSIZE_UNKNOWN
    assert bytes(zstd_decompress(frame)) == data


@pytest.mark.parametrize("name", [n for n in CORPUS if CORPUS[n]])
def test_decompress_pyarrow_frames(name):
    data = CORPUS[name]
    for level in (1, 3):
        frame = pa.Codec("zstd", compression_level=level).compress(data, asbytes=True)
        assert bytes(zstd_decompress(frame, len(data))) == data


@pytest.mark.parametrize("name", list(CORPUS))
def test_port_frames_decode_in_zstandard_and_the_port(name):
    data = CORPUS[name]
    frame = zstd_compress(data)
    assert frame[:4] == ZSTD_MAGIC
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == len(data) and not params.has_checksum
    assert _zstandard_decode(frame) == data
    assert bytes(zstd_decompress(frame)) == data
    if len(data) > 1000 and name != "random":
        assert len(frame) < len(data)  # real compression, not only raw blocks


def test_skippable_and_concatenated_frames():
    a, b = CORPUS["text"][:5000], CORPUS["low_entropy"][:7000]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    frames = skippable + zstandard.ZstdCompressor(level=3).compress(a) + skippable + zstd_compress(b)
    assert bytes(zstd_decompress(frames)) == a + b
    assert bytes(zstd_decompress(frames, len(a) + len(b))) == a + b
    with pytest.raises(ValueError):
        zstd_decompress(frames + _stream_frame(a)[:-3])  # a truncated third frame


def test_frame_with_a_dictionary_raises():
    frame = zstandard.ZstdCompressor(level=3).compress(b"hello hello hello")
    assert frame[4] & 3 == 0
    with_dict = frame[:4] + bytes([frame[4] | 1, 7]) + frame[5:]  # dictionary ID 7
    with pytest.raises(ValueError, match="dictionary"):
        zstd_decompress(with_dict)


def test_wrong_expected_size_raises():
    data = CORPUS["text"][:10_000]
    frame = zstandard.ZstdCompressor(level=1).compress(data)
    with pytest.raises(ValueError):
        zstd_decompress(frame, len(data) + 1)
    with pytest.raises(ValueError):
        zstd_decompress(_stream_frame(data), len(data) - 1)


@pytest.mark.parametrize("bad", [b"", b"\x28\xb5\x2f", b"not a frame at all"])
def test_garbage_raises(bad):
    with pytest.raises(ValueError):
        zstd_decompress(bad)


def test_compress_has_one_strength():
    data = CORPUS["text"][:20_000]
    assert {zstd_compress(data, level=level) for level in (-5, 1, 3, 19, 22)} == {zstd_compress(data)}


_FRAMES = [
    zstandard.ZstdCompressor(level=level, write_checksum=ck).compress(CORPUS[name][:40_000])
    for name, level, ck in (("text", 3, True), ("low_entropy", 19, False), ("int64_column", 1, True),
                            ("short_text", -5, False), ("window_spanning", 9, False))
] + [_stream_frame(CORPUS["text"][:30_000]), zstd_compress(CORPUS["large_mixed"][:50_000])]


@settings(max_examples=150, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(frame=st.sampled_from(_FRAMES), cut=st.integers(min_value=1))
def test_truncated_frames_raise(frame, cut):
    with pytest.raises(ValueError):
        zstd_decompress(frame[: len(frame) - 1 - cut % len(frame)])


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(frame=st.sampled_from(_FRAMES), edits=st.lists(st.tuples(st.integers(0), st.integers(1, 255)), min_size=1,
                                                      max_size=4))
def test_corrupted_frames_raise_or_agree_with_zstandard(frame, edits):
    buf = bytearray(frame)
    for pos, flip in edits:
        buf[pos % len(buf)] ^= flip
    try:
        got = bytes(zstd_decompress(bytes(buf)))
    except ValueError:
        return
    try:
        want = _zstandard_decode(bytes(buf))
    except zstandard.ZstdError:
        return  # libzstd is stricter here; the port decoded within its bounds
    assert got == want


# ---------------------------------------------------------------------------
# the build: no compiler or a failed build raises; parallel builds agree
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    from paimon_tpu_torch import native

    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_LIB", None)
    return native


def test_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(fresh_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="compiler"):
        zstd_compress(b"abc")
    with pytest.raises(RuntimeError, match="compiler"):
        zstd_decompress(zstandard.ZstdCompressor().compress(b"abc"))


def test_failed_build_raises_with_the_compiler_output(fresh_build, monkeypatch, tmp_path):
    broken = tmp_path / "zstd.c"
    broken.write_text("int pz_compress(void) { return missing_symbol; }\n")
    monkeypatch.setattr(fresh_build, "_SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="missing_symbol"):
        fresh_build.zstd_library()


def test_parallel_processes_build_one_library(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library, and only the published library remains."""
    build = tmp_path / "_build"
    code = (
        "import sys\n"
        "from paimon_tpu_torch import native\n"
        f"native._BUILD = {str(build)!r}\n"
        "from paimon_tpu_torch.utils.compression import zstd_compress, zstd_decompress\n"
        "data = bytes(range(256)) * 100\n"
        "assert bytes(zstd_decompress(zstd_compress(data))) == data\n"
    )
    repo = pathlib.Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert sorted(p.suffix for p in build.iterdir()) == [".lock", ".so"]
