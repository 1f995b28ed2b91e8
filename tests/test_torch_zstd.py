"""The port's Zstandard decoder (tpurast_torch/native/zstd.cpp through
assets/zstd.py) against the zstandard package, byte for byte.

  * payloads: BC7, BC4 and BC6H block data (the port's encoders on seeded
    images), text-like and random bytes, and an empty one; compressed at
    levels 1, 3, 9 and 19, with and without a checksum and a content size;
    the BC7 payload spans three 128 KiB blocks;
  * a frame streamed without a content size, decoded into its exact
    capacity and refused one byte short; concatenated frames with a
    skippable frame between them;
  * stored frames (ktx2_write.zstd_frame_stored) decode to their input
    through both decoders, at sizes around each content-size field width
    and the 128 KiB block limit;
  * truncated and bit-flipped frames raise Ktx2Error and never crash
    (hypothesis, a bounded number of examples; the same inputs run under
    AddressSanitizer in tests/test_torch_memsafety.py);
  * the committed fixtures under tests/data/zstd/ (made with zstandard at
    levels 3 and 19 by ``python tests/test_torch_zstd.py --write-fixtures``)
    hold Huffman literals (one and four streams, treeless), FSE, repeat and
    predefined sequence tables, and decode to the content their SHA256SUMS
    name: chip_smoke.py decodes the same files on the GPU machine's g++ build;
  * parse_ktx2 of scheme-2 blobs equals the reference's (which inflates with
    zstandard) field for field, and a wrong level length raises.

Time on one worker: about 10 s.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pathlib
import sys

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tpurast.assets import ktx2 as ref_ktx2  # noqa: E402
from tpurast.assets import ktx2_write as ref_ktx2_write  # noqa: E402
from tpurast_torch.assets import ktx2, ktx2_write, native, zstd  # noqa: E402
from tpurast_torch.assets.ktx2 import Ktx2Error  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "data" / "zstd"
LEVELS = (1, 3, 9, 19)
WORDS = ("the of and to in texture mip level block zstd frame huffman literal sequence offset window match "
         "render tile pixel").split()


def _image(seed: int, size: int, channels: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size]
    base = ((x // 8 + y // 8) % 2) * 120 + 60
    img = base[..., None] + rng.integers(-40, 41, (size, size, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


def payloads() -> dict[str, bytes]:
    """The payloads, made from seeds."""
    rng = np.random.default_rng(3)
    hdr = _image(4, 64, 3).astype(np.float32) / 16.0
    hdr[7, 9] = 65504.0
    text = " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), 12000)).encode()
    return {
        "bc7": ktx2_write.encode_bc7_mode6(_image(1, 512, 4)),  # 256 KiB: three blocks
        "bc4": ktx2_write.encode_bc4(_image(2, 256, 1)[..., 0]),
        "bc6h": ktx2_write.encode_bc6h_mode3(hdr),
        "text": text,
        "random": rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
        "empty": b"",
    }


_PAYLOADS = payloads()


def zstandard_output(blob: bytes) -> bytes:
    """What the zstandard package decodes from every frame of blob (its
    one-shot decompress needs a content size or a nonzero capacity)."""
    return zstandard.ZstdDecompressor().stream_reader(blob, read_across_frames=True).read()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(_PAYLOADS))
def test_decoder_matches_zstandard(name, level):
    data = _PAYLOADS[name]
    for checksum in (False, True):
        for content_size in (False, True):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=content_size).compress(data)
            want = zstandard_output(frame)
            assert zstd.decompress(frame, len(data)) == want == data, (checksum, content_size)


def test_streamed_frame_without_content_size():
    data = _PAYLOADS["text"] * 3
    c = zstandard.ZstdCompressor(level=3).compressobj()
    frame = c.compress(data) + c.flush()
    assert zstandard.get_frame_parameters(frame).content_size == zstandard.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(frame, len(data)) == data
    with pytest.raises(Ktx2Error, match="capacity"):
        zstd.decompress(frame, len(data) - 1)


def test_concatenated_and_skippable_frames():
    parts = [_PAYLOADS["bc4"], _PAYLOADS["text"][:5000], _PAYLOADS["bc6h"]]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"skip!"
    frames = [zstandard.ZstdCompressor(level=lvl).compress(p) for lvl, p in zip((1, 19, 3), parts)]
    blob = frames[0] + skip + frames[1] + frames[2]
    want = zstandard_output(blob)
    assert zstd.decompress(blob, sum(map(len, parts))) == want == b"".join(parts)


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65791, 65792, 131072, 131073, 300000])
def test_stored_frames_round_trip(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    frame = ktx2_write.zstd_frame_stored(data)
    assert zstd.decompress(frame, size) == data
    assert zstandard_output(frame) == data
    assert zstandard.get_frame_parameters(frame).content_size == size


def _frames_for_fuzz() -> list[bytes]:
    data = _PAYLOADS["text"][:20000] + _PAYLOADS["bc7"][:20000]
    return [zstandard.ZstdCompressor(level=lvl, write_checksum=True).compress(data) for lvl in (3, 19)]


_FUZZ = _frames_for_fuzz()


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(st.data())
def test_corrupt_and_truncated_frames_raise(data):
    frame = bytearray(data.draw(st.sampled_from(_FUZZ)))
    if data.draw(st.booleans()):
        del frame[data.draw(st.integers(0, len(frame) - 1)):]
    else:
        for _ in range(data.draw(st.integers(1, 3))):
            i = data.draw(st.integers(0, len(frame) - 1))
            frame[i] ^= 1 << data.draw(st.integers(0, 7))
    try:
        out = zstd.decompress(bytes(frame), 40000)
    except Ktx2Error:
        return
    # A flip the format ignores (an unused header bit, a flag no reader
    # needs) may leave a valid frame: then the content is intact.
    assert out == _PAYLOADS["text"][:20000] + _PAYLOADS["bc7"][:20000]


def test_bad_input_errors_name_their_cause():
    good = _FUZZ[0]
    cases = {
        "magic": b"\0\0\0\0" + good[4:],
        "truncated": good[:2],
        # Single segment, a 1-byte dictionary id of 7, a 1-byte content size.
        "dictionary": bytes([0x28, 0xB5, 0x2F, 0xFD, 0x21, 0x07, 0x05]) + good[7:],
        "checksum": good[:-1] + bytes([good[-1] ^ 1]),
    }
    for want, blob in cases.items():
        with pytest.raises(Ktx2Error, match=want):
            zstd.decompress(blob, 40000)
    with pytest.raises(Ktx2Error):
        zstd.decompress(b"", 10)


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.BuildError, match="error"):
        native.compile_library(bad, "bad")
    assert not list((tmp_path / "build").glob("*"))  # no library, no temporary file left


# ------------------------------------------------------------------ fixtures


def fixture_payloads() -> dict[str, bytes]:
    """The committed fixtures' contents: a log-like text over three blocks
    (level 19 reuses its Huffman and FSE tables: treeless literals, repeat
    modes), words (one Huffman stream), BC7 and BC6H blocks, and a short
    string (raw literals, predefined tables)."""
    rng = np.random.default_rng(0)
    log = "".join(f"{i:06d} {WORDS[i % 7]} level={i % 12} offset={(i * 2654435761) % 65536} "
                  f"{WORDS[rng.integers(0, len(WORDS))]}\n" for i in range(4000)).encode()
    words = " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), 9000)).encode()
    return {
        "log_l19": (log, 19),
        "words_l19": (words, 19),
        "bc7_l3": (ktx2_write.encode_bc7_mode6(_image(5, 128, 4)), 3),
        "bc6h_l19": (ktx2_write.encode_bc6h_mode3(_image(6, 64, 3).astype(np.float32) / 8.0), 19),
        "short_l3": (b"abcabcabcabcabcabd" * 3 + bytes(range(40)), 3),
    }


def write_fixtures(out: pathlib.Path = FIXTURES) -> None:
    out.mkdir(parents=True, exist_ok=True)
    sums = []
    for name, (data, level) in fixture_payloads().items():
        (out / f"{name}.zst").write_bytes(zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data))
        sums.append(f"{hashlib.sha256(data).hexdigest()}  {name}.zst")
    (out / "SHA256SUMS").write_text("\n".join(sums) + "\n")


def read_sums() -> dict[str, str]:
    return {name: digest for digest, name in (line.split() for line in (FIXTURES / "SHA256SUMS").read_text().splitlines())}


def frame_kinds(frame: bytes) -> set:
    """What a frame's blocks use: block types, literals (type, streams),
    Huffman weights' coding and each sequence table's mode."""
    kinds, ip = set(), 0
    while ip < len(frame):
        fhd = frame[ip + 4]
        single = fhd >> 5 & 1
        ip += 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3] + ((1 if single else 0), 2, 4, 8)[fhd >> 6]
        last = 0
        while not last:
            bh = int.from_bytes(frame[ip : ip + 3], "little")
            ip += 3
            last, btype, size = bh & 1, bh >> 1 & 3, bh >> 3
            kinds.add(("block", ("raw", "rle", "compressed")[btype]))
            if btype == 2:
                b = frame[ip : ip + size]
                lt, sf = b[0] & 3, b[0] >> 2 & 3
                if lt < 2:
                    hs = (1, 2, 1, 3)[sf]
                    regen = b[0] >> 3 if hs == 1 else (b[0] >> 4) + (b[1] << 4) + (b[2] << 12 if hs == 3 else 0)
                    off = hs + (regen if lt == 0 else 1)
                    kinds.add(("literals", ("raw", "rle")[lt]))
                else:
                    hs, bits = (3, 3, 4, 5)[sf], (10, 10, 14, 18)[sf]
                    off = hs + (int.from_bytes(b[:hs], "little") >> (4 + bits) & ((1 << bits) - 1))
                    kinds.add(("literals", ("huffman", "treeless")[lt - 2], 1 if sf == 0 else 4))
                    if lt == 2:
                        kinds.add(("weights", "fse" if b[hs] < 128 else "direct"))
                n, p = b[off], off + 1
                if n:
                    p += 0 if n < 128 else 1 if n < 255 else 2
                    for shift, table in ((6, "ll"), (4, "of"), (2, "ml")):
                        kinds.add(("seq", table, ("predefined", "rle", "fse", "repeat")[b[p] >> shift & 3]))
            ip += size if btype != 1 else 1
        ip += 4 if fhd >> 2 & 1 else 0
    return kinds


def test_fixtures_decode_to_their_digests():
    sums = read_sums()
    files = sorted(FIXTURES.glob("*.zst"))
    assert {p.name for p in files} == set(sums)
    assert sum(p.stat().st_size for p in files) <= 64 * 1024
    for p in files:
        frame = p.read_bytes()
        want = zstandard_output(frame)
        got = zstd.decompress(frame, len(want))
        assert got == want and hashlib.sha256(got).hexdigest() == sums[p.name], p.name


def test_fixtures_hold_the_compressed_paths():
    kinds = set().union(*(frame_kinds(p.read_bytes()) for p in FIXTURES.glob("*.zst")))
    for k in [("literals", "huffman", 1), ("literals", "huffman", 4), ("literals", "treeless", 4),
              ("literals", "raw"), ("weights", "fse")] + [
              ("seq", t, m) for t in ("ll", "of", "ml") for m in ("fse", "repeat", "predefined")]:
        assert k in kinds, k


# ------------------------------------------------------------------ KTX2


@pytest.mark.parametrize("vk_format", sorted(ref_ktx2.BLOCK_FORMATS))
def test_parse_ktx2_scheme2_matches_reference(vk_format):
    rng = np.random.default_rng(vk_format)
    block = 8 if vk_format == ref_ktx2.VK_FORMAT_BC4_UNORM_BLOCK else 16
    sizes = [(64, 32), (32, 16), (16, 8), (8, 4), (4, 2), (2, 1), (1, 1)]
    counts = [(-(-w // 4)) * (-(-h // 4)) * block for w, h in sizes]
    payloads = [np.repeat(rng.integers(0, 256, n // 4 + 1, dtype=np.uint8), 4)[:n].tobytes() for n in counts]
    for blob in (ref_ktx2_write.write_ktx2(payloads, vk_format, 64, 32),
                 ktx2_write.write_ktx2(payloads, vk_format, 64, 32, stored=True)):
        got, want = ktx2.parse_ktx2(blob), ref_ktx2.parse_ktx2(blob)
        assert got.supercompression == ktx2.SUPERCOMPRESSION_ZSTD
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "levels":
                assert [dataclasses.asdict(x) for x in a] == [dataclasses.asdict(x) for x in b]
            else:
                assert a == b, f.name
        assert [lv.data for lv in got.levels] == payloads


def test_inflate_refuses_a_wrong_level_length():
    data = _PAYLOADS["bc4"]
    frame = zstandard.ZstdCompressor(level=3).compress(data)
    with pytest.raises(Ktx2Error):
        ktx2._inflate(frame, ktx2.SUPERCOMPRESSION_ZSTD, len(data) - 1)
    with pytest.raises(Ktx2Error, match="expected"):
        ktx2._inflate(frame, ktx2.SUPERCOMPRESSION_ZSTD, len(data) + 1)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixtures"]:
        sys.exit("usage: python tests/test_torch_zstd.py --write-fixtures")
    write_fixtures()
