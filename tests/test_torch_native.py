"""pir_tpu_torch.native, the g++ bulk encoder, against pir_tpu.native and
against the plain packer pir_tpu_torch.pir.database.pack_items, at every
width 1..62 bits a coefficient; its build (a failed one raises with the
compiler's output); and the database's packer (database.pack_rows).

The encoder source is pir_tpu's, byte for byte (test_torch_copies.py).  Its
64-bit bit accumulator overflows at 59, 61 and 62 bits a coefficient, where
pir_tpu's copy returns words that are not the reference's plaintexts: the
port's pack_db refuses those widths and the database packs them with
pack_items."""

import time

import numpy as np
import pytest

from pir_tpu import native as jnative
from pir_tpu.pir.encoders import StringEncoder as JEncoder
from pir_tpu_torch import native
from pir_tpu_torch.pir import database

BAD_WIDTHS = (59, 61, 62)
ITEM_BYTES, PLAINTEXTS = 97, 5


@pytest.fixture(scope="module")
def reference_encoder():
    """pir_tpu's native module with its library loaded.  pir_tpu builds
    the library in place at first use, so another test process's build
    can be half written when this one first loads it: load again until
    the build has finished."""
    for _ in range(100):
        if jnative.available():
            return jnative
        jnative._tried = False
        time.sleep(0.2)
    pytest.fail("pir_tpu's native encoder did not load")


def _buffer(bits):
    rng = np.random.default_rng(bits)
    return rng.integers(0, 256, PLAINTEXTS * ITEM_BYTES, dtype=np.uint8).tobytes()


def _ring(bits):
    return 1 << (-(-ITEM_BYTES * 8 // bits)).bit_length()


@pytest.mark.parametrize("bits", range(1, 63))
def test_pack_db_equals_pir_tpu_and_pack_items(reference_encoder, bits):
    buf, n = _buffer(bits), _ring(bits)
    plain = database.pack_items(buf, PLAINTEXTS, ITEM_BYTES, bits, n)
    theirs = reference_encoder.pack_db(buf, PLAINTEXTS, ITEM_BYTES, bits, n)
    assert np.array_equal(database.pack_rows(buf, PLAINTEXTS, ITEM_BYTES, bits, n), plain)
    if bits in BAD_WIDTHS:
        assert not native.exact(bits)
        assert not np.array_equal(theirs, plain)  # pir_tpu's encoder loses bits here
        with pytest.raises(ValueError, match="accumulator"):
            native.pack_db(buf, PLAINTEXTS, ITEM_BYTES, bits, n)
        return
    assert native.exact(bits)
    assert np.array_equal(native.pack_db(buf, PLAINTEXTS, ITEM_BYTES, bits, n), plain)
    assert np.array_equal(theirs, plain)


@pytest.mark.parametrize("bits", [7, 20, 59])
def test_pack_rows_is_the_reference_encoding(bits):
    """Row by row, the database's packer gives StringEncoder.encode_many's
    plaintext (the reference's string encoder), exact widths and not."""
    buf, n = _buffer(bits), _ring(bits)
    pts = database.pack_rows(buf, PLAINTEXTS, ITEM_BYTES, bits, n)
    enc = JEncoder(n, (1 << 61) - 1, bits)
    for p in range(PLAINTEXTS):
        item = buf[p * ITEM_BYTES : (p + 1) * ITEM_BYTES]
        assert np.array_equal(pts[p], np.asarray(enc.encode_many([item]), dtype=np.uint64))


def test_pack_db_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="buffer size"):
        native.pack_db(b"\0" * 10, 2, 6, 8, 64)
    with pytest.raises(ValueError, match="code 2"):  # more coefficients than the ring
        native.pack_db(b"\0" * 200, 1, 200, 8, 64)
    with pytest.raises(ValueError, match="code 1"):
        native.pack_db(b"\0" * 8, 1, 8, 63, 64)


def test_build_is_cached_by_source_hash(tmp_path):
    src = tmp_path / "enc.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    so = native.build(src, tmp_path / "out")
    assert so.exists() and so.parent == tmp_path / "out"
    assert native.build(src, tmp_path / "out") == so
    src.write_text(src.read_text() + "\n// edited\n")
    assert native.build(src, tmp_path / "out") != so


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int pack_db( { return }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken.cpp") as err:
        native.build(bad, tmp_path / "out")
    assert "error" in str(err.value)
    # the loader raises the same way: no quiet fallback to numpy
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "out")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.pack_db(b"\0" * 8, 1, 8, 8, 64)
