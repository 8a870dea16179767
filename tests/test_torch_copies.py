"""pir_tpu_torch's copies of pir_tpu's JAX-free modules stay equal to their
originals, and importing the port never imports JAX.

The port cannot import those modules from pir_tpu: any pir_tpu import runs
pir_tpu/__init__.py, which imports JAX.  So it keeps copies, and these
tests hold each copy to its original — textually (up to the package name)
and by behaviour.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from pir_tpu.core import params as j_params
from pir_tpu.core import primes as j_primes
from pir_tpu.pir import encoders as j_encoders
from pir_tpu_torch.core import params as t_params
from pir_tpu_torch.core import primes as t_primes
from pir_tpu_torch.pir import encoders as t_encoders

REPO = pathlib.Path(__file__).resolve().parents[1]

COPIED = [
    "utils/math.py",
    "core/primes.py",
    "core/params.py",
    "pir/encoders.py",
    "bfv/sampling.py",
    "pir/seal_compat.py",
]


@pytest.mark.parametrize("path", COPIED)
def test_copy_matches_original_source(path):
    original = (REPO / "pir_tpu" / path).read_text()
    copy = (REPO / "pir_tpu_torch" / path).read_text()
    assert copy == original.replace("pir_tpu.", "pir_tpu_torch.")


def test_native_encoder_source_is_a_byte_copy():
    original = (REPO / "pir_tpu" / "native" / "encoder.cpp").read_bytes()
    assert (REPO / "pir_tpu_torch" / "native" / "encoder.cpp").read_bytes() == original


def _function_source(path: pathlib.Path, name: str) -> str:
    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(text, node)


@pytest.mark.parametrize("name", ["hi_dtype_for", "split_host", "join_host"])
def test_packing_host_function_matches_original(name):
    """ops/packing.py's original imports jax.numpy, so the port copies its
    host functions, not the file."""
    path = pathlib.Path("ops") / "packing.py"
    assert _function_source(REPO / "pir_tpu_torch" / path, name) == _function_source(
        REPO / "pir_tpu" / path, name)


def test_proto_copy_matches_original():
    proto = (REPO / "pir_tpu" / "proto" / "payload.proto").read_text()
    assert (REPO / "pir_tpu_torch" / "proto" / "payload.proto").read_text() == proto
    gen = (REPO / "pir_tpu" / "proto" / "payload_pb2.py").read_text()
    copy = (REPO / "pir_tpu_torch" / "proto" / "payload_pb2.py").read_text()
    assert copy == gen.replace(
        "'pir_tpu.proto.payload_pb2'", "'pir_tpu_torch.proto.payload_pb2'"
    )


def test_proto_messages_interchange():
    from pir_tpu.proto import payload_pb2 as j_pb
    from pir_tpu_torch.proto import payload_pb2 as t_pb

    req = j_pb.Request()
    req.query.add().ct.append(b"abc")
    req.galois_keys = b"keys"
    back = t_pb.Request.FromString(req.SerializeToString())
    assert back.SerializeToString() == req.SerializeToString()


@pytest.mark.parametrize(
    "args",
    [
        dict(dbsize=1 << 20, bytes_per_item=288, dimensions=2),
        dict(dbsize=1 << 16, bytes_per_item=288, dimensions=2),
        dict(dbsize=1000, bytes_per_item=0, dimensions=1),
        dict(dbsize=5000, bytes_per_item=100, dimensions=3, reencode_digits="legacy"),
    ],
)
def test_params_derivation_equal(args):
    for n, t_bits in ((4096, 24), (8192, 20)):
        je = j_params.generate_encryption_params(n, t_bits)
        te = t_params.generate_encryption_params(n, t_bits)
        assert je.to_dict() == te.to_dict()
        jp = j_params.create_pir_parameters(enc_params=je, **args)
        tp = t_params.create_pir_parameters(enc_params=te, **args)
        assert dataclass_fields(jp) == dataclass_fields(tp)


def dataclass_fields(p):
    d = dict(vars(p))
    d["encryption_params"] = p.encryption_params.to_dict()
    return d


def test_tpu32_profile_equal():
    assert j_primes.tpu_coeff_modulus(4096) == t_primes.tpu_coeff_modulus(4096)
    assert j_primes.primitive_root_2n(
        0xFFFFEE001, 8192
    ) == t_primes.primitive_root_2n(0xFFFFEE001, 8192)


@pytest.mark.parametrize("bits_per_coeff", [0, 7, 13])
def test_string_encoder_equal(bits_per_coeff):
    rng = np.random.default_rng(11)
    t = j_primes.batching_prime(256, 20)
    je = j_encoders.StringEncoder(256, t, bits_per_coeff)
    te = t_encoders.StringEncoder(256, t, bits_per_coeff)
    items = [rng.integers(0, 256, 37, dtype=np.uint8).tobytes() for _ in range(5)]
    pt = je.encode_many(items)
    assert np.array_equal(pt, te.encode_many(items))
    assert je.decode(pt, 37, 74) == te.decode(pt, 37, 74)


def test_import_leaves_jax_out():
    code = (
        "import sys, pir_tpu_torch, pir_tpu_torch.convert, pir_tpu_torch.kernels,"
        " pir_tpu_torch.profile_request, pir_tpu_torch.scan_wide_variants,"
        " pir_tpu_torch.parallel.sharded, pir_tpu_torch.pir.seal_compat,"
        " pir_tpu_torch.parallel.distributed, pir_tpu_torch.parallel.mesh_worker,"
        " pir_tpu_torch.utils.profiling, pir_tpu_torch.examples.basic_pir,"
        " pir_tpu_torch.native, pir_tpu_torch.ops.packing, pir_tpu_torch.memory_peaks,"
        " pir_tpu_torch.examples.streamed_serving, chip_smoke;"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m);"
        "bad = [m for m in sys.modules if m == 'pir_tpu' or m.startswith('pir_tpu.')];"
        "assert not bad, bad"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
