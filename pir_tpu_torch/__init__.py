"""pir_tpu_torch — the SealPIR server of ``pir_tpu`` in PyTorch, on CUDA.

A port of ``pir_tpu`` (the JAX reference, which stays beside it) to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a):

* residues are ``torch.int64`` tensors holding u64 bit patterns (every
  modulus is below 2^61), ciphertexts ``[size, L, N]`` limb-major;
* the server's hot path — oblivious query expansion, the NTTs and the
  ciphertext×database scan — runs on the tensors' device; on a CUDA device
  the NTT and the scan are kernels A and B (``csrc/``), built with ``nvcc``
  at first use;
* the client↔server contract is ``pir_tpu``'s protobuf schema and native
  payload codecs, byte for byte.

Importing this package imports ``torch``, never ``jax``.
"""

from pir_tpu_torch.core.params import (
    EncryptionParams,
    PirParams,
    create_pir_parameters,
    generate_encryption_params,
)
from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.pir.client import PirClient
from pir_tpu_torch.pir.database import PirDatabase
from pir_tpu_torch.pir.server import PirServer, reply_limbs_for

__all__ = [
    "EncryptionParams",
    "PirParams",
    "PirContext",
    "PirClient",
    "PirServer",
    "PirDatabase",
    "generate_encryption_params",
    "create_pir_parameters",
    "reply_limbs_for",
]

__version__ = "0.1.0"
