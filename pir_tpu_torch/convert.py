"""Carry state across from the JAX package (``pir_tpu``) as numpy arrays.

Residues in ``pir_tpu`` are u64 arrays; here they are int64 tensors with the
same bits.  Nothing in this module imports JAX: callers hand over numpy
arrays (``np.asarray`` of a JAX array).
"""

from __future__ import annotations

import numpy as np
import torch

from pir_tpu_torch.core.params import PirParams
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.pir.database import PirDatabase


# u64 numpy array <-> int64 tensor with the same bits
to_tensor = tensor_u64
to_numpy = numpy_u64


def galois_keys_from_numpy(keys: dict, device=None) -> "dict[int, torch.Tensor]":
    """{galois_elt: u64[L, 2, Lp, N]} -> {galois_elt: int64 tensor}, the
    key form ``ops.expand``/``ops.keyswitch`` and ``PirServer.process_query``
    take."""
    return {int(e): tensor_u64(np.asarray(v), device) for e, v in keys.items()}


def relin_key_from_numpy(key, device=None) -> torch.Tensor:
    """u64[L, 2, Lp, N] (``pir_tpu``'s ``RelinKeys.key.data``) -> the int64
    tensor ``ops.keyswitch.relinearize``, ``ops.scan.database_scan_ctmult``
    and ``PirServer.process_query`` take."""
    return tensor_u64(np.asarray(key), device)


def database_from_plaintexts(
    params: PirParams, db_pts_u64: np.ndarray, device=None, scan_impl: str = "auto"
) -> PirDatabase:
    """A PirDatabase from already-encoded plaintexts u64[num_pt, N]
    (e.g. ``pir_tpu.PirDatabase.db_pts``), on `device` (the card by
    default), in either mode of `params`."""
    pts = np.asarray(db_pts_u64, dtype=np.uint64)
    if pts.shape != (params.num_pt, params.encryption_params.poly_modulus_degree):
        raise ValueError(f"plaintexts of shape {pts.shape} do not match params")
    db = PirDatabase(params, scan_impl=scan_impl, device=device)
    db._finalize(pts)
    return db
