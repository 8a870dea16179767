"""Start the process group a mesh of ranks runs in, and move data to it.

Port of ``pir_tpu/parallel/distributed.py``.  Each rank is one process; the
caller says where the group meets (``init_method``: ``file://`` or
``tcp://host:port``), how many ranks there are, which one this is, and the
backend — nothing here reads a cluster's environment or picks a backend
behind the caller's back:

* ``nccl`` — one rank per card; two ranks on one card are refused (NCCL
  cannot run them), with the reason;
* ``gloo`` — ranks that share a card, or the CPU; a CUDA tensor is copied
  to the host for each collective and back (parallel/sharded.Mesh).

Usage on every rank::

    from pir_tpu_torch.parallel import distributed, sharded
    distributed.init_distributed("tcp://localhost:29500", world, rank,
                                 backend="nccl", device=f"cuda:{rank}")
    mesh = distributed.global_mesh(batch=1, limb=2)
    server = PirServer(db, params, mesh=mesh)      # every rank, same db
    response = server.process_request(request)     # every rank, same request

A rank can instead load only its own rows (the shard files of
``PirDatabase.ingest_shards``) and build only its block of the planes::

    db = PirDatabase(params, scan_impl="pallas")
    shard = mesh.coord("db")
    r0, r1 = shard_row_ranges(params, mesh.size("db"))[shard]   # r1 > r0 here
    rows = PirDatabase.load_shard_rows(shard_dir, shard)[: r1 - r0]
    db.set_rank_planes(planes_from_shard_rows(params, db.ctx, rows, mesh, r0))
    server = PirServer(db, params, mesh=mesh)

(``mesh_worker``'s ``"shard_dir"`` case also serves a shard past the last
plaintext, which holds padding only.)
"""

from __future__ import annotations

import datetime
import socket

import numpy as np
import torch
import torch.distributed as dist

from pir_tpu_torch.ops.modular import resolve_device, tensor_u64
from pir_tpu_torch.parallel import sharded
from pir_tpu_torch.pir import database


def _device_identity(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def init_distributed(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str,
    device=None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join the default process group; returns this rank's device.

    device: the rank's device (the current card by default; "cpu" for CPU
    ranks under gloo).  Every collective of the group gives up after
    timeout_s seconds instead of waiting forever.
    """
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("nccl needs a CUDA device on every rank")
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(
        dist.rendezvous(init_method, rank, world_size, timeout=timeout)
    )
    store.set_timeout(timeout)
    if backend == "nccl":
        # NCCL cannot put two ranks of one communicator on one card: find
        # such ranks through the store before NCCL fails obscurely
        ids = dist.PrefixStore("pir_tpu_torch/devices", store)
        ids.set(str(rank), _device_identity(device))
        seen = {}
        for r in range(world_size):
            ident = ids.get(str(r)).decode()
            if ident in seen:
                raise ValueError(
                    f"ranks {seen[ident]} and {r} share the card {ident}: nccl "
                    "takes one rank per card; use backend='gloo' for ranks "
                    "that share a card"
                )
            seen[ident] = r
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size, timeout=timeout,
        device_id=device if backend == "nccl" else None,
    )
    return device


def global_mesh(batch: int = 1, limb: int = 1) -> sharded.Mesh:
    """(db, batch[, limb]) mesh over every rank of the process group, db
    outermost — the one collective that crosses hosts, the db-axis
    all_reduce of partial replies, then spans them while batch and limb
    lines stay inside a host when ranks are numbered host by host."""
    return sharded.default_mesh(batch=batch, limb=limb)


def replicate_to_mesh(x, mesh: sharded.Mesh, device=None) -> torch.Tensor:
    """Rank 0's value of x on every rank: a broadcast over the whole group.

    x: a tensor or numpy array of the same shape and dtype on every rank
    (numpy u64 arrays cross as int64 bit patterns).  Returns a tensor on
    `device` (x's device by default)."""
    del mesh  # the broadcast spans the whole process group
    if isinstance(x, np.ndarray):
        arr = x.view(np.int64) if x.dtype == np.uint64 else x
        x = torch.from_numpy(np.ascontiguousarray(arr))
    target = x.device if device is None else torch.device(device)
    t = x.contiguous()
    if dist.get_backend() == "gloo" and t.is_cuda:
        t = t.cpu()
    elif dist.get_backend() == "nccl":
        t = t.to(torch.cuda.current_device())
    else:
        t = t.clone()
    dist.broadcast(t, src=0)
    return t.to(target)


def planes_from_shard_rows(params, ctx, local_pts, mesh: sharded.Mesh, row_start: int):
    """This rank's block of the db_planes operand from its own plaintext
    rows only: (hi, lo) [prefix_local, L_local, inner, N], its D0 block and,
    on a limb axis, its limbs — what ``make_sharded_pipeline`` takes with
    ``local_planes=True`` (``PirDatabase.set_rank_planes``).

    local_pts: u64 [rows, N], the contiguous plaintext rows of this rank's
    db block, starting at global row `row_start` (rows past params.num_pt
    are zeros and may be left out): ``PirDatabase.load_shard_rows`` of
    shard ``mesh.coord("db")`` of an ``ingest_shards`` checkpoint with
    ``mesh.size("db")`` shards.  The rows go through the NTT (of this
    rank's limbs only) a few prefixes at a time."""
    n_db = mesh.size("db")
    inner = params.dimensions[-1]
    rows = database.shard_rows(params, n_db)
    if rows % inner:
        raise ValueError("a rank's rows must align to the inner dimension")
    expected = mesh.coord("db") * rows
    if row_start != expected:
        raise ValueError(
            f"row_start {row_start} is not this rank's range (expected {expected})"
        )
    if local_pts.shape[0] > rows:
        raise ValueError("more local rows than this rank's range")
    l_local = ctx.L // mesh.size("limb")
    lo = mesh.coord("limb") * l_local
    ntt = ctx.ntt_q.limb_range(lo, lo + l_local)
    step = database.NTT_PREFIXES * inner

    def steps():
        for r0 in range(0, rows, step):
            chunk = np.zeros((min(step, rows - r0), ctx.n), dtype=np.uint64)
            have = local_pts[r0 : r0 + step]
            chunk[: have.shape[0]] = have
            pt = tensor_u64(chunk, ctx.device)
            yield r0, ntt.forward(pt[:, None, :].expand(-1, l_local, ctx.n))

    return database.rows_to_planes(ctx, l_local, inner, rows, steps())
