"""Multi-rank serving: expansion + database scan sharded over a mesh of ranks.

Port of ``pir_tpu/parallel/sharded.py``.  Where ``pir_tpu`` traces one
program over a ``jax.sharding.Mesh`` with ``shard_map``, here every rank is
a process of one ``torch.distributed`` process group that runs the same
Python program (SPMD) on its own device; a :class:`Mesh` lays the ranks out
as (db, batch, limb) and holds one process group per line of each axis.

* axis ``"db"`` — partitions the **first hypercube dimension** D0.  Each
  rank owns a contiguous block of database rows (and the matching part of
  the first selection-vector block); the expansion tree is subtree-sharded
  (``expand.expand_query_sharded``: one ``all_gather``) and the partial
  replies meet in one ``all_reduce`` of reduced residues.  In
  ciphertext-multiplication mode each rank runs the whole recursion
  (kernel D's inner scan, then BEHZ multiply, relinearization and sum per
  upper dimension) on its rows; every product is relinearized before the
  sum over its dimension, so the sum of the ranks' reduced partials is
  single-device serving's reply bit for bit.
* axis ``"batch"`` — partitions the queries of a request.
* axis ``"limb"`` — partitions the RNS limbs.  A rank keeps its slice of the
  queries, of the Galois-key rows and of the database, transforms with its
  own moduli' NTT tables (kernel A), contracts planes through the
  runtime-moduli scan entry (K6).  Two collectives cross the axis: the key
  switch's digit inner product (one ``all_reduce``, ops/keyswitch.py) and
  the digit decomposition between hypercube levels (one ``all_gather`` on a
  uniform ``max_r`` digit grid).

D0 and the query batch are zero-padded to multiples of their axes; zero
ciphertexts and rows are exact no-ops, so the replies equal the unsharded
scan's bit for bit.  The limb axis is never padded: it must divide L.  The
replies are gathered over the batch and limb axes, so every rank returns
them all.

Collectives go through :meth:`Mesh.all_reduce` / :meth:`Mesh.all_gather`.
With the ``gloo`` backend (ranks that share a card, or the CPU) a CUDA
tensor is copied to the host for the collective and back, explicitly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from pir_tpu_torch.core.context import PirContext
from pir_tpu_torch.ops import decompose, expand, modswitch, modular, scan

AXES = ("db", "batch", "limb")


def pad_axis(arr, axis: int, multiple: int):
    """Zero-pad `axis` up to a multiple (numpy arrays and tensors)."""
    size = arr.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return arr
    if isinstance(arr, np.ndarray):
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (0, target - size)
        return np.pad(arr, pad)
    shape = list(arr.shape)
    shape[axis] = target - size
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def _block(x: torch.Tensor, axis: int, multiple: int, parts: int, part: int) -> torch.Tensor:
    """Block `part` of `parts` equal blocks of x zero-padded along `axis`
    to a multiple of `multiple` — without building the padded whole."""
    size = x.shape[axis]
    width = -(-size // multiple) * multiple // parts
    start = part * width
    have = x.narrow(axis, min(start, size), max(0, min(size, start + width) - start))
    if have.shape[axis] == width:
        return have
    shape = list(have.shape)
    shape[axis] = width - have.shape[axis]
    return torch.cat([have, have.new_zeros(shape)], dim=axis)


def _own(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and holding only its own storage: a view into the whole
    database would keep all of it alive."""
    x = x.contiguous()
    return x if x.untyped_storage().nbytes() == x.nbytes else x.clone()


class Mesh:
    """The ranks of the default process group as a (db, batch, limb) grid,
    ranks db-major, then batch, then limb — ``pir_tpu``'s
    ``devices.reshape(n_db, batch, limb)``.

    ``shape`` and ``axis_names`` follow ``pir_tpu.parallel.default_mesh``:
    the limb axis appears only when it is wider than 1.  Every rank creates
    the process group of every line of every axis wider than 1, in the same
    order (``new_group`` is collective); the group of a line orders its ranks
    as the axis coordinate.
    """

    def __init__(self, db: int, batch: int = 1, limb: int = 1):
        world = dist.get_world_size()
        if db * batch * limb != world:
            raise ValueError(
                f"mesh db={db} x batch={batch} x limb={limb} does not cover "
                f"{world} ranks"
            )
        self.shape = {"db": db, "batch": batch}
        if limb > 1:
            self.shape["limb"] = limb
        self.axis_names = tuple(self.shape)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        grid = np.arange(world).reshape(db, batch, limb)
        here = np.argwhere(grid == self.rank)[0]
        self._coords = {name: int(c) for name, c in zip(AXES, here)}
        self._groups = {}
        for i, name in enumerate(AXES):
            if grid.shape[i] == 1:
                continue
            for line in np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]):
                group = dist.new_group(ranks=[int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = group
            if dist.get_rank(self._groups[name]) != self._coords[name]:
                raise RuntimeError(f"the {name} group does not order its ranks by coordinate")

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self._coords[axis]

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor the backend reduces: gloo gets a host copy of a CUDA
        tensor."""
        x = x.contiguous()
        return x.cpu() if self.backend == "gloo" and x.is_cuda else x

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of x over the ranks of this rank's `axis` line (int64 sums
        wrap as u64 bit patterns)."""
        group = self._groups.get(axis)
        if group is None:
            return x
        t = self._staged(x)
        if t is x:
            t = x.clone()
        dist.all_reduce(t, group=group)
        return t.to(x.device)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """x of every rank of this rank's `axis` line, concatenated along
        `dim` in coordinate order."""
        group = self._groups.get(axis)
        if group is None:
            return x
        t = self._staged(x)
        parts = [torch.empty_like(t) for _ in range(self.size(axis))]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim).to(x.device)


def default_mesh(batch: int = 1, limb: int = 1) -> Mesh:
    """Mesh over every rank of the default process group: db = world /
    (batch · limb)."""
    world = dist.get_world_size()
    if world % (batch * limb):
        raise ValueError(f"rank count {world} not divisible by batch*limb = {batch * limb}")
    return Mesh(world // (batch * limb), batch, limb)


class _LimbShardView:
    """The PirContext a rank of a limb-sharded mesh computes with.

    Limb-axis tables are this rank's slices (its own moduli' NTT tables and
    Barrett constants, its rows of the key-switch constants); everything
    limb-independent (permutations, the full key-basis QP tables the key
    switch uses, ``ct_moduli``) delegates to the real context.
    ``limb_axis_name`` switches ops/keyswitch.py to its ``all_reduce`` form
    and ops/scan.py to K6's entry; ``decompose_fn`` to the all-gathering
    digit decomposition.
    """

    def __init__(self, ctx: PirContext, mesh: Mesh, axis_name: str = "limb"):
        self._ctx = ctx
        self.mesh = mesh
        self.limb_axis_name = axis_name
        l_local = ctx.L // mesh.size(axis_name)
        self.L = l_local
        self.ct_limb_offset = mesh.coord(axis_name) * l_local
        lo, hi = self.ct_limb_offset, self.ct_limb_offset + l_local
        self.ntt_q = ctx.ntt_q.limb_range(lo, hi)
        self.limbs_q = self.ntt_q.limbs
        if ctx.special is not None:
            self.p_half_mod_q = ctx.p_half_mod_q[lo:hi]
            self.p_inv_mod_q = ctx.p_inv_mod_q[lo:hi]
            self.p_inv_mod_q_shoup = ctx.p_inv_mod_q_shoup[lo:hi]

        # digit decomposition with the cross-limb all_gather: a uniform
        # max_r grid keeps one shape on every rank although the limbs' digit
        # counts differ (digits above a limb's own count are exact zeros)
        ratios = decompose.local_expansion_ratios(ctx)
        max_r = max(ratios)
        widths = decompose.digit_widths(ctx)[lo:hi]
        w_loc = torch.tensor(widths, dtype=torch.int64, device=ctx.device)[:, None]
        mask_loc = (1 << w_loc) - 1
        # valid (limb, digit) slots of the grid, in (limb, digit) order
        sel_idx = torch.tensor(
            [li * max_r + d for li in range(ctx.L) for d in range(ratios[li])],
            dtype=torch.int64, device=ctx.device,
        )
        er = len(sel_idx)

        def decompose_fn(ct):
            # ct: int64[..., size, L_local, N] local coefficient-form limbs
            digits = torch.stack(
                [(ct >> (d * w_loc)) & mask_loc for d in range(max_r)], dim=-2
            )  # [..., size, L_local, max_r, N]
            full = mesh.all_gather(digits, axis_name, dim=digits.dim() - 3)
            flat = full.reshape(*full.shape[:-3], ctx.L * max_r, ctx.n)
            sel = flat.index_select(flat.dim() - 2, sel_idx)  # [..., size, ER, N]
            return sel.reshape(*sel.shape[:-3], sel.shape[-3] * er, ctx.n)

        self.decompose_fn = decompose_fn

    def take_ct_limbs(self, x):
        """This rank's ciphertext-level limbs out of a key-basis tensor."""
        return PirContext.take_ct_limbs(self, x)

    def __getattr__(self, name):
        return getattr(self._ctx, name)


def rank_planes_shape(dims: tuple, n_db: int, l_local: int, n: int) -> tuple:
    """The shape of one rank's block of the planes: its D0 block (D0
    zero-padded to a multiple of the db axis) and its limbs."""
    d0_local = -(-dims[0] // n_db)
    if len(dims) == 1:
        return (1, l_local, d0_local, n)
    middle = 1
    for d in dims[1:-1]:
        middle *= d
    return (d0_local * middle, l_local, dims[-1], n)


def make_sharded_pipeline(
    ctx: PirContext,
    dims: tuple,
    db_ntt,
    mesh: Mesh,
    db_shoup=None,
    reply_limbs: "int | None" = None,
    db_planes=None,
    use_ct_mult: bool = False,
    local_planes: bool = False,
):
    """The multi-query pipeline of one rank: (query_cts, galois_keys) ->
    replies, called by every rank of the mesh with the same arguments.

    query_cts: int64[Q, num_cts, 2, L, N] on this rank's device, Q a
    multiple of the "batch" axis; galois_keys: {elt: int64[L, 2, Lp, N]}.
    Returns int64[Q, (2·ER)^(d-1), 2, L', N] on every rank, where L' is
    `reply_limbs` when set (replies mod-switched after the cross-rank
    reduction) and L otherwise.

    use_ct_mult: the ciphertext-multiplication recursion instead of digit
    decomposition, on the Shoup-table layout (db_ntt + db_shoup); the
    pipeline then takes the relinearization key int64[L, 2, Lp, N] as its
    third argument (None only for d = 1).  The selection vector stays in
    coefficient form and its D0 rows are split over "db" as in
    decomposition mode.

    The database is the rank's full copy in either layout — db_planes (hi,
    lo) [prefix, L, inner, N], or db_ntt (+ db_shoup) [padded, L, N] — of
    which the pipeline keeps a copy of this rank's db block and limb slice
    only (no view into the whole), so the whole is freed once the caller
    drops it.  With local_planes, db_planes already is this rank's block
    and limb slice (``parallel.distributed.planes_from_shard_rows``) and is
    taken as it is.
    reply_limbs and use_ct_mult are refused with a limb axis, and the
    planes layouts with use_ct_mult, as in pir_tpu.
    """
    n_db = mesh.size("db")
    n_limb = mesh.size("limb")
    n_batch = mesh.size("batch")
    if n_limb > 1:
        if ctx.L % n_limb != 0:
            raise ValueError(f"limb mesh axis {n_limb} must divide L={ctx.L} exactly")
        if reply_limbs is not None:
            raise ValueError("reply_limbs is unsupported with limb sharding")
        if use_ct_mult:
            raise ValueError(
                "ciphertext-multiplication mode is unsupported with limb "
                "sharding (BEHZ base extension crosses limbs)"
            )
    if use_ct_mult and (db_planes is not None or local_planes):
        raise ValueError("db_planes is a decomposition-mode operand")
    if use_ct_mult and db_shoup is None:
        raise ValueError("ciphertext-multiplication mode needs the Shoup-table database")
    if db_planes is None and db_ntt is None:
        raise ValueError("the pipeline needs db_planes or db_ntt")

    dim_sum = sum(dims)
    d0 = dims[0]
    d0_local = -(-d0 // n_db)
    local_dims = (d0_local,) + tuple(dims[1:])
    block = 1
    for d in dims[1:]:
        block *= d
    middle = block // dims[-1] if len(dims) > 1 else 1  # prod(dims[1:-1])
    my_db = mesh.coord("db")
    l_local = ctx.L // n_limb
    lo = mesh.coord("limb") * l_local

    cx = _LimbShardView(ctx, mesh) if n_limb > 1 else ctx
    planes_local = db_local = shoup_local = None
    if local_planes:
        want = rank_planes_shape(dims, n_db, l_local, ctx.n)
        if db_planes is None or tuple(db_planes[1].shape) != want:
            got = None if db_planes is None else tuple(db_planes[1].shape)
            raise ValueError(f"this rank's planes must be {want}, got {got}")
        planes_local = tuple(db_planes)
    elif db_planes is not None:
        # d == 1: D0 is the planes' contraction axis ([1, L, D0, N]); d > 1:
        # prefix rows are D0-major, `middle` of them per D0 row
        axis = 2 if len(dims) == 1 else 0
        mult = n_db if len(dims) == 1 else n_db * middle

        def local_planes(x):
            if x is None:
                return None
            return _own(_block(x, axis, mult, n_db, my_db).narrow(1, lo, l_local))

        planes_local = tuple(local_planes(x) for x in db_planes)
    else:

        def local_rows(x):
            if x is None:
                return None
            rows = _block(x.reshape(d0, block, ctx.L, ctx.n), 0, n_db, n_db, my_db)
            return _own(rows.narrow(2, lo, l_local).reshape(-1, l_local, ctx.n))

        db_local, shoup_local = local_rows(db_ntt), local_rows(db_shoup)

    def one_query(query, gk, relin_key):
        if n_db > 1:
            sv = expand.expand_query_sharded(cx, gk, query, dim_sum, mesh, "db")
        else:
            sv = expand.expand_query(cx, gk, query, dim_sum)
        if use_ct_mult:
            # ct-mult consumes the selection vector in coefficient form
            sv0_local = _block(sv[:d0], 0, n_db, n_db, my_db)
            sv_local = torch.cat([sv0_local, sv[d0:]], dim=0)
            partial = scan.database_scan_ctmult(
                cx, db_local, shoup_local, local_dims, sv_local, relin_key
            )
        else:
            sv_ntt = cx.ntt_q.forward(sv)
            sv0_local = _block(sv_ntt[:d0], 0, n_db, n_db, my_db)
            sv_local = torch.cat([sv0_local, sv_ntt[d0:]], dim=0)
            partial = scan.database_scan_decomp(
                cx, local_dims, sv_local, db_planes=planes_local,
                db_ntt=db_local, db_shoup=shoup_local,
            )
        # cross-rank homomorphic add: reduced summands, exact in u64
        partial = mesh.all_reduce(partial, "db")
        reply = modular.barrett_reduce_64(partial, cx.limbs_q.q, cx.limbs_q.ratio_hi)
        if reply_limbs is not None:
            reply = modswitch.mod_switch_to(ctx, reply, reply_limbs)
        return reply

    def pipeline(query_cts, galois_keys, relin_key=None):
        if query_cts.shape[0] % n_batch:
            raise ValueError(
                f"{query_cts.shape[0]} queries are not a multiple of the batch axis {n_batch}"
            )
        per_rank = query_cts.shape[0] // n_batch
        mine = query_cts.narrow(0, mesh.coord("batch") * per_rank, per_rank)
        gk = galois_keys
        if n_limb > 1:
            mine = mine.narrow(-2, lo, l_local)
            gk = {e: k.narrow(0, lo, l_local) for e, k in galois_keys.items()}
        replies = torch.stack([one_query(q, gk, relin_key) for q in mine])
        replies = mesh.all_gather(replies, "limb", dim=replies.dim() - 2)
        return mesh.all_gather(replies, "batch", dim=0)

    return pipeline
