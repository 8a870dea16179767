"""Run a mesh job: start one process per rank, serve the job's requests on
every rank through ``PirServer(mesh=...)``, and collect each rank's
Responses, launch counts and latencies.

    results = mesh_worker.run_job(job, job_dir, timeout_s=300)

job: {"world": ranks, "backend": "gloo" | "nccl", "devices": [one per rank],
"timeout_s": collective timeout, "cases": [case, ...]}.  Each rank computes
with one torch thread.  A case is a dict:

* "name"; "params": serialized ``PIRParameters`` bytes; "items": the
  items' bytes back to back (``params.bytes_per_item`` each);
  "scan_impl" ("pallas" | "xla" | "auto"); "reply_limbs" (int or None);
  "packed_transfer" (the server's, True by default: each rank moves its
  query and reply arrays as packed (lo, hi) pairs);
  "batch", "limb": the mesh axes (db takes the remaining ranks);
* "requests": serialized ``Request`` bytes, each served with
  ``process_request`` (and, with "batched": True, once more with
  ``process_request_batched``); native or SEAL streams alike.  A
  ciphertext-multiplication case (its params say so) builds the Shoup-table
  database (NTT words and companions) whatever its "scan_impl", and its
  requests carry the relinearization key;
* "shard_dir" (instead of "items"): a ``PirDatabase.ingest_shards``
  checkpoint with one shard per db coordinate; each rank loads only its
  shard's rows (``load_shard_rows``) and builds only its block of the
  planes (``parallel.distributed.planes_from_shard_rows``), so no rank
  ever holds the whole database.

Every rank runs every case in order (SPMD) and reports, besides its
Responses, launch counts and latencies, the device memory it holds once its
server is built (its shard; the whole database is dropped) and its peak
over the build and the requests (None on the CPU).  A rank is the module run as

    python -m pir_tpu_torch.parallel.mesh_worker JOB_DIR RANK

and imports only torch and pir_tpu_torch.  run_job waits at most timeout_s
for all ranks and kills every rank on expiry or when one fails.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parents[2]


def _serve_case(case: dict, device) -> dict:
    import torch
    import torch.distributed as dist

    from pir_tpu_torch import kernels
    from pir_tpu_torch.parallel import sharded
    from pir_tpu_torch.pir import wire
    from pir_tpu_torch.pir.server import PirServer
    from pir_tpu_torch.proto import payload_pb2 as pb

    params = wire.pir_params_from_proto(pb.PIRParameters.FromString(case["params"]))
    mesh = sharded.default_mesh(batch=case.get("batch", 1), limb=case.get("limb", 1))
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    db = _database(case, params, mesh, device)
    server = PirServer(db, params, reply_limbs=case.get("reply_limbs"),
                       packed_transfer=case.get("packed_transfer", True), mesh=mesh)
    del db  # the server keeps this rank's shard only
    out = {"responses": [], "batched": [], "counts": [], "ms": [], "held_mib": None,
           "peak_mib": None}
    if on_card:
        torch.cuda.empty_cache()
        out["held_mib"] = torch.cuda.memory_allocated(device) / 2**20
    for req_bytes in case["requests"]:
        request = pb.Request.FromString(req_bytes)
        if on_card:
            torch.cuda.synchronize(device)
        dist.barrier()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        response = server.process_request(request)  # ends with a host copy
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["counts"].append(kernels.variant_launch_counts())
        out["responses"].append(response.SerializeToString())
        if case.get("batched"):
            out["batched"].append(server.process_request_batched(request).SerializeToString())
    if on_card:
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    return out


def _database(case: dict, params, mesh, device):
    """The whole database from the case's items, or this rank's block of
    its planes from the case's shard files."""
    import numpy as np

    from pir_tpu_torch.parallel import distributed
    from pir_tpu_torch.pir import database
    from pir_tpu_torch.pir.database import PirDatabase

    if "shard_dir" not in case:
        size = params.bytes_per_item
        blob = case["items"]
        items = [blob[i * size : (i + 1) * size] for i in range(params.num_items)]
        return PirDatabase.create(items, params, scan_impl=case.get("scan_impl", "auto"),
                                  device=device)
    shard = mesh.coord("db")
    r0, r1 = database.shard_row_ranges(params, mesh.size("db"))[shard]
    db = PirDatabase(params, scan_impl="pallas", device=device)
    if r1 > r0:
        rows = PirDatabase.load_shard_rows(case["shard_dir"], shard)[: r1 - r0]
    else:  # a shard past the last plaintext holds only padding
        rows = np.zeros((0, db.ctx.n), np.uint64)
    row_start = shard * database.shard_rows(params, mesh.size("db"))
    db.set_rank_planes(distributed.planes_from_shard_rows(params, db.ctx, rows, mesh, row_start))
    return db


def _replicate_check(device) -> bool:
    """replicate_to_mesh: every rank passes its own rank; all get rank 0's."""
    import numpy as np
    import torch.distributed as dist

    from pir_tpu_torch.parallel import distributed

    mine = np.full((3, 4), dist.get_rank() + 2**63, dtype=np.uint64)
    got = distributed.replicate_to_mesh(mine, None, device)
    want = np.full((3, 4), 2**63, dtype=np.uint64).view(np.int64)
    return bool((got.cpu().numpy() == want).all())


def run_rank(job_dir: pathlib.Path, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from pir_tpu_torch.parallel import distributed

    job = pickle.loads((job_dir / "job.pkl").read_bytes())
    torch.set_num_threads(1)
    device = distributed.init_distributed(
        (job_dir / "rendezvous").as_uri(), job["world"], rank, job["backend"],
        device=job["devices"][rank], timeout_s=job.get("timeout_s", 300),
    )
    results = {"replicate_ok": _replicate_check(device)}
    for case in job["cases"]:
        results[case["name"]] = _serve_case(case, device)
    dist.barrier()
    dist.destroy_process_group()
    tmp = job_dir / f"rank{rank}.pkl.tmp"
    tmp.write_bytes(pickle.dumps(results))
    os.replace(tmp, job_dir / f"rank{rank}.pkl")


def run_job(job: dict, job_dir, timeout_s: float) -> list:
    """Start job["world"] rank processes on `job`, wait for all of them (at
    most timeout_s seconds) and return each rank's results, rank by rank.
    Raises with the ranks' output if one fails or the time runs out; every
    rank is stopped before this returns."""
    job_dir = pathlib.Path(job_dir)
    job_dir.mkdir(parents=True, exist_ok=True)
    (job_dir / "job.pkl").write_bytes(pickle.dumps(job))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    logs = [open(job_dir / f"rank{r}.log", "w") for r in range(job["world"])]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pir_tpu_torch.parallel.mesh_worker", str(job_dir), str(r)],
            env=env, stdout=logs[r], stderr=subprocess.STDOUT,
        )
        for r in range(job["world"])
    ]
    failure = None
    try:
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failure = f"ranks still running after {timeout_s} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    if failure is not None:
        tails = "\n".join(
            f"--- rank {r} ---\n" + (job_dir / f"rank{r}.log").read_text()[-3000:]
            for r in range(job["world"])
        )
        raise RuntimeError(f"mesh job failed: {failure}\n{tails}")
    return [pickle.loads((job_dir / f"rank{r}.pkl").read_bytes()) for r in range(job["world"])]


if __name__ == "__main__":
    run_rank(pathlib.Path(sys.argv[1]), int(sys.argv[2]))
