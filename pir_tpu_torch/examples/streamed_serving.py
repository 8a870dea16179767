"""Serving demo: a queue of requests through process_stream.

Three serving shapes on one database:

  1. sequential       — process_request per request
  2. streamed         — process_stream(depth=6): each in-flight request on
                        a CUDA stream of its own, a worker thread turning
                        finished replies into Responses
  3. batched+streamed — multi-query requests streamed at depth 3, each one
                        pass of the wide scan (kernel C) over the database

    python3 -m pir_tpu_torch.examples.streamed_serving [--db-size 65536]
        [--requests 12] [--batch 4] [--device cpu]

Computes on the CUDA card unless --device names another device.  Prints
each shape's queries/s; every Response is checked.
"""

import argparse
import time

import numpy as np
import torch

from pir_tpu_torch import (
    PirClient,
    PirDatabase,
    PirServer,
    create_pir_parameters,
    generate_encryption_params,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=65536)
    ap.add_argument("--item-size", type=int, default=288)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    size = args.db_size
    params = create_pir_parameters(size, args.item_size, 2, generate_encryption_params(4096, 24))
    rng = np.random.default_rng(0)
    pool = [rng.integers(0, 256, args.item_size, dtype=np.uint8).tobytes() for _ in range(2048)]
    raw = [pool[i % 2048] for i in range(size)]
    print(f"building database ({size} items)...", flush=True)
    db = PirDatabase.create(raw, params, device=args.device)
    client = PirClient(params, seed=11, compress_queries=True, device=args.device)
    server = PirServer(db, params)
    on_card = db.device.type == "cuda"

    def clock():
        if on_card:
            torch.cuda.synchronize(db.device)
        return time.perf_counter()

    idx = [int(rng.integers(0, size)) for _ in range(args.requests)]
    single = [client.create_request([i]) for i in idx]
    batched = [client.create_request(idx[k : k + args.batch])
               for k in range(0, len(idx), args.batch)]
    client.process_response([idx[0]], server.process_request(single[0]))  # warm-up

    t0 = clock()
    seq = [server.process_request(r) for r in single]
    dt_seq = clock() - t0

    list(server.process_stream(iter(single), depth=6))  # the slots' buffers and graphs
    t0 = clock()
    streamed = list(server.process_stream(iter(single), depth=6))
    dt_stream = clock() - t0

    server.process_request(batched[0])  # warm the wide-scan shapes
    t0 = clock()
    wide = list(server.process_stream(iter(batched), depth=3))
    dt_wide = clock() - t0

    # every shape returns byte-identical, correct replies
    for k, i in enumerate(idx):
        if seq[k].SerializeToString() != streamed[k].SerializeToString():
            raise SystemExit(f"streamed Response {k} differs from the sequential one")
        if client.process_response([i], streamed[k])[0] != raw[i]:
            raise SystemExit(f"item {i} was not retrieved")
    got = [item for k, resp in zip(range(0, len(idx), args.batch), wide)
           for item in client.process_response(idx[k : k + args.batch], resp)]
    if got != [raw[i] for i in idx]:
        raise SystemExit("a batched streamed item was not retrieved")

    n = len(idx)
    print(f"on {db.device}: every Response checked")
    print(f"sequential        : {n / dt_seq:6.2f} queries/s")
    print(f"streamed depth 6  : {n / dt_stream:6.2f} queries/s")
    print(f"batch-{args.batch} streamed : {n / dt_wide:6.2f} queries/s")


if __name__ == "__main__":
    main()
