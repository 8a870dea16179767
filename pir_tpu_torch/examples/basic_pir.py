"""End-to-end PIR demo: build a database, privately retrieve an item.

    python3 -m pir_tpu_torch.examples.basic_pir [--db-size 1000] [--index 421]
                                                [--device cpu]

Computes on the CUDA card unless --device names another device.
"""

import argparse
import time

import numpy as np

from pir_tpu_torch import (
    PirClient,
    PirDatabase,
    PirServer,
    create_pir_parameters,
    generate_encryption_params,
)
from pir_tpu_torch.utils.profiling import timed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=1000)
    ap.add_argument("--item-size", type=int, default=288)
    ap.add_argument("--index", type=int, default=421)
    ap.add_argument("--dimensions", type=int, default=2)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    args.index %= args.db_size

    params = create_pir_parameters(
        args.db_size, args.item_size, args.dimensions, generate_encryption_params(4096, 24)
    )
    print(f"params: N=4096, items={args.db_size}x{args.item_size}B, "
          f"plaintexts={params.num_pt}, hypercube={params.dimensions}")
    rng = np.random.default_rng(1234)
    database = [rng.integers(0, 256, args.item_size, dtype=np.uint8).tobytes()
                for _ in range(args.db_size)]

    with timed("server setup (encode + NTT + planes)"):
        db = PirDatabase.create(database, params, device=args.device)
        server = PirServer.create(db, params)
    print(f"database on {db.device}")
    with timed("client setup (keygen)"):
        client = PirClient.create(params, device=args.device)

    t0 = time.perf_counter()
    request = client.create_request([args.index])
    print(f"request: {len(request.SerializeToString()) / 1e6:.2f} MB "
          f"in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    response = server.process_request(request)  # ends with the replies' host copy
    print(f"server processing: {time.perf_counter() - t0:.2f}s "
          f"(reply {len(response.SerializeToString()) / 1e6:.2f} MB)")
    with timed("client decode"):
        [item] = client.process_response([args.index], response)
    if item != database[args.index]:
        raise SystemExit(f"item {args.index} was not retrieved")
    print(f"retrieved item {args.index} correctly "
          f"({item[:8].hex()}... == {database[args.index][:8].hex()}...)")

    # a second query reuses the device-resident evaluation keys
    other = (args.index + 1) % args.db_size
    t0 = time.perf_counter()
    response = server.process_request(client.create_request([other]))
    [item2] = client.process_response([other], response)
    if item2 != database[other]:
        raise SystemExit(f"item {other} was not retrieved")
    print(f"second query (cached keys): {time.perf_counter() - t0:.2f}s")
    print("the server never learned which indices were retrieved.")


if __name__ == "__main__":
    main()
