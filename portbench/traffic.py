"""The one traffic generator: a pool of requests made from a mix's numbers
and a seed, and the closed loop that offers them to the server.

A mix (``traffic/<name>.json``) states its loop (``closed``: each of
``depth`` callers waits for its reply before the next request), its
``clients`` (each with its own key set), ``queries_per_request``,
``requests_per_client`` (the pool made in set-up and cycled) and how
indexes are drawn (``uniform``).  Which item a query asks for changes no
work, since the protocol is oblivious.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench.reference.client import Client


@dataclasses.dataclass
class Request:
    client: int
    indexes: list
    data: bytes  # the serialized Request


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run's randomness."""
    return np.random.default_rng([seed % 2**64, *stream])


def build_pool(ref_ctx, traffic: dict, seed: int) -> "tuple[list[Client], list[Request]]":
    """The mix's clients and its pool of requests, in the order they are
    offered: client by client in turn."""
    if traffic["loop"] != "closed" or traffic["indexes"] != "uniform":
        raise ValueError(f"unsupported mix {traffic}")
    clients = [Client(ref_ctx, seed_rng(seed, 1, c)) for c in range(traffic["clients"])]
    q = traffic["queries_per_request"]
    per = traffic["requests_per_client"]
    draw = seed_rng(seed, 2)
    num_items = ref_ctx.params.num_items
    index_lists = draw.integers(0, num_items, size=(len(clients), per, q)).tolist()
    made = [c.requests(index_lists[i]) for i, c in enumerate(clients)]
    pool = [Request(c, index_lists[c][r], made[c][r]) for r in range(per) for c in range(len(clients))]
    return clients, pool


@dataclasses.dataclass
class Served:
    """One request drawn by the server: its pool entry, when it was drawn
    and when its Response was yielded (None if it never was)."""

    pool_index: int
    drawn: float
    done: "float | None" = None
    response: object = None


def closed_loop(server, parse, pool, seconds: float, depth: int, start: int = 0,
                mark=None) -> "tuple[list[Served], float, float, Exception | None]":
    """Offer the pool, cycled from entry `start`, to ``server.process_stream``
    at `depth` for `seconds`: a request is drawn when the server asks for
    the next one, until the window closes; the ones in flight then are
    still served.  `parse` turns a request's bytes into the program's
    Request, inside the draw; `mark(name)` returns a context manager around
    the draw (a profiler range), or None.  Returns the served requests in
    order, the window's start and end (host clock) and the error the
    stream raised, if any."""
    served: list = []
    t_start = time.perf_counter()
    t_stop = t_start + seconds

    def requests():
        k = start
        while True:
            now = time.perf_counter()
            if now >= t_stop:
                return
            i = k % len(pool)
            k += 1
            served.append(Served(i, now))
            if mark is None:
                yield parse(pool[i].data)
            else:
                with mark("portbench.draw"):
                    req = parse(pool[i].data)
                yield req

    error = None
    done = 0
    try:
        for response in server.process_stream(requests(), depth=depth):
            served[done].done = time.perf_counter()
            served[done].response = response
            done += 1
    except Exception as e:  # the stream stops: what is unanswered is missing
        error = e
    return served, t_start, t_stop, error
