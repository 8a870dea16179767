"""Where a request's time goes: a stage profile of PirServer on a CUDA card.

    python3 -m pir_tpu_torch.profile_request                  # 2^20 items
    python3 -m pir_tpu_torch.profile_request --log2-items 16 --out prof.json
    python3 -m pir_tpu_torch.profile_request --ct-mult          # N=8192 ct-mult
    python3 -m pir_tpu_torch.profile_request --batched 16       # 16-query requests
    python3 -m pir_tpu_torch.profile_request --stream 6         # process_stream, depth 6
    python3 -m pir_tpu_torch.profile_request --n32768 --reps 1 --spread 1
    python3 -m pir_tpu_torch.profile_request --n32768 --ct-mult --reps 1 --spread 1

Builds the benchmark configuration (288-byte items, d=2, N=4096, 24-bit
plain modulus, SEAL's BFVDefault chain, database from seed 42, client seed 7,
seeded queries, replies mod-switched by ``reply_limbs_for``) — with
``--ct-mult`` the same items in ciphertext-multiplication mode at N=8192
(``chip_smoke.py``'s phase 13), with ``--n32768`` at N=32768 on SEAL's
55/56-bit chain (``chip_smoke.py``'s phase 20: the Shoup-table layout, the
client's keys made on the card; with ``--ct-mult`` too, phase 22) — fills
the key cache with one request, then
measures warm single-query requests, or with ``--batched Q`` warm
``process_request_batched`` requests of Q queries each (no stage profile):

* ``stages_ms``: the steps of ``process_request`` run one by one, each
  bracketed by ``torch.cuda.synchronize()``, mean over ``--reps`` requests;
  ``expansion_levels_ms`` splits the expansion by doubling level.  The staged
  Response must equal ``process_request``'s byte for byte;
* ``latency_ms``: host-clock time of ``--spread`` whole ``process_request``
  calls, no profiler;
* ``profiler``: ``torch.profiler`` over 3 requests (1 at N=32768) —
  device kernels and copies launched, their summed and merged device time,
  the wall time, the busy share (merged device time / wall), the device
  time by kernel name, a request's device time in each hand-written kernel
  (A-D) and in everything else (plain-torch kernels, copies).

With ``--stream D`` it measures ``process_stream`` at depth D instead of
the stages (``stream``): ``--windows`` windows of ``--spread`` requests,
served in turns sequentially and streamed (sequential, streamed, streamed,
sequential, ...), their queries/s; in the streamed windows the caller
thread's time a request in submission and the worker thread's time
waiting for the reply copy and serializing, each against the window's wall
time a request — the thread whose time a request is nearest the wall time
sets the pace; and ``profiler`` over one streamed window.

Prints one line per section and, as the last line, the whole result as one
JSON object, which it also writes to ``--out`` when one is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

import pir_tpu_torch as pt
from pir_tpu_torch.ops import expand, modswitch, scan
from pir_tpu_torch.pir import wire
from pir_tpu_torch.utils.math import ceil_log2

ITEM_SIZE = 288
DB_SEED = 42
CLIENT_SEED = 7
# the hand-written kernels' device functions (csrc/*.cu) by kernel
# (ntt_top_kernel: the top-stage pass of kernel A's earlier two-kernel split
# rings, so that an older tree profiles with this file too)
HAND_KERNELS = {"ntt_kernel": "A", "ntt_cluster_kernel": "A", "ntt_top_kernel": "A",
                "scan_kernel": "B", "scan_wide_kernel": "C", "scan_shoup_kernel": "D"}
_HAND_KERNEL = re.compile(r"\b(" + "|".join(HAND_KERNELS) + r")\b")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Laps:
    """Host-clock laps between device synchronizations, summed by name."""

    def __init__(self, ms: dict, device: torch.device):
        self.ms = ms
        self.device = device
        _sync(device)
        self.t = time.perf_counter()

    def lap(self, name: str) -> float:
        _sync(self.device)
        now = time.perf_counter()
        ms = (now - self.t) * 1e3
        self.ms[name] = self.ms.get(name, 0.0) + ms
        self.t = now
        return ms


def staged_request(server: pt.PirServer, request, stages: dict, levels: list):
    """process_request for a one-query request, one synchronized stage at a
    time (the same calls, in the same order); adds each stage's ms to
    ``stages`` and each expansion level's ms to ``levels``.  In
    ciphertext-multiplication mode the scan's BEHZ multiplies and
    relinearizations are stages of their own, apart from its inner scan and
    the sums of its steps."""
    ctx = server.ctx
    clock = _Laps(stages, server.device)
    keys, relin_key = server._device_keys(request)
    cts = server._upload(wire.load_ciphertexts(request.query[0], ctx), 0)
    clock.lap("load query + keys")
    outs = []
    remaining = server.params.dimensions_sum
    for i in range(cts.shape[0]):  # expand.expand_query, level by level
        count = min(ctx.n, remaining)
        remaining -= ctx.n
        x = cts[i][None]
        for j in range(ceil_log2(count) if count else 0):
            x = expand.expand_level(ctx, keys, x, j)
            levels[j] += clock.lap("oblivious expansion")
        outs.append(x[:count])
    sv = torch.cat(outs, dim=0)
    clock.lap("oblivious expansion")
    if server.params.use_ciphertext_multiplication:
        # the inner scan, then per upper-level step the BEHZ multiply,
        # relinearization and sum: the scan's own calls, each lapped
        inner = "database scan (inner scan, sums)"
        laps = {"bfv_multiply": "BEHZ multiply", "relinearize": "relinearization"}
        calls = {name: getattr(scan, name) for name in laps}

        def lapped(name):
            def run(*args):
                clock.lap(inner)
                out = calls[name](*args)
                clock.lap(laps[name])
                return out
            return run

        for name in laps:
            setattr(scan, name, lapped(name))
        try:
            reply = server.db.multiply(sv, relin_key)
        finally:
            for name, fn in calls.items():
                setattr(scan, name, fn)
        clock.lap(inner)
    else:
        sv_ntt = ctx.ntt_q.forward(sv)
        clock.lap("selection-vector NTT")
        reply = scan.database_scan_decomp(
            ctx, server.params.dimensions, sv_ntt, **server.db.scan_operands()
        )
        clock.lap("database scan (all dimensions)")
    if server.reply_limbs is not None:
        reply = modswitch.mod_switch_to(ctx, reply, server.reply_limbs)
    clock.lap("mod switch")
    response = server.finalize_response([reply])
    clock.lap("reply copy to host + serialize")
    return response


def device_profile(serve, requests) -> dict:
    """torch.profiler over serve(request) for the given requests: device
    events, busy share, device time by name, and each hand-written kernel's
    device time a request."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in requests:
            serve(req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device events")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    merged_us = 0.0
    cur_start, cur_end = spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            merged_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    merged_us += cur_end - cur_start
    by_name: dict = defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    hand: dict = defaultdict(float)
    for name, (_, us) in by_name.items():
        if m := _HAND_KERNEL.search(name):
            hand[f"kernel {HAND_KERNELS[m[1]]}"] += us / 1e3 / len(requests)
    return {
        "requests": len(requests),
        "device_events": len(events),
        "device_ms_summed": sum(v[1] for v in by_name.values()) / 1e3,
        "device_ms_merged": merged_us / 1e3,
        "wall_ms": wall_ms,
        "busy_share": merged_us / 1e3 / wall_ms,
        "hand_kernels_ms_per_request": dict(sorted(hand.items())),
        # everything else on the card: plain-torch kernels, copies and fills
        "other_device_ms_per_request": (sum(v[1] for v in by_name.values()) / 1e3
                                        - sum(hand.values()) * len(requests)) / len(requests),
        "by_name": [
            {"name": name[:120], "count": c, "ms": us / 1e3} for name, (c, us) in top
        ],
    }


def stream_profile(server, requests, depth: int, windows: int) -> dict:
    """Sequential and streamed windows in turns, and the streamed windows'
    per-thread times (caller: submission; worker: waiting on the reply
    copy's event, then serializing), with the server's stream counts."""
    from pir_tpu_torch.pir.server import HostReplies

    submit_ms, wait_ms, serialize_ms = [], [], []
    submit, finalize = server._submit, server.finalize_response

    def timed_submit(request, slot):
        t0 = time.perf_counter()
        out = submit(request, slot)
        submit_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_finalize(pending):
        if not isinstance(pending, HostReplies):  # process_request's own
            return finalize(pending)
        t0 = time.perf_counter()
        if pending.done is not None:
            pending.done.synchronize()
        t1 = time.perf_counter()
        out = finalize(pending)
        wait_ms.append((t1 - t0) * 1e3)
        serialize_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    def window(streamed: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if streamed:
            got = list(server.process_stream(iter(requests), depth=depth))
        else:
            got = [server.process_request(r) for r in requests]
        dt = time.perf_counter() - t0
        if len(got) != len(requests):
            raise AssertionError("a window lost a Response")
        return len(requests) / dt

    list(server.process_stream(iter(requests), depth=depth))  # builds the streams' pools
    server._submit, server.finalize_response = timed_submit, timed_finalize
    seq, streamed = [], []
    try:
        for w in range(windows):
            order = (False, True) if w % 2 == 0 else (True, False)
            for is_stream in order:
                (streamed if is_stream else seq).append(window(is_stream))
        stats = dict(server.stream_stats)
    finally:
        del server._submit, server.finalize_response
    wall_ms = 1e3 / (sum(streamed) / len(streamed))
    return {
        "depth": depth, "requests_a_window": len(requests),
        "sequential_qps": seq, "streamed_qps": streamed,
        "streamed_wall_ms_a_request": wall_ms,
        "caller_submit_ms_a_request": sum(submit_ms) / len(submit_ms),
        "worker_wait_ms_a_request": sum(wait_ms) / len(wait_ms),
        "worker_serialize_ms_a_request": sum(serialize_ms) / len(serialize_ms),
        "stream_stats": stats,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-items", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5, help="staged requests")
    ap.add_argument("--spread", type=int, default=10, help="timed whole requests")
    ap.add_argument("--out", help="also write the JSON result to this file")
    ap.add_argument("--ct-mult", action="store_true",
                    help="ciphertext-multiplication mode (at N=8192 unless --n32768)")
    ap.add_argument("--batched", type=int, metavar="Q",
                    help="profile process_request_batched requests of Q queries")
    ap.add_argument("--stream", type=int, metavar="D",
                    help="profile process_stream at depth D (single-query requests)")
    ap.add_argument("--windows", type=int, default=4, help="--stream: windows of each kind")
    ap.add_argument("--n32768", action="store_true",
                    help="N=32768 on SEAL's chain (the Shoup-table layout)")
    args = ap.parse_args(argv)
    if args.stream is not None and (args.stream < 1 or args.ct_mult or args.batched):
        raise SystemExit("profile_request: --stream takes D >= 1, single-query decomposition")
    if args.n32768 and (args.batched or args.stream):
        raise SystemExit("profile_request: --n32768 profiles single-query requests")
    if args.batched is not None and (args.batched < 1 or args.ct_mult):
        raise SystemExit("profile_request: --batched takes Q >= 1 queries, in decomposition mode")
    if not torch.cuda.is_available():
        raise SystemExit("profile_request: no CUDA device available")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    db_size = 1 << args.log2_items
    poly_degree = 32768 if args.n32768 else 8192 if args.ct_mult else 4096
    params = pt.create_pir_parameters(
        db_size, ITEM_SIZE, 2, pt.generate_encryption_params(poly_degree, 24),
        use_ciphertext_multiplication=args.ct_mult,
    )
    rng = np.random.default_rng(DB_SEED)
    pool = [rng.integers(0, 256, ITEM_SIZE, dtype=np.uint8).tobytes()
            for _ in range(min(db_size, 4096))]
    t0 = time.perf_counter()
    db = pt.PirDatabase.create(
        [pool[i % len(pool)] for i in range(db_size)], params, device=device
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    server = pt.PirServer(db, params, reply_limbs=pt.reply_limbs_for(params))
    client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True,
                          device=device if args.n32768 else "cpu")
    profiled = 1 if args.n32768 else 3  # requests under the profiler (~11 s each at N=32768)
    n_req = max(args.reps, args.spread, profiled) + 1
    queries = args.batched or 1
    requests = [client.create_request([(k * queries + i) * 7919 % db_size for i in range(queries)])
                for k in range(n_req)]
    serve = server.process_request_batched if args.batched else server.process_request
    serve(requests[0])  # fills the key cache; builds kernels

    stream = None
    if args.stream:
        stream = stream_profile(server, requests[1 : 1 + args.spread], args.stream, args.windows)
        prof = device_profile(
            lambda reqs: list(server.process_stream(iter(reqs), depth=args.stream)),
            [requests[1 : 1 + args.spread]])
        result = {"card": smi, "items": db_size, "stream": stream, "profiler": prof}
        print(f"stream depth {args.stream}, windows of {args.spread} requests in turns: "
              f"sequential {', '.join(f'{x:.2f}' for x in stream['sequential_qps'])} "
              f"queries/s; streamed {', '.join(f'{x:.2f}' for x in stream['streamed_qps'])}")
        print(f"streamed, a request: wall {stream['streamed_wall_ms_a_request']:.3f} ms; "
              f"caller submission {stream['caller_submit_ms_a_request']:.3f} ms; worker wait "
              f"{stream['worker_wait_ms_a_request']:.3f} ms, serialize "
              f"{stream['worker_serialize_ms_a_request']:.3f} ms; {stream['stream_stats']}")
        print(f"profiler, one streamed window: device {prof['device_ms_merged']:.3f} ms "
              f"(merged) of {prof['wall_ms']:.3f} ms wall, busy share {prof['busy_share']:.3f}")
        if args.out:
            out = pathlib.Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(result, indent=1))
        print(json.dumps(result), flush=True)
        return 0

    stages: dict = {}
    levels = [0.0] * ceil_log2(min(params.dimensions_sum, params.encryption_params.poly_modulus_degree))
    reps = 0 if args.batched else args.reps
    for req in requests[1 : 1 + reps]:
        staged = staged_request(server, req, stages, levels)
        if staged.SerializeToString() != server.process_request(req).SerializeToString():
            raise AssertionError("staged request differs from process_request")
    stages = {k: v / reps for k, v in stages.items()}
    levels = [v / reps for v in levels] if reps else []

    latency = []
    for req in requests[1 : 1 + args.spread]:
        t0 = time.perf_counter()
        serve(req)
        latency.append((time.perf_counter() - t0) * 1e3)
    prof = device_profile(serve, requests[1 : 1 + profiled])

    result = {
        "card": smi,
        "config": {"items": db_size, "item_bytes": ITEM_SIZE,
                   "dimensions": list(params.dimensions), "poly_degree": poly_degree,
                   "ct_mult": args.ct_mult, "batched": args.batched, "plain_bits": 24,
                   "reply_limbs": server.reply_limbs},
        "database_build_s": build_s,
        "stages_ms": stages,
        "stages_total_ms": sum(stages.values()),
        "expansion_levels_ms": levels,
        "latency_ms": latency,
        "profiler": prof,
    }
    total = result["stages_total_ms"]
    print(f"database: {db_size} items, built in {build_s:.2f} s", flush=True)
    for name, ms in stages.items():
        print(f"stage {name}: {ms:.3f} ms ({ms / total:.1%})", flush=True)
    if reps:
        print(f"stages total {total:.3f} ms (mean of {reps} staged requests)")
        print("expansion per level (ms): " + ", ".join(f"{x:.3f}" for x in levels))
    print(f"whole-request latency, {queries} queries a request (ms): "
          + ", ".join(f"{x:.2f}" for x in latency))
    print(f"profiler, {prof['requests']} requests: {prof['device_events']} device "
          f"events, device {prof['device_ms_merged']:.3f} ms (merged) of "
          f"{prof['wall_ms']:.3f} ms wall, busy share {prof['busy_share']:.3f}")
    print("hand-written kernels, device ms a request: " + ", ".join(
        f"{k} {ms:.3f} ({ms / (prof['wall_ms'] / prof['requests']):.2%} of the request)"
        for k, ms in prof["hand_kernels_ms_per_request"].items())
        + f"; everything else (plain torch, copies) {prof['other_device_ms_per_request']:.3f}")
    for row in prof["by_name"][:12]:
        print(f"  {row['ms']:9.3f} ms  {row['count']:6d}x  {row['name']}")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
