"""Where a request's time goes: a stage profile of PirServer on a CUDA card.

    python3 -m pir_tpu_torch.profile_request                  # 2^20 items
    python3 -m pir_tpu_torch.profile_request --log2-items 16 --out prof.json
    python3 -m pir_tpu_torch.profile_request --ct-mult          # N=8192 ct-mult
    python3 -m pir_tpu_torch.profile_request --batched 16       # 16-query requests
    python3 -m pir_tpu_torch.profile_request --n32768 --reps 1 --spread 1
    python3 -m pir_tpu_torch.profile_request --n32768 --ct-mult --reps 1 --spread 1

Builds the benchmark configuration (288-byte items, d=2, N=4096, 24-bit
plain modulus, SEAL's BFVDefault chain, database from seed 42, client seed 7,
seeded queries, replies mod-switched by ``reply_limbs_for``) — with
``--ct-mult`` the same items in ciphertext-multiplication mode at N=8192
(``chip_smoke.py``'s phase 13), with ``--n32768`` at N=32768 on SEAL's
55/56-bit chain (``chip_smoke.py``'s phase 20: the Shoup-table layout, the
client's keys made on the card; with ``--ct-mult`` too, phase 22) — fills
the key cache with one request (after printing the database's
``build_stats``, also kept in the result), then measures warm single-query
``process_request`` calls, or with ``--batched Q`` warm
``process_request_batched`` calls of Q queries each:

* ``stages``: ``--reps`` requests served in one torch.profiler session, and
  for each of the served path's spans (utils/profiling.py) a request's
  count of it, its host self time (its duration less its child spans',
  ``profiling.span_summary``), its device time and the device operations
  it launched.  A device operation belongs to the innermost span open on
  the launching thread when it was launched (:func:`attribute_device_time`),
  so nothing is synchronized between stages; ``outside`` holds those
  launched outside every span, and ``device_ms_total`` the session's whole
  device time a request, which the stages and ``outside`` add up to;
* ``latency_ms``: host-clock time of ``--spread`` whole requests, no
  profiler;
* ``profiler``: ``torch.profiler`` over 3 requests (1 at N=32768) —
  device kernels and copies launched, their summed and merged device time,
  the wall time, the busy share (merged device time / wall), the device
  time by kernel name, a request's device time in each hand-written kernel
  (A-G) and in everything else (plain-torch kernels, copies), and the
  device kernels a request launched (``device_kernels``: copies and fills
  apart).

Prints one line per section and, as the last line, the whole result as one
JSON object, which it also writes to ``--out`` when one is given.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import pathlib
import re
import subprocess
import time

import numpy as np
import torch

import pir_tpu_torch as pt
from pir_tpu_torch.utils import profiling

ITEM_SIZE = 288
DB_SEED = 42
CLIENT_SEED = 7
# the hand-written kernels' device functions (csrc/*.cu) by kernel; E2 and F2
# launch one function, csrc/contract.cuh's contract::contract_kernel, which
# a device trace cannot split between them ("E2+F2").  So that an older tree
# profiles with this file too: ntt_top_kernel, the top-stage pass of kernel
# A's earlier two-kernel split rings, and ks_inner_kernel and
# contract_kernel, E2 and F2 before csrc/contract.cuh
HAND_KERNELS = {"ntt_kernel": "A", "ntt_cluster_kernel": "A", "ntt_top_kernel": "A",
                "scan_kernel": "B", "scan_wide_kernel": "C", "scan_shoup_kernel": "D",
                "ks_decompose_kernel": "E", "ks_inner_kernel": "E", "ks_moddown_kernel": "E",
                "expand_combine_kernel": "E", "contract::contract_kernel": "E2+F2",
                "digits_lift_kernel": "F", "contract_kernel": "F", "mod_switch_kernel": "F",
                "split_planes_kernel": "F", "behz_lift_kernel": "G", "behz_tensor_kernel": "G",
                "behz_floor_sk_kernel": "G"}
_HAND_KERNEL = re.compile(r"\b(" + "|".join(HAND_KERNELS) + r")\b")
_NOT_A_KERNEL = ("Memcpy", "Memset")  # device events that are copies and fills


def _trace_rows(prof) -> tuple:
    """A finished torch.profiler session's kineto events as (host, device)
    lists of (name, start_ns, end_ns, correlation id): every host event,
    and every device operation (kernels, copies, fills) but the
    device-side copies of host ranges (user annotations on the device's
    timeline), which are no device work."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id())
        if e.device_type() == DeviceType.CPU:
            host.append(row)
        elif not e.is_user_annotation():
            device.append(row)
    return host, device


def attribute_device_time(spans, work) -> tuple:
    """Each device operation's time put down to the innermost span open
    when it was launched.  `spans`: (name, start_ns, end_ns) of the host
    ranges of one thread, nested or apart; `work`: (launch_ns, name,
    duration_ns) of the device operations that thread launched, launch_ns
    being when its launch call began (None where no launch was found: not
    counted).  Returns ({span name: {"device_ms", "kernels": {name:
    count}}}, the same for the operations launched outside every span)."""
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    starts = [s[1] for s in order]
    stages: dict = {}
    outside = {"device_ms": 0.0, "kernels": collections.Counter()}
    for launch_ns, name, duration_ns in work:
        if launch_ns is None:
            continue
        # the innermost span open at the launch: of those open then, the
        # last to start
        owner = next((s[0] for s in reversed(order[:bisect.bisect_right(starts, launch_ns)])
                      if s[2] >= launch_ns), None)
        if owner is None:
            slot = outside
        else:
            slot = stages.setdefault(owner, {"device_ms": 0.0, "kernels": collections.Counter()})
        slot["device_ms"] += duration_ns / 1e6
        slot["kernels"][name] += 1
    return stages, outside


def stage_profile(serve, requests) -> dict:
    """serve(request) for each of the given requests, on this thread,
    inside one torch.profiler session (host activity, and the card's where
    there is one): per span name of the served path, in the order first
    opened, a request's count, host self ms (``profiling.span_summary``),
    device ms and device operations by name (:func:`attribute_device_time`);
    the device ms and operations launched outside every span; and the
    session's device ms a request, which the stages and ``outside`` add up
    to where every device operation's launch was recorded (0 on the CPU,
    which has no device operations)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        for req in requests:
            serve(req)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    spans = sorted((s for s in profiling.recorded_spans() if s.start_ns >= t0),
                   key=lambda s: s.start_ns)
    summary = profiling.span_summary(spans)
    host, ops = _trace_rows(prof)
    # a device operation's launch: the CUDA API call (named cu*) that
    # carries its correlation id
    launches = {corr: start for name, start, _, corr in host if name.startswith("cu")}
    work = [(launches.get(corr), name, end - start) for name, start, end, corr in ops]
    device, outside = attribute_device_time(
        [(name, start, end) for name, start, end, _ in host if name in summary], work)
    n = len(requests)

    def per_request(slot) -> dict:
        return {"device_ms": slot["device_ms"] / n,
                "kernels": {k: c / n for k, c in slot["kernels"].most_common()}}

    empty = {"device_ms": 0.0, "kernels": collections.Counter()}
    stages = {name: {"count": summary[name]["count"] / n,
                     "host_self_ms": summary[name]["self_ms"] / n,
                     **per_request(device.get(name, empty))}
              for name in dict.fromkeys(s.name for s in spans)}
    return {"requests": n, "stages": stages, "outside": per_request(outside),
            "device_ms_total": sum(w[2] for w in work) / 1e6 / n}


def _short(kernel: str) -> str:
    """A device operation's name without its return type, namespace and
    arguments."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].strip()[:60]


def stage_lines(profile: dict) -> list:
    """stage_profile's result as lines of text, one a stage, then the
    operations outside every span and the sum against the session's
    device time."""
    def ops(kernels: dict) -> str:
        return ", ".join(f"{_short(k)} x{c:g}" for k, c in kernels.items()) or "none"

    lines = []
    for name, st in profile["stages"].items():
        lines.append(f"stage {name}: x{st['count']:g}, host self {st['host_self_ms']:.3f} ms, "
                     f"device {st['device_ms']:.3f} ms; {ops(st['kernels'])}")
    out = profile["outside"]
    lines.append(f"outside every span: device {out['device_ms']:.3f} ms; {ops(out['kernels'])}")
    summed = sum(st["device_ms"] for st in profile["stages"].values()) + out["device_ms"]
    total = profile["device_ms_total"]
    lines.append(f"stages + outside {summed:.3f} device ms of the session's {total:.3f} a request"
                 f" (mean of {profile['requests']})"
                 + (f", {summed / total:.2%}" if total else ""))
    return lines


def device_profile(serve, requests) -> dict:
    """torch.profiler over serve(request) for the given requests: device
    events, busy share, device time by name, and each hand-written kernel's
    device time a request."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in requests:
            serve(req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _, events = _trace_rows(prof)
    if not events:
        raise RuntimeError("torch.profiler recorded no device events")
    spans = sorted((start, end) for _, start, end, _ in events)
    merged_ns = 0
    cur_start, cur_end = spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            merged_ns += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    merged_ns += cur_end - cur_start
    by_name: dict = collections.defaultdict(lambda: [0, 0])
    for name, start, end, _ in events:
        by_name[name][0] += 1
        by_name[name][1] += end - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    hand: dict = collections.defaultdict(float)
    for name, (_, ns) in by_name.items():
        if m := _HAND_KERNEL.search(name):
            hand[f"kernel {HAND_KERNELS[m[1]]}"] += ns / 1e6 / len(requests)
    summed_ms = sum(v[1] for v in by_name.values()) / 1e6
    return {
        "requests": len(requests),
        "device_events": len(events),
        "device_kernels": sum(not e[0].startswith(_NOT_A_KERNEL) for e in events)
        / len(requests),
        "device_ms_summed": summed_ms,
        "device_ms_merged": merged_ns / 1e6,
        "wall_ms": wall_ms,
        "busy_share": merged_ns / 1e6 / wall_ms,
        "hand_kernels_ms_per_request": dict(sorted(hand.items())),
        # everything else on the card: plain-torch kernels, copies and fills
        "other_device_ms_per_request": (summed_ms - sum(hand.values()) * len(requests))
        / len(requests),
        "by_name": [
            {"name": name[:120], "count": c, "ms": ns / 1e6} for name, (c, ns) in top
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-items", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5, help="requests in the stage profile")
    ap.add_argument("--spread", type=int, default=10, help="timed whole requests")
    ap.add_argument("--out", help="also write the JSON result to this file")
    ap.add_argument("--ct-mult", action="store_true",
                    help="ciphertext-multiplication mode (at N=8192 unless --n32768)")
    ap.add_argument("--batched", type=int, metavar="Q",
                    help="profile process_request_batched requests of Q queries")
    ap.add_argument("--n32768", action="store_true",
                    help="N=32768 on SEAL's chain (the Shoup-table layout)")
    args = ap.parse_args(argv)
    if args.n32768 and args.batched:
        raise SystemExit("profile_request: --n32768 profiles single-query requests")
    if args.batched is not None and (args.batched < 1 or args.ct_mult):
        raise SystemExit("profile_request: --batched takes Q >= 1 queries, in decomposition mode")
    if args.reps < 1:
        raise SystemExit("profile_request: --reps takes at least 1 request")
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
    print(f"database build: {db.build_stats}", flush=True)
    server = pt.PirServer(db, params, reply_limbs=pt.reply_limbs_for(params))
    client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True,
                          device=device if args.n32768 else "cpu")
    profiled = 1 if args.n32768 else 3  # requests under the device profile
    n_req = max(args.reps, args.spread, profiled) + 1
    queries = args.batched or 1
    requests = [client.create_request([(k * queries + i) * 7919 % db_size for i in range(queries)])
                for k in range(n_req)]
    serve = server.process_request_batched if args.batched else server.process_request
    serve(requests[0])  # fills the key cache; builds kernels

    stages = stage_profile(serve, requests[1 : 1 + args.reps])
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
        "build_stats": db.build_stats,
        "stages": stages,
        "latency_ms": latency,
        "profiler": prof,
    }
    print(f"database: {db_size} items, built in {build_s:.2f} s", flush=True)
    for line in stage_lines(stages):
        print(line, flush=True)
    print(f"whole-request latency, {queries} queries a request (ms): "
          + ", ".join(f"{x:.2f}" for x in latency))
    print(f"profiler, {prof['requests']} requests: {prof['device_events']} device "
          f"events, device {prof['device_ms_merged']:.3f} ms (merged) of "
          f"{prof['wall_ms']:.3f} ms wall, busy share {prof['busy_share']:.3f}; "
          f"{prof['device_kernels']:.1f} device kernels a request")
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
