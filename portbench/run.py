"""Run one cell of the benchmark of pir_tpu_torch once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program.  Set-up (the kernels'
build or load, the database from the seed on the card, the benchmark's
clients and their pool of requests, a warm-up through the stream) counts
as ``setup_s``.  Then the cell's closed loop offers the pool to
``PirServer.process_stream`` for ``--seconds``.  With ``--trace 0`` the
result carries the cell's end-to-end metrics; with ``--trace 1`` the same
window runs under torch.profiler, a sequential pass times the server's
public calls, and the result carries the per-layer metrics.  Either way
every reply served is judged afterwards by the benchmark's own client
(portbench.reference), with the program's state freed first.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each with its limit.
Without a CUDA card, or with fewer than the cell asks for, it exits with
2 and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pir_tpu")  # top-level names the run may not load
TOP_OPS = 10
_P_METRIC = re.compile(r"latency_p(\d+)_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def set_cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into pir_tpu_torch/_build/)."""
    cache = root / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def build_program(device) -> None:
    """Build or load every kernel of the program and its native encoder."""
    if device.type != "cuda":
        return
    from pir_tpu_torch import kernels, native

    with ThreadPoolExecutor(len(kernels.REGISTRY) + 1) as ex:
        encoder = ex.submit(native.available)
        list(ex.map(lambda k: k.lib(), kernels.REGISTRY.values()))
        encoder.result()


def make_items(cfg: dict, seed: int):
    """uint8[items, item_bytes]: distinct random items from the seed."""
    from portbench.traffic import seed_rng

    n, size = int(cfg["items"]), int(cfg["item_bytes"])
    return seed_rng(seed, 0).integers(0, 256, size=(n, size), dtype="uint8")


def program_params(cfg: dict):
    import pir_tpu_torch as pt

    ep = pt.generate_encryption_params(
        int(cfg["poly_modulus_degree"]), int(cfg["plain_modulus_bits"]),
        plain_modulus=int(cfg["plain_modulus"]),
        coeff_modulus=[int(q) for q in cfg["coeff_modulus"]])
    return pt.create_pir_parameters(
        int(cfg["items"]), int(cfg["item_bytes"]), int(cfg["dimensions"]), ep,
        use_ciphertext_multiplication=cfg["mode"] == "ciphertext_multiplication",
        reencode_digits=cfg["reencode_digits"])


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_rows(prof) -> list:
    """(name, on_device, start_s, end_s) of every event of a finished
    torch.profiler run, in one clock, read from the profiler's kineto
    events.  The device-side copies of host ranges (user annotations on the
    device's timeline, the benchmark's and the program's alike) are no
    device work and are left out."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != DeviceType.CPU
        if on_device and e.is_user_annotation():
            continue
        rows.append((e.name(), on_device, e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9))
    return rows


class Trace:
    """The reduction of one traced stream: busy and window seconds, device
    seconds by kernel name and by layer, idle seconds by host activity."""

    def __init__(self, rows, layers, window_name: str = "portbench.stream"):
        from portbench import measure

        marks = [(s, e) for name, dev, s, e in rows if not dev and name == window_name]
        if not marks:
            raise RuntimeError(f"the trace holds no {window_name} range")
        lo, hi = marks[0]
        device = [(name, s, e) for name, dev, s, e in rows if dev]
        spans = measure.clip([(s, e) for _, s, e in device], lo, hi)
        self.window_s = hi - lo
        self.busy_s = measure.busy(spans)
        self.kernel_s: dict = {}
        for name, s, e in device:
            self.kernel_s[name] = self.kernel_s.get(name, 0.0) + (e - s)
        self.layers = layers
        self.device_events = len(device)
        host = [(name, s, e) for name, dev, s, e in rows if not dev and name != window_name]
        self.idle = measure.label_gaps(measure.gaps(spans, lo, hi), host, "portbench.")

    def layer_seconds(self, layer: str) -> float:
        from portbench import measure

        return sum(s for name, s in self.kernel_s.items() if measure.layer_of(name, self.layers) == layer)

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP_OPS]
        idle = sorted(self.idle.items(), key=lambda kv: -kv[1])[:TOP_OPS]
        return {"device_ops": [[name[:160], s] for name, s in ops],
                "idle_gaps": [[name[:160], s] for name, s in idle]}


def sequential_pass(server, parse, pool, budget_s: float, least: int, device) -> dict:
    """The server's public calls one request at a time: the host time of
    process_request_async, then, after the device has finished, of
    finalize_response.  Runs until `budget_s` has passed (at least `least`
    requests, at most the pool).  Returns the spans and the Responses."""
    spans: dict = {"submit": [], "finalize": []}
    responses = []
    t_end = time.perf_counter() + budget_s
    for i, req in enumerate(pool):
        if i >= least and time.perf_counter() >= t_end:
            break
        request = parse(req.data)
        sync(device)
        t0 = time.perf_counter()
        pending = server.process_request_async(request)
        t1 = time.perf_counter()
        sync(device)
        t2 = time.perf_counter()
        responses.append((i, server.finalize_response(pending)))
        t3 = time.perf_counter()
        spans["submit"].append(t1 - t0)
        spans["finalize"].append(t3 - t2)
    return {"spans": spans, "responses": responses}


def end_to_end(cell, served, t_start: float, t_stop: float, setup_s: float, pool) -> dict:
    """The cell's end-to-end metrics over the requests completed in the
    window [t_start, t_stop]."""
    from portbench import measure

    done = [s for s in served if s.done is not None and s.done <= t_stop]
    latencies = [1e3 * (s.done - s.drawn) for s in done]
    queries = sum(len(pool[s.pool_index].indexes) for s in done)
    out = {}
    for m in cell.end_to_end:
        name = m["name"]
        if name == "qps":
            value = measure.rate(queries, t_stop - t_start)
        elif name == "setup_s":
            value = setup_s
        elif p := _P_METRIC.fullmatch(name):
            if not latencies:
                print(f"warning: no request completed in the window, no {name}", file=sys.stderr)
                continue
            value = measure.percentile(latencies, float(p[1]))
            beyond = sum(x > value for x in latencies)
            if beyond < 10:
                print(f"warning: {name} has {beyond} samples beyond it (of {len(latencies)})",
                      file=sys.stderr)
        else:
            raise KeyError(f"the harness computes no end-to-end metric {name!r}")
        out[name] = {"value": value, "unit": m["unit"]}
    per_s = [0] * max(1, int(t_stop - t_start + 0.999))
    for s in done:
        per_s[min(len(per_s) - 1, int(s.done - t_start))] += 1
    log(f"window {t_stop - t_start:.3f} s: {len(done)} requests ({queries} queries) completed "
        f"in it, {len(served) - len(done)} after it; requests completed each second {per_s}")
    return out


def power_limit() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
        return proc.stdout.strip() or proc.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             control: bool = False) -> dict:
    """One run of `cell` (spec.Cell): the result object.  `control` judges
    the replies cut to the plaintext's bits (judge.cut_to_plaintext_bits)."""
    import torch

    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels
    from pir_tpu_torch.proto import payload_pb2 as pb

    from portbench import judge, measure, traffic
    from portbench.reference import bfv
    from portbench.reference import params as ref_params

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg, mix = cell.config, cell.traffic

    build_program(device)
    params = program_params(cfg)
    rparams = ref_params.from_config(cfg)
    if (tuple(params.dimensions), params.num_pt) != (rparams.dimensions, rparams.num_pt):
        raise RuntimeError("the program and the reference derive different parameters")
    items = make_items(cfg, seed)
    raw = [row.tobytes() for row in items]
    db = pt.PirDatabase.create(raw, params, scan_impl=cfg["scan_impl"], device=device)
    del raw
    server = pt.PirServer(db, params, reply_limbs=int(cfg["reply_limbs"]))
    ref_ctx = bfv.Context(rparams, device)
    clients, pool = traffic.build_pool(ref_ctx, mix, seed)
    parse = pb.Request.FromString
    depth = int(mix["depth"])
    # warm-up: every client's keys into the cache, every stream slot made
    warm = [server.finalize_response(server.process_request_async(parse(pool[0].data)))]
    warm += list(server.process_stream((parse(r.data) for r in pool[: 2 * depth]), depth=depth))
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - _T0
    log(f"set-up {setup_s:.3f} s: {params.num_items} items of {params.bytes_per_item} B, dims "
        f"{list(params.dimensions)}, {params.num_pt} plaintexts on {device}; {len(clients)} "
        f"clients, a pool of {len(pool)} requests of {len(pool[0].indexes)} queries "
        f"({len(pool[0].data)} B each); {len(warm)} warm-up requests")

    kernels.reset_launch_counts()
    start = 2 * depth % len(pool)
    result_trace = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function("portbench.stream"):
                served, t_start, t_stop, error = traffic.closed_loop(
                    server, parse, pool, seconds, depth, start, mark=record_function)
            sync(device)
        t_trace = time.perf_counter()
        result_trace = Trace(trace_rows(prof), measure.kernel_layers(cell.kernels))
        del prof
        log(f"trace read in {time.perf_counter() - t_trace:.3f} s: {result_trace.device_events} "
            f"device events, busy {result_trace.busy_s:.6f} s of {result_trace.window_s:.6f} s")
    else:
        served, t_start, t_stop, error = traffic.closed_loop(server, parse, pool, seconds, depth, start)
    sync(device)
    log(f"launches {kernels.variant_launch_counts()}; stream_stats {server.stream_stats}")
    if error is not None:
        log(f"the stream raised {type(error).__name__}: {error}")

    metrics: dict = {}
    extra = []
    if trace:
        seq = sequential_pass(server, parse, pool, seconds / 2, len(clients), device)
        extra = [traffic.Served(i, 0.0, 0.0, r) for i, r in seq["responses"]]
        queries = sum(len(pool[s.pool_index].indexes) for s in served)
        run = types.SimpleNamespace(
            cell=cell, spans=seq["spans"], trace=result_trace, queries=queries,
            requests=len(served),
            scan_bytes=len(served) * measure.scan_bytes(cfg, rparams, len(pool[0].indexes)))
        for m in cell.per_layer:
            value = cell.readers[m["name"]](run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = end_to_end(cell, served, t_start, t_stop, setup_s, pool)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    if trace:
        dev["busy_s"] = result_trace.busy_s
        dev["window_s"] = result_trace.window_s
    if device.type == "cuda":
        log(f"peak device memory in the window {dev['memory_peak_bytes']} B; card: {power_limit()}")

    del server, db, warm
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks, failed, judged = judge.judge(served + extra, pool, clients, items,
                                         traffic.seed_rng(seed, 3), control=control)
    log(f"judged {judged} distinct replies of {len(served) + len(extra)} Responses in "
        f"{time.perf_counter() - t_judge:.3f} s{' (control)' if control else ''}")
    correct = error is None and all(checks[k] <= judge.LIMITS[k] for k in checks)
    out = {"correct": correct, "attempted": len(served) + len(extra), "failed": len(failed),
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = result_trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": judge.LIMITS[k]} for k, v in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_dirs(ROOT)
    from portbench import spec

    cell = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs without JAX or pir_tpu", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"{name} {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
