"""Cluster-wide synchronized trace trigger (unitrace analog): the port's
own copy of ``dynolog_tpu/cluster/unitrace.py``, for PyTorch jobs whose
ranks each run the port's ``TraceClient``.

Behavioral parity: reference scripts/pytorch/unitrace.py — discover the
job's hosts, compute one synchronized future start timestamp, then drive
every host's daemon so all ranks capture an alignable trace window
(unitrace.py:32-60,141-162). Hosts come from SLURM, a GKE label selector,
or a plain `--hosts` list. Two parts of the JAX package's tool are left
out: Cloud TPU VM discovery (`--tpu-name`; an H100 host is not a TPU VM)
and the shim-free push capture (`--capture push`, `--profiler-port`; a
torch job has no profiler server to push to, so a capture is always the
shim's pull capture). The auto-trigger request still carries the
`capture` and `profiler_port` fields, with `capture` always "shim", so
the daemon sees the same body as from the JAX tool.

Transport: the framed JSON-RPC wire protocol spoken natively over
kept-alive sockets (``dynolog_tpu_torch/cluster/rpc.py``) rather than a
`dyno` CLI subprocess per host per operation, which at pod scale
multiplies every poll by a process fork plus a fresh TCP connect.
`--query --watch-interval-s N` turns the one-shot cluster table into a
live dashboard that reuses one persistent connection per host across
polls.

Usage:
    python -m dynolog_tpu_torch.cluster.unitrace --slurm-job 1234 --log-file /tmp/t.json
    python -m dynolog_tpu_torch.cluster.unitrace --hosts h1,h2,h3 --log-file /tmp/t.json
    python -m dynolog_tpu_torch.cluster.unitrace --gke-selector job-name=train \
        --log-file /tmp/t.json
    python -m dynolog_tpu_torch.cluster.unitrace --hosts h1,h2,h3 \
        --query tpu0.hbm_used_bytes --watch-interval-s 2
    python -m dynolog_tpu_torch.cluster.unitrace --hosts h1,h2,h3 \
        --fetch /traces/t_123/t.pt.trace.json --fetch-dir ./pod_traces
    python -m dynolog_tpu_torch.cluster.unitrace --relay relay-host:1778 \
        --query tpu0.hbm_used_bytes --watch-interval-s 2

The daemon names a card's rows `tpu<N>` whatever the device (ROADMAP C4).

Fleet mode (``--relay HOST[:PORT]``): instead of fanning out one
connection per host, ``--query``/``--watch`` are answered from a SINGLE
`fleet` RPC against a fleet aggregation relay (a daemon running with
``--relay``) — the per-host last values the relay rolled up from the
durable sink stream. Hosts the relay marks `lost` print UNREACHABLE.
The per-host fan-out above stays as the fallback path when no relay is
deployed.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from dynolog_tpu_torch import obs
from dynolog_tpu_torch.cluster.rpc import FramedRpcClient

DEFAULT_START_DELAY_S = 10  # reference default --start-time-delay
RPC_TIMEOUT_S = 10.0  # per-IO bound on every daemon round trip
# The auto-trigger request's profiler_port, the JAX tool's default: a
# shim capture does not read it, and the body stays the JAX tool's.
PROFILER_PORT = 9012


def discover_slurm_hosts(job_id: str) -> list[str]:
    """squeue → nodelist → scontrol hostname expansion (unitrace.py:32-60)."""
    out = subprocess.run(
        ["squeue", "-j", job_id, "--noheader", "-o", "%N"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if not out:
        return []
    expanded = subprocess.run(
        ["scontrol", "show", "hostnames", out],
        capture_output=True, text=True, check=True,
    ).stdout.split()
    return expanded


def discover_gke_hosts(selector: str, namespace: str) -> list[str]:
    """Pod IPs of a GKE workload via kubectl label selector — the cluster
    scheduler next to SLURM (each pod runs dynologd on the shared --port;
    the podset of a JobSet/LeaderWorkerSet selects with e.g.
    'job-name=train' or 'app=my-trainer')."""
    out = subprocess.run(
        ["kubectl", "get", "pods", "-n", namespace, "-l", selector,
         "-o", "jsonpath={range .items[*]}{.status.podIP}{\"\\n\"}{end}"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def build_trace_config(args: argparse.Namespace, start_ms: int) -> str:
    """The on-demand profiling config handed to the client's profiler —
    the same key=value text the dyno CLI builds (src/cli/dyno.cpp
    buildTraceConfig), byte-identical so shim and libkineto consumers see
    no difference between CLI- and unitrace-triggered captures."""
    lines = [
        f"PROFILE_START_TIME={start_ms}",
        f"ACTIVITIES_LOG_FILE={args.log_file}",
    ]
    if args.iterations > 0:
        lines.append(
            f"PROFILE_START_ITERATION_ROUNDUP={args.iteration_roundup}")
        lines.append(f"ACTIVITIES_ITERATIONS={args.iterations}")
    else:
        lines.append(f"ACTIVITIES_DURATION_MSECS={args.duration_ms}")
    return "\n".join(lines)


def build_gputrace_request(
    args: argparse.Namespace, start_ms: int
) -> dict:
    """setKinetOnDemandRequest body, shaped exactly like `dyno gputrace`
    sends it (src/cli/dyno.cpp runTrace)."""
    return {
        "fn": "setKinetOnDemandRequest",
        "config": build_trace_config(args, start_ms),
        "job_id": args.job_id,
        "process_limit": args.process_limit,
        "pids": [int(tok) for tok in args.pids.split(",") if tok],
    }


def build_autotrigger_request(
    args: argparse.Namespace, label: str
) -> dict:
    """addTraceTrigger body, shaped like `dyno autotrigger add` sends it
    (src/cli/dyno.cpp runAutoTrigger), including the defaults the CLI
    always filled in (profiler_host, keep_last)."""
    below = bool(args.below)
    request = {
        "fn": "addTraceTrigger",
        "metric": args.metric,
        "op": "below" if below else "above",
        "threshold": float(args.below if below else args.above),
        "for_ticks": args.for_ticks,
        "cooldown_s": args.cooldown_s,
        "max_fires": args.max_fires,
        "job_id": args.job_id,
        "duration_ms": args.duration_ms,
        "log_file": args.log_file,
        "process_limit": args.process_limit,
        "capture": "shim",
        "profiler_host": "localhost",
        "profiler_port": PROFILER_PORT,
        "peers": "",
        "sync_delay_ms": args.sync_delay_ms,
        "keep_last": 0,
    }
    if args.peer_sync:
        # Whichever host trips first relays the config (one shared future
        # start time) to every other host's daemon, so all ranks capture
        # the same anomaly window. Peer entries carry an explicit port
        # (the shared --port unless the entry named its own) — the daemon
        # must not fall back to 1778 on non-default deployments; bare
        # IPv6 hosts get bracketed.
        def peer_addr(entry: str) -> str:
            h, p = split_host_port(entry, args.port)
            return f"[{h}]:{p}" if ":" in h else f"{h}:{p}"

        request["peers"] = ",".join(
            peer_addr(h) for h in args.all_hosts if h != label)
    return request


def trigger_host(
    host: str, port: int, args: argparse.Namespace, start_ms: int
) -> tuple[str, bool, str]:
    label = host  # reported as given, so host:port entries stay attributable
    host, port = split_host_port(host, port)
    if args.autotrigger_remove:
        # Pod-wide disarm: rule ids differ per daemon, so removal fans out
        # by metric (every rule watching the series on every host).
        request = {"fn": "removeTraceTrigger", "metric": args.metric}
    elif args.autotrigger:
        # Pod-wide anomaly watch: the same rule armed in every host's
        # daemon; each host fires (and captures) independently when its
        # local series trips.
        request = build_autotrigger_request(args, label)
    else:
        request = build_gputrace_request(args, start_ms)
    # The run-level context is minted on the MAIN thread; contextvars do
    # not cross into pool workers, so the per-host request is stamped
    # explicitly here (one child span-id per host under the shared
    # trace-id).
    run_ctx = getattr(args, "run_ctx", None)
    if run_ctx is not None:
        request.setdefault("trace_ctx", run_ctx.child().header())
    with FramedRpcClient(host, port, timeout_s=RPC_TIMEOUT_S) as client:
        response = client.call(request)
    if response is None:
        return label, False, f"daemon unreachable at {host}:{port}"
    # A daemon-side {"status":"failed",...} must fail the host's row too,
    # so ops scripts can't mistake a refusal for success.
    ok = response.get("status", "ok") != "failed"
    return label, ok, f"response = {json.dumps(response)}"


def fetch_host(
    host: str, port: int, path: str, out_dir: str
) -> tuple[str, bool, str]:
    """Pull one artifact off one host's daemon over the streamed
    fetchTrace verb (CHUNK/END frames on the kept-alive wire — no scp,
    no ssh) into <out_dir>/<host>__<basename>. Atomic per host: a
    truncated stream leaves nothing behind."""
    import os

    hostname, hostport = split_host_port(host, port)
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", host)
    dest = os.path.join(out_dir, f"{safe}__{os.path.basename(path)}")
    try:
        with FramedRpcClient(hostname, hostport,
                             timeout_s=RPC_TIMEOUT_S) as client:
            header = client.fetch_to_file(path, dest)
    except OSError as e:
        return host, False, str(e)
    if header is None:
        return host, False, "stream failed or truncated"
    if header.get("status") != "ok":
        return host, False, header.get("error", str(header))
    return host, True, f"{header.get('streamed_bytes', 0)} bytes -> {dest}"


def split_host_port(host: str, default_port: int) -> tuple[str, int]:
    """"host:port" / "[v6]:port" entries override the shared --port (useful
    for multi-daemon single-host simulation and non-default deployments);
    bare IPv6 addresses stay intact."""
    m = re.match(r"^(?:\[(?P<v6>[^\]]+)\]|(?P<h>[^:]+)):(?P<p>\d+)$", host)
    if m:
        return m.group("v6") or m.group("h"), int(m.group("p"))
    return host, default_port


def query_host(
    client: FramedRpcClient, label: str, metrics: list[str]
) -> tuple[str, dict[str, float] | None]:
    """Latest value per requested series from one host's daemon, over the
    host's persistent connection (every IO timeout-bounded, so a
    blackholed host flags UNREACHABLE instead of hanging the table)."""
    now_ms = int(time.time() * 1000)
    response = client.call({
        "fn": "queryMetrics",
        "stats": False,
        # newest sample of 60s-cadence series
        "start_ts": now_ms - 130_000,
        "end_ts": now_ms,
        "metrics": metrics,
    })
    if response is None or not isinstance(response.get("metrics"), dict):
        return label, None
    out = {}
    for name, series in response["metrics"].items():
        values = (series or {}).get("values") or []
        if values:
            out[name] = values[-1]
    return label, out


def fleet_rows(
    doc: dict, metrics: list[str]
) -> list[tuple[str, dict[str, float] | None]]:
    """print_cluster_table rows from one `fleet` response: per-host last
    values from the relay's rollup; hosts the relay marks `lost` render
    UNREACHABLE (the relay's liveness machine already damps flaps, so
    the table doesn't strobe). Pure so tests pin it without a daemon."""
    table = doc.get("metrics") or {}
    detail = doc.get("hosts_detail") or {}
    rows: list[tuple[str, dict[str, float] | None]] = []
    for host in sorted(set(table) | set(detail)):
        if (detail.get(host) or {}).get("state") == "lost":
            rows.append((host, None))
        else:
            rows.append((host, {
                m: v for m, v in (table.get(host) or {}).items()
                if m in metrics
            }))
    return rows


def print_cluster_table(
    results: list[tuple[str, dict[str, float] | None]], metrics: list[str]
) -> int:
    width = max([len("host")] + [len(h) for h, _ in results])
    cols = [max(len(m), 10) for m in metrics]
    print(" ".join(
        ["host".ljust(width)] + [m.rjust(c) for m, c in zip(metrics, cols)]))
    failures = 0
    for host, values in results:
        if values is None:
            failures += 1
            print(f"{host.ljust(width)} UNREACHABLE")
            continue
        cells = []
        for m, c in zip(metrics, cols):
            v = values.get(m)
            cells.append(("-" if v is None else f"{v:.2f}").rjust(c))
        print(" ".join([host.ljust(width)] + cells))
    return failures


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--slurm-job", help="SLURM job id to discover hosts from")
    source.add_argument(
        "--gke-selector",
        help="kubectl label selector for GKE pods (e.g. job-name=train)")
    source.add_argument("--hosts", help="comma separated host list")
    source.add_argument(
        "--relay",
        help="fleet aggregation relay HOST[:PORT] (a daemon running "
             "--relay): answer --query/--watch from ONE `fleet` RPC "
             "against its rolled-up fleet view instead of a connection "
             "per host")
    parser.add_argument(
        "--namespace", default="default", help="namespace for --gke-selector")
    parser.add_argument("--port", type=int, default=1778)
    parser.add_argument("--job-id", dest="job_id", type=int, default=0)
    parser.add_argument("--pids", default="0")
    parser.add_argument("--duration-ms", dest="duration_ms", type=int, default=500)
    parser.add_argument("--iterations", type=int, default=-1)
    parser.add_argument(
        "--iteration-roundup", dest="iteration_roundup", type=int, default=1)
    parser.add_argument("--process-limit", dest="process_limit", type=int, default=3)
    parser.add_argument(
        "--log-file", dest="log_file", default="",
        help="trace output path (required except with --autotrigger-remove)")
    parser.add_argument(
        "--start-time-delay", type=int, default=DEFAULT_START_DELAY_S,
        help="seconds in the future for the synchronized start (duration mode)")
    parser.add_argument(
        "--parallel", type=int, default=16,
        help="concurrent host triggers (the reference loops serially)")
    parser.add_argument(
        "--autotrigger", action="store_true",
        help="install an anomaly auto-trigger rule on every host instead "
             "of firing a one-shot trace (needs --metric and "
             "--above/--below; hosts then capture independently). "
             "Re-running adds another rule — disarm the old one first "
             "with --autotrigger-remove")
    parser.add_argument(
        "--autotrigger-remove", action="store_true",
        help="remove every rule watching --metric from every host's daemon")
    parser.add_argument(
        "--query", dest="query_metrics", default="",
        help="comma-separated series: print a host x metric table of the "
             "latest values across the pod instead of firing a trace "
             "(e.g. --query tpu0.hbm_used_bytes,job42.steps_per_sec)")
    parser.add_argument(
        "--watch-interval-s", dest="watch_interval_s", type=float, default=0,
        help="with --query: repoll the cluster table every N seconds over "
             "the same kept-alive per-host connections (0 = print once); "
             "Ctrl-C exits")
    parser.add_argument(
        "--fetch", default="",
        help="pull this artifact path off every host's daemon over the "
             "streamed fetchTrace verb (CHUNK/END frames on the RPC "
             "connection — no scp/ssh) into --fetch-dir; needs every "
             "daemon started with --trace_output_root")
    parser.add_argument(
        "--fetch-dir", dest="fetch_dir", default=".",
        help="with --fetch: destination directory; files land as "
             "<host>__<basename> (default: current directory)")
    parser.add_argument("--metric", default="", help="autotrigger: series")
    threshold = parser.add_mutually_exclusive_group()
    threshold.add_argument("--above", default="")
    threshold.add_argument("--below", default="")
    parser.add_argument(
        "--for-ticks", dest="for_ticks", type=int, default=1)
    parser.add_argument(
        "--cooldown-s", dest="cooldown_s", type=int, default=300)
    parser.add_argument("--max-fires", dest="max_fires", type=int, default=0)
    parser.add_argument(
        "--peer-sync", dest="peer_sync", action="store_true",
        help="autotrigger: give every host's rule the other hosts as "
             "peers, so whichever trips first fires a pod-wide "
             "synchronized capture")
    parser.add_argument(
        "--sync-delay-ms", dest="sync_delay_ms", type=int, default=2000,
        help="autotrigger --peer-sync: future-start margin the firing "
             "host quantizes the shared PROFILE_START_TIME to; must "
             "exceed the slowest peer relay (daemon default 2000)")
    args = parser.parse_args()

    modes = sum(
        [args.autotrigger, args.autotrigger_remove,
         bool(args.query_metrics), bool(args.fetch)]
    )
    if modes > 1:
        sys.exit(
            "error: --autotrigger / --autotrigger-remove / --query / "
            "--fetch conflict")
    if args.fetch_dir != parser.get_default("fetch_dir") and not args.fetch:
        sys.exit("error: --fetch-dir needs --fetch")
    if args.autotrigger and (not args.metric or not (args.above or args.below)):
        sys.exit("error: --autotrigger needs --metric and --above/--below")
    if args.autotrigger:
        # Catch a threshold typo locally, before discovery touches the
        # cluster and every host prints the same parse error.
        try:
            float(args.above or args.below)
        except ValueError:
            sys.exit(
                "error: threshold is not a number: "
                f"'{args.above or args.below}'")
    if args.autotrigger_remove and not args.metric:
        sys.exit("error: --autotrigger-remove needs --metric")
    if not (args.autotrigger_remove or args.query_metrics or args.fetch
            ) and not args.log_file:
        sys.exit("error: --log-file is required")
    # No silent flag drops: every rule-shape flag requires the mode that
    # consumes it (defaults read from the parser so they can't drift).
    shape_flags = {
        "above": args.above, "below": args.below,
        "for_ticks": args.for_ticks, "cooldown_s": args.cooldown_s,
        "max_fires": args.max_fires, "peer_sync": args.peer_sync,
        "sync_delay_ms": args.sync_delay_ms,
    }
    non_default = [
        name for name, value in shape_flags.items()
        if value != parser.get_default(name)
    ]
    if not args.autotrigger and (args.metric or non_default):
        if args.autotrigger_remove and not non_default:
            pass  # remove consumes --metric alone
        else:
            offending = ", ".join(
                "--" + name.replace("_", "-")
                for name in (["metric"] if args.metric else []) + non_default
            )
            sys.exit(
                f"error: rule flags ({offending}) need --autotrigger"
                + (" (only --metric works with --autotrigger-remove)"
                   if args.autotrigger_remove else ""))
    if (args.sync_delay_ms != parser.get_default("sync_delay_ms")
            and not args.peer_sync):
        # Same no-silent-drop rule one level down: the margin is only
        # ever sent with a peers list, so without --peer-sync it would
        # quietly never reach any daemon.
        sys.exit("error: --sync-delay-ms needs --peer-sync")
    if args.watch_interval_s and not args.query_metrics:
        sys.exit("error: --watch-interval-s needs --query")
    if args.relay and not args.query_metrics:
        # The relay serves the QUERY surface; captures still need the
        # per-host fan-out (a trigger must reach every daemon).
        sys.exit("error: --relay supports --query/--watch only "
                 "(trigger modes need a host source)")
    if not (args.autotrigger or args.autotrigger_remove or args.query_metrics
            or args.fetch):
        # Catch a pid typo locally, before discovery touches the cluster.
        try:
            [int(tok) for tok in args.pids.split(",") if tok]
        except ValueError:
            sys.exit(f"error: bad pid in --pids: '{args.pids}'")

    if args.relay:
        # Fleet mode: one RPC for the whole fleet — the relay already
        # holds every host's last values (pushed over the durable sink
        # stream), so a 10k-host table costs one round trip, not 10k.
        relay_host, relay_port = split_host_port(args.relay, args.port)
        metrics = [m for m in args.query_metrics.split(",") if m]
        client = FramedRpcClient(
            relay_host, relay_port, timeout_s=RPC_TIMEOUT_S)
        try:
            while True:
                doc = client.call({
                    "fn": "fleet",
                    "metrics": metrics,
                    "detail": True,
                    "top_k": 0,
                })
                if doc is None:
                    sys.exit(f"error: relay unreachable at "
                             f"{relay_host}:{relay_port}")
                if doc.get("status") != "ok":
                    sys.exit("error: " + doc.get("error", "fleet failed"))
                failures = print_cluster_table(
                    fleet_rows(doc, metrics), metrics)
                counts = doc.get("counts") or {}
                print(f"fleet: {counts.get('hosts', 0)} host(s), "
                      f"{counts.get('live', 0)} live, "
                      f"{counts.get('stale', 0)} stale, "
                      f"{counts.get('lost', 0)} lost")
                if not args.watch_interval_s:
                    sys.exit(1 if failures else 0)
                time.sleep(args.watch_interval_s)
                print()
        finally:
            client.close()

    if args.slurm_job:
        hosts = discover_slurm_hosts(args.slurm_job)
    elif args.gke_selector:
        hosts = discover_gke_hosts(args.gke_selector, args.namespace)
    else:
        hosts = [h for h in args.hosts.split(",") if h]
    if not hosts:
        sys.exit("error: no hosts discovered")
    args.all_hosts = hosts  # peer lists for --peer-sync

    if args.query_metrics:
        # Pod dashboard: latest value of each series on every host, over
        # one PERSISTENT connection per host. --watch-interval-s repolls
        # on those same kept-alive sockets: N hosts cost N connects for
        # the whole session, not N subprocesses + N connects per poll
        # (what the dyno-CLI fan-out used to do).
        metrics = [m for m in args.query_metrics.split(",") if m]
        clients = {
            h: FramedRpcClient(*split_host_port(h, args.port),
                               timeout_s=RPC_TIMEOUT_S)
            for h in hosts
        }
        try:
            while True:
                with ThreadPoolExecutor(max_workers=args.parallel) as pool:
                    results = list(pool.map(
                        lambda h: query_host(clients[h], h, metrics), hosts))
                failures = print_cluster_table(results, metrics)
                if not args.watch_interval_s:
                    sys.exit(1 if failures else 0)
                time.sleep(args.watch_interval_s)
                print()
        finally:
            for client in clients.values():
                client.close()

    if args.fetch:
        # Pod artifact collection: stream the same artifact path off
        # every host's daemon concurrently (chunked fetchTrace over the
        # framed wire), each into <fetch-dir>/<host>__<basename>. Atomic
        # per host — a truncated stream leaves nothing behind.
        import os

        os.makedirs(args.fetch_dir, exist_ok=True)
        print(f"fetching {args.fetch} from {len(hosts)} hosts")
        failures = 0
        with ThreadPoolExecutor(max_workers=args.parallel) as pool:
            for host, ok, output in pool.map(
                lambda h: fetch_host(h, args.port, args.fetch,
                                     args.fetch_dir), hosts
            ):
                status = "ok" if ok else "FAILED"
                print(f"[{status}] {host}: {output}")
                if not ok:
                    failures += 1
        sys.exit(1 if failures else 0)

    # One control-plane trace-id for the whole invocation: every host's
    # FramedRpcClient stamps its requests with a child of this context,
    # so `dyno selftrace --trace_id=<id>` on ANY pod host shows its slice
    # of this fan-out (and the shims' capture/convert spans under it).
    run_ctx = obs.TraceContext.mint()
    obs.set_current(run_ctx)
    args.run_ctx = run_ctx  # trigger_host stamps per-host children
    print(f"control-plane trace id: {run_ctx.trace_id:016x}")

    # One shared future timestamp so all ranks' windows align
    # (unitrace.py:144-148). Iteration mode aligns by roundup instead.
    start_ms = 0
    if args.autotrigger_remove:
        print(f"removing auto-trigger rules for {args.metric} on "
              f"{len(hosts)} hosts")
    elif args.autotrigger:
        print(f"installing auto-trigger rule on {len(hosts)} hosts")
    else:
        if args.iterations <= 0:
            start_ms = int((time.time() + args.start_time_delay) * 1000)
            print(
                f"synchronized start: {start_ms} "
                f"({args.start_time_delay}s from now)")
        print(f"triggering trace on {len(hosts)} hosts")

    failures = 0
    with ThreadPoolExecutor(max_workers=args.parallel) as pool:
        for host, ok, output in pool.map(
            lambda h: trigger_host(h, args.port, args, start_ms), hosts
        ):
            status = "ok" if ok else "FAILED"
            print(f"[{status}] {host}")
            if not ok:
                failures += 1
                print(output, file=sys.stderr)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
