"""One process per rank, joined in one process group.

``spawn(fn, nprocs, backend)`` starts `nprocs` processes with the 'spawn'
method, gives each a process group over ``tcp://localhost:<free port>``
(nothing on the machine announces a cluster, so the address, world size
and rank are given explicitly), runs ``fn(rank, nprocs, *args)`` in each
and returns the ranks' results in rank order. With the "nccl" backend rank
r drives card r. `fn` must be importable by name (a module-level function)
and its result picklable: keep tensors off the card in it.
"""

from __future__ import annotations

import queue as queue_mod
import random
import socket
import time
import traceback

# Linux hands out ports from 32768 up (ip_local_port_range's default) to
# every bind to port 0 and every outgoing connection; the rendezvous port
# is drawn below that range.
PORTS = range(20000, 32768)


def free_port() -> int:
    """A port of PORTS that is free now. A port from bind(port 0) lies in
    the ephemeral range, and between its release and the rendezvous' bind
    the kernel may hand it to another socket (NCCL's bootstrap opens many),
    which fails the rendezvous with EADDRINUSE."""
    draw = random.SystemRandom()
    for _ in range(100):
        port = draw.choice(PORTS)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {PORTS}")


def _worker(rank, nprocs, port, backend, fn, args, results):
    import torch
    import torch.distributed as dist

    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=nprocs, rank=rank)
        try:
            results.put((rank, True, fn(rank, nprocs, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, nprocs: int, backend: str = "nccl", args: tuple = (),
          timeout_s: float = 600.0) -> list:
    """Runs fn(rank, nprocs, *args) on `nprocs` ranks; returns the results
    in rank order. Raises RuntimeError with the failing rank's traceback,
    when a rank exits without an answer, or when the ranks have not all
    answered within `timeout_s`; every process is stopped before it
    returns or raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, nprocs, port, backend, fn, args, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < nprocs:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"ranks {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]} without an "
                        "answer") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{nprocs - len(out)} of {nprocs} ranks did not "
                        f"answer within {timeout_s:.0f} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == nprocs else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(nprocs)]
