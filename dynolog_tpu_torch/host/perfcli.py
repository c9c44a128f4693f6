"""perf-CLI fallback sampler (the port's copy of
``dynolog_tpu/host/perfcli.py``: the same parser, record command and JSON
output).

The daemon's first-choice host-PMU path is perf_event_open (src/perf/).
Some hosts lock that down for the daemon's uid (perf_event_paranoid,
seccomp, containers without CAP_PERFMON) while still allowing the perf(1)
CLI via sudo rules or setuid wrappers. The reference keeps a fallback
pipeline for exactly this situation: drive `perf record`, then parse
`perf script` text (hbt/src/intel_pt/tracer.py:33-68 — the only
non-Intel-PT-specific leg of that module). This is the
rebuild: generic software/hardware events, bounded capture, structured
samples.

CLI::

    python -m dynolog_tpu_torch.host.perfcli --duration 2 --events task-clock \
        [--pid PID] [--freq 99] [--json]

Output is one JSON object: sample counts per event and per comm, plus the
raw sample list when --json is given.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from dataclasses import dataclass


@dataclass
class PerfSample:
    comm: str
    pid: int
    tid: int
    cpu: int
    time_s: float
    period: int
    event: str


# `perf script -F comm,pid,tid,cpu,time,period,event` line, e.g.
#   "python 12345/12346 [003] 1710.123456:     250000 task-clock: ..."
_SCRIPT_RE = re.compile(
    r"^\s*(?P<comm>.+?)\s+(?P<pid>\d+)/(?P<tid>\d+)\s+\[(?P<cpu>\d+)\]\s+"
    r"(?P<time>[\d.]+):\s+(?P<period>\d+)\s+(?P<event>[\w\-:/]+?):"
)


def parse_script_line(line: str) -> PerfSample | None:
    """One `perf script` sample line → PerfSample; None for non-sample
    lines (comments, lost-event notices, blank lines)."""
    m = _SCRIPT_RE.match(line)
    if not m:
        return None
    return PerfSample(
        comm=m.group("comm").strip(),
        pid=int(m.group("pid")),
        tid=int(m.group("tid")),
        cpu=int(m.group("cpu")),
        time_s=float(m.group("time")),
        period=int(m.group("period")),
        event=m.group("event"),
    )


class PerfCliSampler:
    """Bounded-duration sampling via the perf(1) CLI."""

    def __init__(
        self,
        events: tuple[str, ...] = ("task-clock",),
        pid: int | None = None,
        cpus: str | None = None,
        freq: int = 99,
        perf_bin: str = "perf",
    ):
        self.events = tuple(events)
        self.pid = pid
        self.cpus = cpus
        self.freq = freq
        self.perf_bin = perf_bin

    def available(self) -> bool:
        return shutil.which(self.perf_bin) is not None

    def record_cmd(self, duration_s: float, output_path: str) -> list[str]:
        cmd = [self.perf_bin, "record", "-F", str(self.freq), "-o", output_path]
        for ev in self.events:
            cmd += ["-e", ev]
        if self.pid is not None:
            cmd += ["-p", str(self.pid)]
        elif self.cpus:
            cmd += ["-C", self.cpus]
        else:
            cmd += ["-a"]
        cmd += ["--", "sleep", str(duration_s)]
        return cmd

    def script_cmd(self, input_path: str) -> list[str]:
        return [
            self.perf_bin,
            "script",
            "-i",
            input_path,
            "-F",
            "comm,pid,tid,cpu,time,period,event",
        ]

    def sample(self, duration_s: float = 1.0) -> list[PerfSample]:
        """record + script + parse. Raises RuntimeError when perf itself
        fails (missing binary, no permission even for the CLI)."""
        if not self.available():
            raise RuntimeError(f"{self.perf_bin} not found on PATH")
        with tempfile.NamedTemporaryFile(suffix=".perf.data") as tmp:
            rec = subprocess.run(
                self.record_cmd(duration_s, tmp.name),
                capture_output=True,
                text=True,
            )
            if rec.returncode != 0:
                raise RuntimeError(f"perf record failed: {rec.stderr.strip()}")
            script = subprocess.run(
                self.script_cmd(tmp.name), capture_output=True, text=True
            )
            if script.returncode != 0:
                raise RuntimeError(f"perf script failed: {script.stderr.strip()}")
        samples = []
        for line in script.stdout.splitlines():
            s = parse_script_line(line)
            if s is not None:
                samples.append(s)
        return samples


def summarize(samples: list[PerfSample]) -> dict:
    by_event: dict[str, int] = {}
    by_comm: dict[str, int] = {}
    for s in samples:
        by_event[s.event] = by_event.get(s.event, 0) + 1
        by_comm[s.comm] = by_comm.get(s.comm, 0) + 1
    return {
        "samples": len(samples),
        "by_event": by_event,
        "by_comm": dict(
            sorted(by_comm.items(), key=lambda kv: -kv[1])[:20]
        ),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--events", default="task-clock", help="comma separated")
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--cpus", default=None, help="perf -C cpu list")
    ap.add_argument("--freq", type=int, default=99)
    ap.add_argument("--json", action="store_true", help="include raw samples")
    args = ap.parse_args(argv)

    sampler = PerfCliSampler(
        events=tuple(args.events.split(",")),
        pid=args.pid,
        cpus=args.cpus,
        freq=args.freq,
    )
    try:
        samples = sampler.sample(args.duration)
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    out = summarize(samples)
    if args.json:
        out["raw"] = [vars(s) for s in samples]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
