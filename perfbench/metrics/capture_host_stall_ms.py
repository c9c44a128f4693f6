"""capture_host_stall_ms: the host time a capture cost the job's training
thread. Each capture whose manifest lists its spans is taken from its
shim.park's start to its shim.finish's end. The loop's dispatch intervals
(from one step's mark to the next, in the window) that overlap such a span
are summed, less as many of the median interval of those that overlap no
capture (from its request to its manifest, spans or not); over the
captures. An interval that holds a loss read is the card's time, not the
host's, and is left out: a hold or stall that falls in one is not
counted."""

import statistics

from perfbench import spans


def _span_us(named):
    park, finish = named["shim.park"][0], named["shim.finish"][0]
    return float(park["ts"]), float(finish["ts"]) + float(finish["dur"])


def read(run):
    caps = [n for n in spans.of_captures(run, "shim.park")
            if "shim.finish" in n]
    if not caps:
        return None
    measured = [_span_us(n) for n in caps]
    busy = measured + [(c["fired"]["fired"] * 1e6,
                        c["manifest"]["ended_ms"] * 1e3)
                       for c in run.captures if c["manifest"]]
    marks = [m / 1e3 for m in run.marks[:run.steps]]
    every = run.traffic["loss_every"]
    over, clean = [], []
    for i, (a, b) in enumerate(zip(marks, marks[1:])):
        if (i + 1) % every == 0:  # the loss read after step i
            continue
        if any(x < b and y > a for x, y in measured):
            over.append(b - a)
        elif not any(x < b and y > a for x, y in busy):
            clean.append(b - a)
    if not clean:
        return None
    extra = sum(over) - len(over) * statistics.median(clean)
    return extra / len(caps) / 1e3
