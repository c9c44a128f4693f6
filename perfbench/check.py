"""The comparison that decides `correct`.

Training: the program's first steps against the plain reference on the
same weights and tokens. Three numbers, each with its limit from the
configuration's file:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_norm_gap``: over the leaves, the largest gap between the norms of
  the first gradient (the program's read from its optimizer's first moment
  after one step), against the reference leaf's norm or the median leaf's,
  whichever is larger;
- ``change_norm_gap``: the same for the norm of each leaf's change after
  the checked steps, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's.

Captures: each capture asked for in the window has its manifest, ``ok``,
its trace holds a device record for every launch made before its stop
(recounted, and equal to the manifest's ``lost_launches``), and its
ProfilerStep spans are the step() calls the training loop made while its
window was open, none missing and none added."""

from __future__ import annotations

import statistics

from perfbench import traces

# A step() call's mark in the shim follows the benchmark's own stamp within
# this (the call takes microseconds unless it parks for a start or stop).
MARK_SLACK_NS = 50_000_000
# Calls this close to a window's open or close may fall either side.
EDGE_NS = 5_000_000
GRAD_FLOOR = 1e-3  # leaves with a smaller first gradient than this share
# of the median leaf's do not count for the change


def _gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale


def training_numbers(prog: dict, ref: dict) -> dict:
    """The three numbers (see the module's docstring), each with the leaf
    or step that set it."""
    loss = max((_gap(p, r, abs(r)), i) for i, (p, r) in enumerate(
        zip(prog["losses"], ref["losses"])))
    med_g = statistics.median(ref["grad_norms"].values())
    grad = max((_gap(prog["grad_norms"][k], g, max(g, med_g)), k)
               for k, g in ref["grad_norms"].items())
    keep = [k for k, g in ref["grad_norms"].items() if g >= GRAD_FLOOR * med_g]
    med_c = statistics.median(ref["change_norms"][k] for k in keep)
    change = max((_gap(prog["change_norms"][k], ref["change_norms"][k],
                       max(ref["change_norms"][k], med_c)), k) for k in keep)
    return {"loss_gap": loss[0], "grad_norm_gap": grad[0],
            "change_norm_gap": change[0],
            "worst": {"loss_step": loss[1] + 1, "grad_leaf": grad[1],
                      "change_leaf": change[1]},
            "left_out": sorted(set(ref["grad_norms"]) - set(keep))}


def capture_problems(manifest: dict | None, events: list | None,
                     base_ns: int, marks_ns: list,
                     on_card: bool = True) -> list[str]:
    """Why a capture is wrong (empty where it is right): `manifest` is
    None where none landed; `events` and `base_ns` are its trace's;
    `marks_ns` the epoch ns of every step() call the loop made. Off the
    card (`on_card` false, the tests) a trace holds no device record."""
    if manifest is None:
        return ["no manifest"]
    if manifest.get("status") != "ok":
        return [f"status {manifest.get('status')}: {manifest.get('error')}"]
    if events is None:
        return ["no trace"]
    timing = manifest.get("timing", {})
    opened = manifest["started_ms"] * 10**6
    closed = (manifest["started_ms"] + timing.get("window_ms", 0)) * 10**6
    out = []
    lost = traces.unmatched_launches(events, base_ns, closed)
    if lost or timing.get("lost_launches") != lost:
        out.append(f"{lost} launches without a kernel record (manifest "
                   f"says {timing.get('lost_launches')})")
    if on_card and not traces.device_records(events):
        out.append("no device record")
    spans = traces.step_starts_ns(events, base_ns)
    unmatched = [s for s in spans
                 if not any(m <= s <= m + MARK_SLACK_NS for m in marks_ns)]
    missing = [m for m in marks_ns if opened + EDGE_NS < m < closed - EDGE_NS
               and not any(m <= s <= m + MARK_SLACK_NS for s in spans)]
    if unmatched or missing:
        out.append(f"steps: {len(spans)} spans, {len(unmatched)} match no "
                   f"step() call, {len(missing)} calls in the window have "
                   "no span")
    return out
