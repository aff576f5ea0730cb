"""The port's kernels' share of their roofline over the traced stretch:
the summed least times of every launch the reference counts for the traced
frames (``roofline.bound_s`` of its bytes and operations) over the summed
device time of every kernel of the port in the trace. The basis is the
reference's whole launch list, so a change that fuses, splits or renames
the port's kernels moves the reading and not its basis. Each kernel that
the trace and the reference count differently is named in the result's
``notes``."""

from collections import Counter

from portbench import roofline


def read(run):
    if run.trace is None or not run.launches:
        return None
    times = run.trace.kernel_seconds()[0]
    spent = sum(sum(t) for t in times.values())
    if spent <= 0:
        return None
    least = sum(roofline.bound_s(launch["bytes"], launch["ops"]) for launch in run.launches)
    counted = Counter(launch["kernel"] for launch in run.launches)
    for name in sorted(set(counted) | set(times)):
        traced = len(times.get(name, []))
        if traced != counted[name]:
            run.notes.append(f"kernel_roofline_pct: {name} traced {traced} launches, "
                             f"the reference counts {counted[name]}")
    return 100.0 * least / spent
