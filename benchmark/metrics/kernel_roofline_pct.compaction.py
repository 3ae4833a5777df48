"""K1-K5's share of their roofline: the least time their launches need
(the benchmark's frozen cost copy, each launch at the rows the program's
launch counter gives, against the card's published peaks) over the
device time of their functions in the traced window's profiler events.
Kernels with no launch or no event in the window are left out."""
from harness import costs


def read(ctx):
    if not ctx.get("trace"):
        return None
    dev: dict[str, float] = {}
    for event, seconds in ctx["trace"]["ops"].items():
        kernel = costs.kernel_of(event)
        if kernel is not None:
            dev[kernel] = dev.get(kernel, 0.0) + seconds
    need = spent = 0.0
    for kernel in costs.KERNELS:
        sizes = ctx["launch_sizes"].get(kernel, {})
        if not sizes or dev.get(kernel, 0.0) <= 0:
            continue
        for rows, count in sizes.items():
            need += count * costs.least_seconds(kernel, rows,
                                                ctx["lanes"])[0]
        spent += dev[kernel]
    return None if spent <= 0 else 100.0 * need / spent
