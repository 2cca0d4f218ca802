"""Open loop over HTTP: requests are due on a Poisson schedule at the
cell's fixed rate and are sent when due, whether or not earlier ones have
answered (independent users).  The load generator runs in a process of its
own (``perfbench/lib/loadgen.py``).

Traffic parameters (the cell file's ``traffic``): ``rate_rps``,
``base_seed`` (the cell's set of gaps), ``texts``, optional
``source_sizes``, ``check_sample`` (answers drawn from every request due),
``grace_s``."""

from perfbench.lib import serving, traffic


def run(system, wl: dict, seed: int, seconds: float, during=None):
    """Warm, drive the window, return it (``perfbench/lib/window.Window``)."""
    spec = wl["traffic"]
    offsets = traffic.poisson_offsets(spec["rate_rps"], seconds, spec["base_seed"], seed)
    requests, inputs = traffic.requests_for(system, spec, seed, len(offsets))
    for r, off in zip(requests, offsets):
        r["offset"] = off
    keep = traffic.sample_indices(seed, len(requests), spec["check_sample"])
    plan = {"mode": "open", "requests": requests, "keep": keep}
    return serving.serve_window(system, wl, seconds, plan, inputs,
                                traffic.sources(spec, seed), during)
