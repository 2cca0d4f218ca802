"""Closed loop over HTTP: one client sends the next request as soon as the
last one has answered, while the window is open (one user at a time).  The
load generator runs in a process of its own (``perfbench/lib/loadgen.py``).

Traffic parameters (the cell file's ``traffic``): ``texts``, optional
``source_sizes``, ``max_requests`` (more than a window completes),
``check_within`` (the first requests, which every run completes, that the
check's ``check_sample`` answers are drawn from), ``grace_s``."""

from perfbench.lib import serving, traffic


def run(system, wl: dict, seed: int, seconds: float, during=None):
    """Warm, drive the window, return it (``perfbench/lib/window.Window``)."""
    spec = wl["traffic"]
    requests, inputs = traffic.requests_for(system, spec, seed, spec["max_requests"])
    keep = traffic.sample_indices(seed, spec["check_within"], spec["check_sample"])
    plan = {"mode": "closed", "requests": requests, "keep": keep}
    return serving.serve_window(system, wl, seconds, plan, inputs,
                                traffic.sources(spec, seed), during)
